"""GiB the window's peak allocation reached
(``torch.cuda.max_memory_allocated`` after a reset at the window's
start)."""


def read(ctx):
    b = ctx["peak_window_bytes"]
    return b / 2 ** 30 if b else None
