"""Share of the traced window in which no operation ran on the device:
1 - the union of the device operations' intervals over the window."""


def read(ctx):
    t = ctx["trace"]
    if t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return (1 - t["busy_s"] / t["window_s"]) * 100
