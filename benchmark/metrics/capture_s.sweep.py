"""Seconds set-up spent capturing the phase programs
(``SMLEngine.graph_stats['capture_s']``); nothing where none was
captured."""


def read(ctx):
    return ctx["capture_s"] or None
