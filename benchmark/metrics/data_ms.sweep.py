"""Host ms per period in the feeder's ``next_train`` (the driver waits
there for the period's files: loaded by the prefetch worker), from the
benchmark's span around the call."""


def read(ctx):
    s = ctx["host_s"].get("bench.data")
    return None if s is None or not ctx["periods"] else s / ctx["periods"] * 1e3
