"""Device ms per period of the work launched inside the engine's
``period_step`` (the captured phase programs' replays), from the trace:
the union of the device operations whose runtime calls (a graph's
launch) were made inside the benchmark's span around the call."""


def read(ctx):
    s = ctx["trace"]["span_device_s"].get("bench.period_step")
    return None if s is None or not ctx["periods"] else s / ctx["periods"] * 1e3
