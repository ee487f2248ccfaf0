"""Host ms per period in branch C's eager phase 0 (its inner and outer
epochs, the hat snapshot, the refresh and the test), from the program's
``phase0`` span (``sml_tpu_torch.utils.profiling.summary()``). The
program records while the window's profiler is on; a process runs one
cell, so the table holds that run's window. None where the program has
no such span."""

import sys


def read(ctx):
    prof = sys.modules.get("sml_tpu_torch.utils.profiling")
    spans = prof.summary() if hasattr(prof, "summary") else {}
    s = spans.get("phase0")
    if s is None or not ctx["periods"]:
        return None
    return s["total_s"] / ctx["periods"] * 1e3
