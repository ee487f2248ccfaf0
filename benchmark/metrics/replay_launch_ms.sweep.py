"""Host ms per CUDA-graph replay call of the phase programs, from the
program's ``graph_launch`` span around ``CapturedCall.replay`` (the
generator hand-over and ``cudaGraphLaunch``;
``sml_tpu_torch.utils.profiling.summary()``, the window's). None where
nothing was replayed (the CPU runs the programs eagerly) or the program
has no such span."""

import sys


def read(ctx):
    prof = sys.modules.get("sml_tpu_torch.utils.profiling")
    spans = prof.summary() if hasattr(prof, "summary") else {}
    s = spans.get("graph_launch")
    if s is None or not s["count"]:
        return None
    return s["total_s"] / s["count"] * 1e3
