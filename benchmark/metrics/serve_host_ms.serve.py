"""Host ms per request inside ``recommend`` (the ids' upload, the row
gather, the score and select launches), from the program's ``recommend``
span (``sml_tpu_torch.utils.profiling.summary()``, the window's); None
where the program has no such span."""

import sys


def read(ctx):
    prof = sys.modules.get("sml_tpu_torch.utils.profiling")
    spans = prof.summary() if hasattr(prof, "summary") else {}
    s = spans.get("recommend")
    if s is None or not ctx["requests"]:
        return None
    return s["total_s"] / ctx["requests"] * 1e3
