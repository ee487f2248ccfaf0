"""Host ms per period preparing the period's pools (``prep_inner`` and
``prep_outer``: the content hash of a shared upload, padding and upload,
the sampling index), from the program's spans
(``sml_tpu_torch.utils.profiling.summary()``, the window's); None where
the program has no such span."""

import sys

NAMES = ("prep_inner", "prep_outer")


def read(ctx):
    prof = sys.modules.get("sml_tpu_torch.utils.profiling")
    spans = prof.summary() if hasattr(prof, "summary") else {}
    parts = [spans[n]["total_s"] for n in NAMES if n in spans]
    if not parts or not ctx["periods"]:
        return None
    return sum(parts) / ctx["periods"] * 1e3
