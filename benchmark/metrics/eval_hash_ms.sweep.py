"""Host ms per period in the eval sets' content hash (``eval_set_hash``)
on any thread: the prefetch worker's for the next period's test, and the
training thread's where the inner pool shares the test's upload. From the
program's spans (``sml_tpu_torch.utils.profiling.summary()``, the
window's, the tasks the window queued included); None where the program
has no such span."""

import sys


def read(ctx):
    prof = sys.modules.get("sml_tpu_torch.utils.profiling")
    spans = prof.summary() if hasattr(prof, "summary") else {}
    s = spans.get("eval_set_hash")
    if s is None or not ctx["periods"]:
        return None
    return s["total_s"] / ctx["periods"] * 1e3
