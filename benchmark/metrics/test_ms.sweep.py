"""Host ms per period in the tests: ``make_eval_set`` (content hash, pad
and upload; mostly on the prefetch worker), ``evaluate_deferred`` and the
tests' resolution (``resolve_evals``), from the benchmark's spans."""

NAMES = ("bench.make_eval_set", "bench.evaluate_deferred",
         "bench.resolve_evals")


def read(ctx):
    parts = [ctx["host_s"][n] for n in NAMES if n in ctx["host_s"]]
    if not parts or not ctx["periods"]:
        return None
    return sum(parts) / ctx["periods"] * 1e3
