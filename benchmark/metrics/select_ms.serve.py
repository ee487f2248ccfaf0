"""Device ms per request of the top-K selection: ``torch.topk``'s radix
select, gather and sort kernels, by name."""

import harness

KERNELS = ("topk", "TopK", "radix", "Radix", "Kth", "Blockwise", "sort",
           "Sort")


def read(ctx):
    t = harness.ops_matching(ctx["trace"], KERNELS)
    return None if t <= 0 or not ctx["requests"] else t / ctx["requests"] * 1e3
