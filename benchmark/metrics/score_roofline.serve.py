"""The scoring GEMM (``eval/full_ranking.py``: ``(n, d) x (d, I)``) as a
share of its least time: n*I*d*2 operations over the f32 peak against
its inputs and its n x I scores over the bandwidth
(``costs.score_flops``, ``costs.score_bytes``), over the device time of
cuBLAS's GEMM and GEMV kernels, by name."""

import harness

KERNELS = ("gemm", "gemv", "xmma", "Kernel2")


def read(ctx):
    t = harness.ops_matching(ctx["trace"], KERNELS)
    return None if t <= 0 else ctx["score_least_s"] / t * 100
