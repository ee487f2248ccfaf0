"""Times of P2's scorer on the card, as the eval-design probe calls it.

    python -m sml_tpu_torch.scripts.scorer_timing [--rows 16384] [--out f.json]

The scorer is ``make_cuda_scorer`` of :mod:`sml_tpu_torch.scripts.eval_variants`
on the probe's bf16 tables and rows (``probe_inputs``: 100,000 users, 20,000
items, 1,000 negatives and the target per row), called once per 1024-row
batch in three cases:

  probe    int64 ``r[:, 0]`` and ``r[:, 1:]``, strided views of the rows, as
           ``make_eval_with_scorer`` passes them
  int32    the same ids as contiguous int32 tensors
  one_row  every candidate id 0, so every table row read after the first
           hits L1: the call without the gather's L2 traffic

For each case: ms per batch by CUDA events over eager calls (the host's
launch cost included) and by CUDA-graph replay (the device alone), and the
device kernels one call launches, by ``torch.profiler``, with their mean
device times. From the graph times comes the rate at which the candidates'
table rows arrive from L2: ``B*C*128 B / (int32 - one_row)``. The JSON
document goes to stdout and to ``--out``. It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json

import torch

from sml_tpu_torch.device import resolve_device
from sml_tpu_torch.scripts.eval_variants import (BATCH, DIM, make_cuda_scorer,
                                                 prep_bf16, probe_inputs)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` over ``iters`` replays of one CUDA graph
    of it: the kernels back to back, without the host's launch gaps (which
    eager timing includes where a launch costs the host more than the
    device)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):        # warm-up, off the capture
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = cuda_ms(graph.replay, iters)
    del graph
    return ms


def device_kernels(fn, calls: int) -> dict:
    """The device kernels (and copies) that ``calls`` calls of ``fn``
    launch, by ``torch.profiler``: name -> ``[count per call, mean us]``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sml_tpu_torch.utils.profiling import cupti_teardown
    cupti_teardown()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    seen = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = seen.get(e.name, (0, 0.0))
            seen[e.name] = (n + 1, us + e.time_range.elapsed_us())
    return {name: [n / calls, us / n] for name, (n, us) in seen.items()}


def scorer_cases(ctx, rows: torch.Tensor, n_items: int) -> dict:
    """Per case, the scorer's calls over the 1024-row batches of ``rows``,
    each a list of zero-argument functions."""
    scorer = make_cuda_scorer(n_items)
    batches = [rows[s:s + BATCH] for s in range(0, rows.shape[0], BATCH)]
    int32 = [(r[:, 0].to(torch.int32), r[:, 1:].to(torch.int32).contiguous())
             for r in batches]
    zero = torch.zeros_like(int32[0][1])
    return {
        "probe": [lambda r=r: scorer(ctx, r[:, 0], r[:, 1:])
                  for r in batches],
        "int32": [lambda u=u, c=c: scorer(ctx, u, c) for u, c in int32],
        "one_row": [lambda u=u: scorer(ctx, u, zero) for u, _ in int32],
    }


def measure(ctx, rows: torch.Tensor, n_items: int, eager_iters: int = 10,
            graph_iters: int = 20) -> dict:
    """Each case of :func:`scorer_cases`: eager and graph ms per batch, and
    the device kernels per call; the L2 gather rate."""
    res = {}
    for name, calls in scorer_cases(ctx, rows, n_items).items():
        def run(calls=calls):
            for call in calls:
                call()
        n = len(calls)
        res[name] = {"ms": cuda_ms(run, eager_iters) / n,
                     "graph_ms": graph_ms(run, graph_iters) / n,
                     "kernels": device_kernels(calls[0], n)}
    n_cand = rows.shape[1] - 1
    res["l2_gather_bytes"] = BATCH * n_cand * DIM * 2
    res["l2_gather_tb_s"] = res["l2_gather_bytes"] / (
        res["int32"]["graph_ms"] - res["one_row"]["graph_ms"]) * 1e-9
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=16 * BATCH)
    ap.add_argument("--users", type=int, default=100_000)
    ap.add_argument("--items", type=int, default=20_000)
    ap.add_argument("--cands", type=int, default=1000)
    ap.add_argument("--out", default=None,
                    help="also write the JSON document here")
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    mfp, rows = probe_inputs(args.rows, args.users, args.items, args.cands,
                             device)
    res = {"device": torch.cuda.get_device_name(device), "rows": args.rows,
           "batch": BATCH, "cands": rows.shape[1] - 1, "items": args.items,
           **measure(prep_bf16(mfp), rows, args.items)}
    print(json.dumps(res, indent=1))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)
    return res


if __name__ == "__main__":
    main()
