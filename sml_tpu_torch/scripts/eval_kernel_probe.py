"""Masked-rank kernel variants (P1), timed side by side (counterpart of
``scripts/eval_kernel_probe.py``).

    python -m sml_tpu_torch.scripts.eval_kernel_probe [--device cuda]
        [--items 20480] [--rows 16384] [--out probe.json]

The JAX probe ran the masked-rank kernel's function (K2) under layout
variants; here each variant is an instantiation of the same CUDA kernel
(``csrc/eval_kernel.cu``):

  v0       rblk 256 -> 64 rows per block, row tiles on blockIdx.x ("ij")
  v0p      v0 with dimension_semantics, which has no counterpart on the card
           (blocks run in any order): the same instantiation as v0
  v1/v1p   rblk 512 -> 128 rows per block
  v2p      item blocks on blockIdx.x ("ji")
  *_bf16   bf16 inputs on the tensor cores, f32 sums (f32 inputs go
           through the CUDA cores, no TF32)

Each variant is held exactly to v0's rank counts on integer-valued tables
(|x| <= 1, so every score is an exact integer in f32 and bf16) before it is
timed with CUDA events. The JSON document goes to stdout and to ``--out``;
a variant that raises is recorded as ``{"error": ...}``, and the exit
status is then 1.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from sml_tpu_torch.device import resolve_device
from sml_tpu_torch.ops.eval_kernel import (build_packed_mask,
                                           masked_rank_variant, pad_items)
from sml_tpu_torch.scripts.eval_variants import timed_ms

# the probe's rows per TPU block -> rows per CUDA block
ROWS_PER_BLOCK = {256: 64, 512: 128}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_variant(rblk, order, semantics, in_dtype):
    """``run(ue, items_t, sstar, maskp) -> (B,) int32`` for one variant;
    ``semantics`` is accepted and has no effect on the card."""

    def run(ue, items_t, sstar, maskp):
        if in_dtype == "bf16":
            ue = ue.to(torch.bfloat16)
            items_t = items_t.to(torch.bfloat16)
        return masked_rank_variant(ue, items_t, sstar, maskp,
                                   rows_per_block=ROWS_PER_BLOCK[rblk],
                                   order=order)

    return run


VARIANTS = {
    "v0": dict(rblk=256, order="ij", semantics=None, in_dtype="f32"),
    "v0p": dict(rblk=256, order="ij", semantics=("parallel", "arbitrary"),
                in_dtype="f32"),
    "v1": dict(rblk=512, order="ij", semantics=None, in_dtype="f32"),
    "v1p": dict(rblk=512, order="ij", semantics=("parallel", "arbitrary"),
                in_dtype="f32"),
    "v2p": dict(rblk=256, order="ji", semantics=("arbitrary", "parallel"),
                in_dtype="f32"),
    "v0p_bf16": dict(rblk=256, order="ij",
                     semantics=("parallel", "arbitrary"), in_dtype="bf16"),
    "v1p_bf16": dict(rblk=512, order="ij",
                     semantics=("parallel", "arbitrary"), in_dtype="bf16"),
    "v1_bf16": dict(rblk=512, order="ij", semantics=None, in_dtype="bf16"),
}


def probe_inputs(rows: int, items: int, latent: int, neg: int,
                 device: torch.device):
    """Integer-valued tables (|x| <= 1: products in {-1, 0, 1}, dots exact
    in f32 and bf16), negatives, the target score and the packed mask,
    from numpy seeded 7 as in the JAX probe."""
    ipad = pad_items(items)
    rng = np.random.default_rng(7)
    ue = rng.integers(-1, 2, (rows, latent)).astype(np.float32)
    it = rng.integers(-1, 2, (ipad, latent)).astype(np.float32)
    neg_ids = rng.integers(0, items, (rows, neg)).astype(np.int64)
    pos = rng.integers(0, items, (rows,)).astype(np.int64)
    sstar = np.sum(ue * it[pos], axis=1, dtype=np.float32).reshape(rows, 1)
    maskp = build_packed_mask(torch.from_numpy(neg_ids).to(device), items)
    return (torch.from_numpy(ue).to(device),
            torch.from_numpy(it.T.copy()).to(device),
            torch.from_numpy(sstar).to(device), maskp)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--rows", type=int, default=16384)
    ap.add_argument("--items", type=int, default=20480)
    ap.add_argument("--latent", type=int, default=64)
    ap.add_argument("--neg", type=int, default=999)
    ap.add_argument("--trials", type=int, default=12)
    ap.add_argument("--out", default=None,
                    help="also write the JSON document here")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    B, I, d = args.rows, args.items, args.latent
    ipad = pad_items(I)
    ue, items_t, sstar, maskp = probe_inputs(B, I, d, args.neg, device)
    log(f"setup: B={B} I={I} (pad {ipad}) d={d} device={device}")

    results = {"rows": B, "items": I, "latent": d,
               "backend": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu"),
               "variants": {}}
    ref_counts = None
    for name, spec in VARIANTS.items():
        run = make_variant(**spec)
        try:
            first_ms, counts = timed_ms(
                lambda: run(ue, items_t, sstar, maskp), device)
            counts = counts.cpu().numpy()
        except Exception as e:
            log(f"{name}: FAILED {type(e).__name__}: {e}")
            results["variants"][name] = {"error": repr(e)[:400]}
            continue
        if ref_counts is None:
            ref_counts = counts
        exact = bool((counts == ref_counts).all())
        times = [timed_ms(lambda: run(ue, items_t, sstar, maskp), device)[0]
                 for _ in range(args.trials)]
        best = min(times)
        flops = 2.0 * B * ipad * d
        results["variants"][name] = {
            "exact_vs_v0": exact, "compile_s": first_ms / 1e3,
            "best_ms": best, "median_ms": float(np.median(times)),
            "rows_per_s_best": B / best * 1e3,
            "tflops_best": flops / best / 1e9,
        }
        log(f"{name}: best {best:.3f} ms ({B / best * 1e3:,.0f} rows/s, "
            f"{flops / best / 1e9:.2f} TFLOP/s) exact={exact}")
    print(json.dumps(results, indent=2))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=2)
        log(f"wrote {args.out}")
    return results


def exit_status(results: dict) -> int:
    """The probe's exit status: 1 when any variant recorded an error."""
    return int(any("error" in v for v in results["variants"].values()))


if __name__ == "__main__":
    sys.exit(exit_status(main()))
