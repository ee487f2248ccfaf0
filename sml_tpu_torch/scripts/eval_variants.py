"""Eval-design probe: candidate implementations of the 999-negative
leave-one-out test, timed side by side (counterpart of
``scripts/eval_variants.py``).

    python -m sml_tpu_torch.scripts.eval_variants [--device cuda] [--rows 16384]

Variants (the same names and JSON as the JAX script):

  v0_gather_f32       gather the C+1 candidate rows per example and dot them
  v1_gather_bf16      the same gather from bf16 tables, f32 sums
  v2_matmul_gather    score all items, (B,d)@(d,I), then pick the candidates
  v3_matmul_bf16      v2 with bf16 inputs
  v4_pallas           P2: ``candidate_scores_kernel`` gathers and scores only
                      the candidates (``ops/probe_kernels.py``)
  v5_masked_xla_f32   rank = sum(mask * (s_all > s_target)) over a dense
                      int8 candidate mask, scores by ``torch.matmul``
  v5b_masked_xla_bf16 v5 with bf16 inputs
  v6_masked_pallas    P3: ``dense_mask_rank_kernel`` scores only the mask's
                      set entries

v0-v3, v5 and v5b are plain PyTorch (``torch.matmul``, ``gather``), as the
JAX script left them to XLA. Every variant feeds the same rank and metric
functions and is checked against v0's hit/NDCG sums. Inputs come from numpy
seeded 3. On the card each round times every variant once with CUDA
events, the variants interleaved; the JSON document goes to stdout. A
variant that raises is recorded as ``{"error": ...}`` and the others still
run; the exit status is then 1.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from sml_tpu_torch.device import resolve_device
from sml_tpu_torch.models.mf import MFParams
from sml_tpu_torch.ops.metrics import hits_and_ndcg_at, rank_of_target
from sml_tpu_torch.ops.probe_kernels import candidate_scores, dense_mask_rank

DIM = 64
BATCH = 1024


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def timed_ms(fn, device: torch.device) -> tuple:
    """``(ms, out)`` of one call: CUDA events on the card, the host clock
    on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(stop), out
    t0 = time.perf_counter()
    out = fn()
    return (time.perf_counter() - t0) * 1e3, out


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with f32 results, as the JAX script's
    ``preferred_element_type=f32``: bf16 inputs stay bf16 on the card
    (``out_dtype``); elsewhere they are widened first, which gives the same
    exact products."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


def make_eval_with_scorer(topks, batch_size, scorer, prep=None):
    """The evaluator loop with a pluggable scoring function.

    ``scorer(ctx, users, cand) -> (B, C) scores``; ``prep(mfp) -> ctx`` runs
    once per eval (outside the batch loop), so table casts are not charged
    to the batches."""
    topks = tuple(topks)

    def evaluate(mfp, rows, mask):
        with torch.no_grad():
            ctx = prep(mfp) if prep else mfp
            zero = torch.zeros((), dtype=torch.float32, device=rows.device)
            acc = {k: (zero, zero) for k in topks}
            for s in range(0, rows.shape[0] - batch_size + 1, batch_size):
                r, m = rows[s:s + batch_size], mask[s:s + batch_size]
                scores = scorer(ctx, r[:, 0], r[:, 1:])
                res = hits_and_ndcg_at(rank_of_target(scores), m, topks)
                acc = {k: (acc[k][0] + res[k][0], acc[k][1] + res[k][1])
                       for k in topks}
            return acc

    return evaluate


def scorer_gather_f32(mfp, users, cand):
    return torch.einsum("bd,bcd->bc", mfp.user_emb[users],
                        mfp.item_emb[cand])


def prep_bf16(mfp):
    return (mfp.user_emb.to(torch.bfloat16), mfp.item_emb.to(torch.bfloat16))


def scorer_gather_bf16(ctx, users, cand):
    ue_t, ie_t = ctx
    return torch.einsum("bd,bcd->bc", ue_t[users].float(),
                        ie_t[cand].float())


def prep_matmul(mfp):
    return (mfp.user_emb, mfp.item_emb.T)


def scorer_matmul(ctx, users, cand):
    ue_t, ie_T = ctx
    all_scores = mm_f32(ue_t[users], ie_T)                       # (B, I)
    return torch.gather(all_scores, 1, cand)


def prep_matmul_bf16(mfp):
    return (mfp.user_emb.to(torch.bfloat16),
            mfp.item_emb.to(torch.bfloat16).T)


def make_cuda_scorer(n_items: int):
    """P2 as a scorer: ``ctx`` holds the bf16 tables; each batch's scores,
    the user gather included, come from :func:`candidate_scores` (one
    kernel launch on the card)."""

    def scorer(ctx, users, cand):
        ue_t, ie_t = ctx                                         # bf16
        if ie_t.shape[0] != n_items:
            raise ValueError(f"table has {ie_t.shape[0]} rows, expected "
                             f"{n_items}")
        return candidate_scores(ue_t, users, cand, ie_t)

    return scorer


def build_candidate_mask(rows: torch.Tensor, n_items_pad: int,
                         chunk: int = 512) -> torch.Tensor:
    """(n, 2+C) eval rows -> (n, I_pad) int8 candidate-membership mask.

    Candidates (columns 1:) are distinct within a row, so membership is 0
    or 1 and rank by count equals rank by gather. Built by a scatter on the
    rows' device, ``chunk`` rows at a time to bound the transient."""
    n = rows.shape[0]
    out = torch.zeros((n, n_items_pad), dtype=torch.int8, device=rows.device)
    for s in range(0, n, chunk):
        cand = rows[s:s + chunk, 1:].long()
        out[s:s + chunk].scatter_(1, cand, 1)
    return out


def _masked_eval_loop(topks, batch_size, rank_fn):
    topks = tuple(topks)

    def evaluate(ctx, ue_all, tgt_all, maskm, mask):
        with torch.no_grad():
            zero = torch.zeros((), dtype=torch.float32, device=ue_all.device)
            acc = {k: (zero, zero) for k in topks}
            for s in range(0, ue_all.shape[0] - batch_size + 1, batch_size):
                sl = slice(s, s + batch_size)
                rank = rank_fn(ctx, ue_all[sl], tgt_all[sl], maskm[sl])
                res = hits_and_ndcg_at(rank, mask[sl], topks)
                acc = {k: (acc[k][0] + res[k][0], acc[k][1] + res[k][1])
                       for k in topks}
            return acc

    return evaluate


def make_masked_rank_eval(topks, batch_size, n_items_pad, scores_fn):
    """Evaluator computing rank = sum(mask * (s_all > s_target)), no
    candidate gather at all. ``scores_fn(ctx, ue) -> (B, I_pad)``."""

    def rank_fn(ctx, ue, tgt, mm):
        s_all = scores_fn(ctx, ue)                               # (B, I_pad)
        sstar = torch.gather(s_all, 1, tgt.long()[:, None])
        return ((mm > 0) & (s_all > sstar)).sum(dim=1, dtype=torch.int32)

    return _masked_eval_loop(topks, batch_size, rank_fn)


def make_cuda_masked_eval(topks, batch_size, n_items_pad):
    """P3 as an evaluator: ``evaluate(table_bf16, ue_all, tgt_all, maskm,
    mask)``, each batch's ranks from :func:`dense_mask_rank` (the kernel on
    the card)."""

    def rank_fn(table_bf16, ue, tgt, mm):
        if table_bf16.shape[0] != n_items_pad:
            raise ValueError(f"table has {table_bf16.shape[0]} rows, "
                             f"expected {n_items_pad}")
        return dense_mask_rank(table_bf16, ue, tgt, mm)

    return _masked_eval_loop(topks, batch_size, rank_fn)


def probe_inputs(rows: int, users: int, items: int, cands: int,
                 device: torch.device):
    """Seeded tables (N(0,1), as ``init_mf``) and eval rows with distinct
    candidates: a random-base, random-stride progression mod ``items``,
    drawn first so the ids equal the JAX script's."""
    rng = np.random.default_rng(3)
    max_stride = max(1, (items - 1) // (cands + 1))
    base = rng.integers(0, items, (rows, 1))
    stride = rng.integers(1, max_stride + 1, (rows, 1))
    cand_np = (base + stride * np.arange(cands + 1)) % items
    assert all(len(np.unique(r)) == cands + 1 for r in cand_np[:8])
    user_ids = rng.integers(0, users, (rows, 1))
    tables = [rng.standard_normal(shape, dtype=np.float32)
              for shape in ((users, DIM), (items, DIM), (users, 1),
                            (items, 1))]
    mfp = MFParams(*(torch.from_numpy(t).to(device) for t in tables))
    rows_t = torch.from_numpy(np.concatenate([user_ids, cand_np], axis=1)
                              .astype(np.int64)).to(device)
    return mfp, rows_t


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--rows", type=int, default=16 * BATCH)
    ap.add_argument("--users", type=int, default=100_000)
    ap.add_argument("--items", type=int, default=20_000)
    ap.add_argument("--cands", type=int, default=1000)
    ap.add_argument("--rounds", type=int, default=7)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    log(f"device={device}")

    mfp, rows = probe_inputs(args.rows, args.users, args.items, args.cands,
                             device)
    mask = torch.ones((args.rows,), dtype=torch.float32, device=device)
    item_block = 2048
    n_items_pad = -(-args.items // item_block) * item_block

    # eval-set prep shared by the masked variants: the candidate mask
    # (built once per eval set in production) and the padded table
    mask_build_ms, maskm = timed_ms(
        lambda: build_candidate_mask(rows, n_items_pad), device)
    log(f"candidate-mask build: {mask_build_ms:.1f} ms for {args.rows} rows "
        f"({maskm.numel() / 2**20:.0f} MiB)")

    def pad_table(t):
        return torch.nn.functional.pad(t, (0, 0, 0, n_items_pad - t.shape[0]))

    ev5 = make_masked_rank_eval((5, 10, 20), BATCH, n_items_pad,
                                lambda ieT, ue: mm_f32(ue, ieT))
    ev6 = make_cuda_masked_eval((5, 10, 20), BATCH, n_items_pad)

    def run_masked_xla(mfp, rows, mask, maskm):
        return ev5(pad_table(mfp.item_emb).T, mfp.user_emb[rows[:, 0]],
                   rows[:, 1], maskm, mask)

    def run_masked_xla_bf16(mfp, rows, mask, maskm):
        ieT = pad_table(mfp.item_emb).to(torch.bfloat16).T
        return ev5(ieT, mfp.user_emb[rows[:, 0]].to(torch.bfloat16),
                   rows[:, 1], maskm, mask)

    def run_masked_cuda(mfp, rows, mask, maskm):
        tab = pad_table(mfp.item_emb).to(torch.bfloat16)
        return ev6(tab, mfp.user_emb[rows[:, 0]], rows[:, 1], maskm, mask)

    def classic(scorer, prep):
        ev = make_eval_with_scorer((5, 10, 20), BATCH, scorer, prep)
        return lambda mfp, rows, mask, maskm: ev(mfp, rows, mask)

    variants = {
        "v0_gather_f32": classic(scorer_gather_f32, None),
        "v1_gather_bf16": classic(scorer_gather_bf16, prep_bf16),
        "v2_matmul_gather": classic(scorer_matmul, prep_matmul),
        "v3_matmul_bf16": classic(scorer_matmul, prep_matmul_bf16),
        "v4_pallas": classic(make_cuda_scorer(args.items), prep_bf16),
        "v5_masked_xla_f32": run_masked_xla,
        "v5b_masked_xla_bf16": run_masked_xla_bf16,
        "v6_masked_pallas": run_masked_cuda,
    }

    res = {"device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "rows": args.rows, "items": args.items, "cands": args.cands,
           "mask_build_ms": mask_build_ms}

    # run every variant once (warm-up, and the sums checked against v0),
    # then time them interleaved over the rounds
    accs, ready = {}, {}
    for name, runner in variants.items():
        try:
            acc = runner(mfp, rows, mask, maskm)
            accs[name] = {k: (float(v[0]), float(v[1]))
                          for k, v in acc.items()}
            ready[name] = runner
        except Exception as e:
            res[name] = {"error": f"{type(e).__name__}: {e}"}
            log(f"{name} FAILED: {type(e).__name__}: {e}")

    rounds = {name: [] for name in ready}
    for r in range(args.rounds):
        for name, runner in ready.items():
            ms, _ = timed_ms(lambda: runner(mfp, rows, mask, maskm), device)
            rounds[name].append(ms)
        log(f"round {r}: " + " ".join(f"{n}={rounds[n][-1]:.1f}ms"
                                      for n in ready))

    ref_acc = accs.get("v0_gather_f32")
    for name in ready:
        dt = min(rounds[name])
        acc = accs[name]
        max_hit_delta = max(abs(acc[k][0] - ref_acc[k][0]) for k in acc)
        max_ndcg_delta = max(abs(acc[k][1] - ref_acc[k][1]) for k in acc)
        res[name] = {
            "total_ms": dt,
            "all_rounds_ms": rounds[name],
            "rows_per_s": args.rows / dt * 1e3,
            "speedup_vs_v0": min(rounds["v0_gather_f32"]) / dt,
            "hit_sum@20": acc[20][0],
            "max_hit_delta_vs_v0": max_hit_delta,
            "max_ndcg_delta_vs_v0": max_ndcg_delta,
        }
        log(f"{name}: min {dt:.2f} ms, {args.rows / dt * 1e3:,.0f} rows/s, "
            f"hitΔ={max_hit_delta} ndcgΔ={max_ndcg_delta:.4f}")
    print(json.dumps(res, indent=1))
    return res


def exit_status(res: dict) -> int:
    """The probe's exit status: 1 when any variant recorded an error."""
    return int(any(isinstance(v, dict) and "error" in v
                   for v in res.values()))


if __name__ == "__main__":
    sys.exit(exit_status(main()))
