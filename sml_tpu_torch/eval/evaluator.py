"""Batched leave-one-out evaluation (counterpart of
``sml_tpu/eval/evaluator.py``).

Scores every ``[user, pos, negs...]`` row, ranks the positive by a
strictly-greater count and accumulates hit/NDCG sums for all requested K
in one pass. Scoring modes (``scoring=``), same names and semantics as the
JAX package:

``gather``       gather the C+1 candidate rows per example and dot them
                 (the reference semantics).
``matmul``       score all items, ``(B,d)@(d,I)``, then pick the candidate
                 columns; scores can differ from ``gather`` by f32 rounding.
``gather_bf16``/
``matmul_bf16``  the same with bf16 tables and f32 accumulation.
``masked``/
``masked_bf16``  rank against a packed negative-membership mask with
                 kernel K2 (``ops/eval_kernel.py``); without a mask they
                 fall back to ``matmul``/``matmul_bf16``, as in JAX.
``auto``         ``masked`` when the eval set carries a mask, else
                 ``gather``.

Every place that uploads eval rows first calls :func:`check_eval_ids`: a
user id outside ``[0, n_users)`` or a candidate id outside ``[0,
n_items)`` raises a ``ValueError`` on the host, whatever the scoring mode
and device (the JAX package clamps or drops such ids; a rank on such a
row means nothing, and on the card the indexing would be a device-side
assert that ends the process).

Batches run as a Python loop; on the card each masked batch is one K2
launch. Sums accumulate in f32 in batch order, as the JAX scan does.
:func:`make_attributed_eval_fn` adds hit attribution by entity freshness
(new users, new items) on the same ranks.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sml_tpu_torch.models.mf import MFParams
from sml_tpu_torch.ops import eval_kernel
from sml_tpu_torch.ops.metrics import hits_and_ndcg_at, rank_of_target

SCORING_MODES = ("gather", "matmul", "gather_bf16", "matmul_bf16",
                 "masked", "masked_bf16", "auto")


def check_eval_ids(rows: np.ndarray, n_users: int, n_items: int) -> None:
    """Raise ``ValueError`` naming the first eval row whose user id (column
    0) lies outside ``[0, n_users)`` or whose candidate ids (columns 1:,
    the target and its negatives) lie outside ``[0, n_items)``. One pass
    over each block: the ids are read as unsigned integers of their width,
    so a negative id is larger than any bound and the max alone is the
    min-and-max test."""
    rows = np.asarray(rows)
    if rows.size == 0:
        return
    as_unsigned = np.dtype(f"u{rows.dtype.itemsize}")
    users, cands = rows[:, 0], rows[:, 1:]
    if (users.view(as_unsigned).max() < n_users
            and cands.view(as_unsigned).max() < n_items):
        return
    bad_user = (users < 0) | (users >= n_users)
    bad_cand = (cands < 0) | (cands >= n_items)
    r = int(np.flatnonzero(bad_user | bad_cand.any(axis=1))[0])
    if bad_user[r]:
        what, c, bound = "user", 0, n_users
    else:
        what, c, bound = ("candidate", 1 + int(np.argmax(bad_cand[r])),
                          n_items)
    raise ValueError(f"eval row {r}: {what} id {int(rows[r, c])} (column "
                     f"{c}) is outside [0, {bound})")


def _resolve_mode(scoring: str, n_items: int, n_cand: int,
                  has_mask: bool) -> str:
    if scoring == "auto":
        return "masked" if has_mask else "gather"
    if scoring not in SCORING_MODES:
        raise ValueError(f"unknown eval scoring mode: {scoring!r}")
    if scoring.startswith("masked") and not has_mask:
        return "matmul_bf16" if scoring.endswith("bf16") else "matmul"
    return scoring


def _make_ranker(scoring: str):
    """``(prep, rank)``: ``prep(mf, user_rows=None) -> ctx`` once per eval
    (casts and the padded item table), ``rank(ctx, rows, cand_mask, sl) ->
    (B,) int32`` per batch (``sl``: the batch's rows of the eval set)."""

    def prep(mfp: MFParams, user_rows=None):
        # user_rows: the eval rows' user rows, one per row (a row-sharded
        # user table is read once per evaluation, not per batch)
        ue_t = mfp.user_emb if user_rows is None else user_rows
        ie_t = mfp.item_emb
        if scoring.endswith("bf16"):
            ue_t = ue_t.to(torch.bfloat16)
            ie_t = ie_t.to(torch.bfloat16)
        it_pad = None
        if scoring.startswith("masked") or scoring == "auto":
            # (I_pad, d), row-major: the pad rows are never in a mask
            ipad = eval_kernel.pad_items(ie_t.shape[0])
            it_pad = F.pad(ie_t, (0, 0, 0, ipad - ie_t.shape[0]))
        return ue_t, ie_t, it_pad, user_rows is not None

    def rank(ctx, r: torch.Tensor, cand_mask, sl: slice) -> torch.Tensor:
        ue_t, ie_t, it_pad, by_row = ctx
        users, cand = r[:, 0].long(), r[:, 1:].long()
        ue = ue_t[sl] if by_row else ue_t[users]                # (B, d)
        mode = _resolve_mode(scoring, ie_t.shape[0], cand.shape[1],
                             cand_mask is not None)
        if mode.startswith("masked"):
            # target score as an f32 row dot; the mask covers negatives
            # only, so the target never compares with itself
            sstar = (ue.float() * ie_t[r[:, 1].long()].float()).sum(
                dim=1, keepdim=True)
            return eval_kernel.masked_rank(ue, it_pad, sstar, cand_mask)
        if mode.startswith("matmul"):
            all_s = ue.float() @ ie_t.float().T                # (B, I)
            return rank_of_target(torch.gather(all_s, 1, cand))
        ce = ie_t[cand].float()                                # (B, C, d)
        return rank_of_target(torch.einsum("bd,bcd->bc", ue.float(), ce))

    return prep, rank


def make_eval_fn(topks: Sequence[int], batch_size: int,
                 scoring: str = "gather"):
    """Build ``evaluate(mf, rows, mask, cand_mask=None, user_rows=None) ->
    {K: (hit_sum, ndcg_sum)}`` (0-d f32 tensors on the tables' device).

    ``rows``: (n_pad, 2 + C) int32 with n_pad a multiple of ``batch_size``;
    ``mask``: (n_pad,) validity; ``cand_mask``: optional (n_pad, words)
    packed negative mask enabling the masked modes; ``user_rows``: optional
    (n_pad, d) user rows of ``rows`` read in place of ``mf.user_emb``."""
    topks = tuple(topks)
    prep, rank_fn = _make_ranker(scoring)

    def evaluate(mfp: MFParams, rows: torch.Tensor, mask: torch.Tensor,
                 cand_mask: torch.Tensor = None, user_rows=None
                 ) -> Dict[int, Tuple[torch.Tensor, torch.Tensor]]:
        with torch.no_grad():
            ctx = prep(mfp, user_rows)
            zero = torch.zeros((), dtype=torch.float32,
                               device=mfp.user_emb.device)
            acc = {k: (zero, zero) for k in topks}
            for s in range(0, rows.shape[0] - batch_size + 1, batch_size):
                sl = slice(s, s + batch_size)
                cm = None if cand_mask is None else cand_mask[sl]
                res = hits_and_ndcg_at(rank_fn(ctx, rows[sl], cm, sl),
                                       mask[sl], topks)
                acc = {k: (acc[k][0] + res[k][0], acc[k][1] + res[k][1])
                       for k in topks}
            return acc

    return evaluate


def make_attributed_eval_fn(topks: Sequence[int], batch_size: int,
                            scoring: str = "gather"):
    """Evaluation with hit attribution by entity freshness (the reference's
    ``test_hit_new`` / ``test_model_pre``): besides the hit/NDCG sums per
    K, the hits that fall on new users and on new items per K, and the four
    old/new-user x old/new-item buckets at the largest K.

    ``evaluate(mf, rows, mask, is_new_user, is_new_item, cand_mask=None,
    user_rows=None)`` with ``is_new_user`` (U,) and ``is_new_item`` (I,)
    0/1 float tensors;
    returns ``{"base": {K: (hit_sum, ndcg_sum)}, "hit_new_user": {K: sum},
    "hit_new_item": {K: sum}, "buckets_at_max_k": (4,)}`` (f32 tensors on
    the tables' device)."""
    topks = tuple(topks)
    kmax = max(topks)
    prep, rank_fn = _make_ranker(scoring)

    def evaluate(mfp: MFParams, rows: torch.Tensor, mask: torch.Tensor,
                 is_new_user: torch.Tensor, is_new_item: torch.Tensor,
                 cand_mask: torch.Tensor = None, user_rows=None):
        with torch.no_grad():
            ctx = prep(mfp, user_rows)
            dev = mfp.user_emb.device
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            base = {k: (zero, zero) for k in topks}
            new_u = [zero for _ in topks]
            new_i = [zero for _ in topks]
            buckets = torch.zeros(4, dtype=torch.float32, device=dev)
            for s in range(0, rows.shape[0] - batch_size + 1, batch_size):
                sl = slice(s, s + batch_size)
                r, m = rows[sl], mask[sl]
                cm = None if cand_mask is None else cand_mask[sl]
                rank = rank_fn(ctx, r, cm, sl)
                res = hits_and_ndcg_at(rank, m, topks)
                base = {k: (base[k][0] + res[k][0], base[k][1] + res[k][1])
                        for k in topks}
                nu = is_new_user[r[:, 0].long()]
                ni = is_new_item[r[:, 1].long()]
                for n, k in enumerate(topks):
                    hit = (rank < k).to(torch.float32) * m
                    new_u[n] = new_u[n] + torch.sum(hit * nu)
                    new_i[n] = new_i[n] + torch.sum(hit * ni)
                hit_kmax = (rank < kmax).to(torch.float32) * m
                buckets = buckets + torch.stack([
                    torch.sum(hit_kmax * (1 - nu) * (1 - ni)),   # old u, old i
                    torch.sum(hit_kmax * (1 - nu) * ni),         # old u, new i
                    torch.sum(hit_kmax * nu * (1 - ni)),         # new u, old i
                    torch.sum(hit_kmax * nu * ni),               # new u, new i
                ])
            return {"base": base,
                    "hit_new_user": dict(zip(topks, new_u)),
                    "hit_new_item": dict(zip(topks, new_i)),
                    "buckets_at_max_k": buckets}

    return evaluate
