"""Full-catalog top-K serving (counterpart of ``sml_tpu/eval/full_ranking.py``).

One ``(B, d) x (d, I)`` f32 score product, an optional additive mask and
an exact ``torch.topk``.
Every ``topk_method`` the JAX package accepts is served exactly here:
``exact``, ``exact_sort`` and ``exact_bucket`` are exact there too, and
``approx``/``approx99`` name the TPU's hardware PartialReduce, which has no
counterpart on the GPU; an exact answer meets their recall targets.

With the item table row-sharded over a mesh's ``model`` axis
(:func:`make_sharded_full_topk`), each rank scores its own rows, takes a
local top-K, all-gathers the ``(B, k)`` (score, global id) pairs and
re-ranks them: ``O(B·k·M)`` values cross between ranks instead of
``O(B·I)``, and the merge is exact because the global top-K lies in the
union of the local ones.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from sml_tpu_torch.models.mf import MFParams
from sml_tpu_torch.parallel import collective

TOPK_METHODS = ("exact", "exact_sort", "exact_bucket", "approx", "approx99")


def _scores(user_emb_rows, item_table, compute_dtype, topk_method):
    if topk_method not in TOPK_METHODS:
        raise ValueError(f"unknown topk_method {topk_method!r}")
    if compute_dtype is not None:
        user_emb_rows = user_emb_rows.to(compute_dtype)
        item_table = item_table.to(compute_dtype)
    return user_emb_rows.float() @ item_table.float().T


def dense_full_topk(user_emb_rows: torch.Tensor, item_table: torch.Tensor,
                    k: int, mask_scores: Optional[torch.Tensor] = None,
                    compute_dtype=None, topk_method: str = "exact"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-K items per user row: returns (scores (B, k) f32, item ids
    (B, k)). ``mask_scores``: an optional (B, I) additive mask added to the
    scores before the top-K (-inf excludes an item: the serving filter of
    a user's already-seen items). ``compute_dtype`` rounds the product's
    inputs (e.g. ``torch.bfloat16``); scores accumulate and rank in f32."""
    with torch.no_grad():
        scores = _scores(user_emb_rows, item_table, compute_dtype,
                         topk_method)
        if mask_scores is not None:
            scores = scores + mask_scores
        return torch.topk(scores, k, dim=1)


def make_sharded_full_topk(mesh, k: int, compute_dtype=None,
                           topk_method: str = "exact"):
    """``topk(user_rows, item_shard) -> (scores, ids)`` with the item table
    row-sharded over ``mesh``'s ``model`` axis: ``item_shard`` is this
    rank's contiguous block (model rank ``m`` of ``M`` holds rows
    ``[m·I/M, (m+1)·I/M)``) and ``user_rows`` are the same on every rank of
    the axis. Local top-K per ``topk_method``, global ids from the block's
    offset, an all-gather of the ``(B, k)`` pairs over ``model`` and an
    exact re-rank; every rank returns the answer."""
    group = mesh.group("model")
    n_model = mesh.shape["model"]

    def topk(user_rows: torch.Tensor, item_shard: torch.Tensor):
        with torch.no_grad():
            rows_per = item_shard.shape[0]
            scores = _scores(user_rows, item_shard, compute_dtype,
                             topk_method)
            if rows_per < k:       # fewer rows than k: pad with -inf
                scores = torch.nn.functional.pad(
                    scores, (0, k - rows_per), value=float("-inf"))
            ls, li = torch.topk(scores, k, dim=1)
            gids = li + collective.group_rank(group) * rows_per
            # (M·B, k) in rank order -> (B, M·k)
            b = ls.shape[0]
            all_s = collective.all_gather(ls, group).view(n_model, b, k)
            all_i = collective.all_gather(gids, group).view(n_model, b, k)
            all_s = all_s.permute(1, 0, 2).reshape(b, n_model * k)
            all_i = all_i.permute(1, 0, 2).reshape(b, n_model * k)
            ms, sel = torch.topk(all_s, k, dim=1)
            return ms, torch.gather(all_i, 1, sel)

    return topk


def recommend(mf: MFParams, users: torch.Tensor, k: int, mesh=None,
              compute_dtype=None, topk_method: str = "exact"):
    """Top-K catalog recommendation for a user batch (serving entry). With
    a ``mesh`` whose ``model`` axis is larger than 1, ``mf.item_emb`` is
    this rank's row block of the item table and the merge runs over the
    axis; ``mf.user_emb`` is the whole user table."""
    rows = mf.user_emb[users.to(mf.user_emb.device).long()]
    if mesh is not None and mesh.shape["model"] > 1:
        return make_sharded_full_topk(mesh, k, compute_dtype,
                                      topk_method)(rows, mf.item_emb)
    return dense_full_topk(rows, mf.item_emb, k, compute_dtype=compute_dtype,
                           topk_method=topk_method)
