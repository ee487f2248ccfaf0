"""Full-catalog top-K serving (counterpart of ``sml_tpu/eval/full_ranking.py``).

One ``(B, d) x (d, I)`` f32 score product and an exact ``torch.topk``.
Every ``topk_method`` the JAX package accepts is served exactly here:
``exact``, ``exact_sort`` and ``exact_bucket`` are exact there too, and
``approx``/``approx99`` name the TPU's hardware PartialReduce, which has no
counterpart on the GPU; an exact answer meets their recall targets. The
row-sharded merge comes with the parallel slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sml_tpu_torch.models.mf import MFParams

TOPK_METHODS = ("exact", "exact_sort", "exact_bucket", "approx", "approx99")


def dense_full_topk(user_emb_rows: torch.Tensor, item_table: torch.Tensor,
                    k: int, compute_dtype=None, topk_method: str = "exact"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-K items per user row: returns (scores (B, k) f32, item ids
    (B, k)). ``compute_dtype`` rounds the product's inputs (e.g.
    ``torch.bfloat16``); scores accumulate and rank in f32."""
    if topk_method not in TOPK_METHODS:
        raise ValueError(f"unknown topk_method {topk_method!r}")
    if compute_dtype is not None:
        user_emb_rows = user_emb_rows.to(compute_dtype)
        item_table = item_table.to(compute_dtype)
    with torch.no_grad():
        scores = user_emb_rows.float() @ item_table.float().T
        return torch.topk(scores, k, dim=1)


def recommend(mf: MFParams, users: torch.Tensor, k: int,
              compute_dtype=None, topk_method: str = "exact"):
    """Top-K catalog recommendation for a user batch (serving entry)."""
    rows = mf.user_emb[users.to(mf.user_emb.device).long()]
    return dense_full_topk(rows, mf.item_emb, k, compute_dtype=compute_dtype,
                           topk_method=topk_method)
