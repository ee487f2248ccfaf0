"""Ranking metrics (counterpart of ``sml_tpu/ops/metrics.py``).

Each eval row is ``[user, pos_item, neg_1..neg_C]``; the positive hits at K
iff its rank among the candidates is < K and adds ``1/log2(rank+2)`` NDCG.
The rank is the strictly-greater count ``#{j >= 1 : s_j > s_0}`` (ties go to
the target). Also the multi-target ranklist metrics of the reference's
``evalution/evalution_function.py``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch


def rank_of_target(scores: torch.Tensor) -> torch.Tensor:
    """Rank (0-based) of candidate 0 among all candidates; (B, 1+C) ->
    (B,) int32."""
    pos = scores[:, :1]
    return (scores[:, 1:] > pos).sum(dim=1).to(torch.int32)


def hits_and_ndcg_at(rank: torch.Tensor, mask: torch.Tensor,
                     topks: Sequence[int]
                     ) -> Dict[int, Tuple[torch.Tensor, torch.Tensor]]:
    """Masked hit and NDCG sums (f32) at each K for a batch of ranks."""
    out = {}
    ndcg_all = 1.0 / torch.log2(rank.to(torch.float32) + 2.0)
    for k in topks:
        hit = (rank < k).to(torch.float32) * mask
        out[k] = (hit.sum(), (hit * ndcg_all).sum())
    return out


def weighted_period_average(values, counts, val_fraction: float = 1.0 / 3.0,
                            drop_last_test: bool = True):
    """The reference's end-of-run aggregation: the first
    ``round(T * val_fraction)`` test periods are validation, the rest test,
    each side weighted by per-period eval counts; ``drop_last_test``
    excludes the final test period (the reference's ``[N3:-1]``). Returns
    ``(val_avg, test_avg)``."""
    values = np.asarray(values, dtype=np.float64)
    counts = np.asarray(counts, dtype=np.float64)
    n3 = round(counts.shape[0] * val_fraction)
    val_w = counts[:n3] / max(counts[:n3].sum(), 1.0)
    sl = slice(n3, -1) if drop_last_test else slice(n3, None)
    test_w = counts[sl] / max(counts[sl].sum(), 1.0)
    val_avg = (values[:n3].T * val_w).T.sum(axis=0)
    test_avg = (values[sl].T * test_w).T.sum(axis=0)
    return val_avg, test_avg


# ranklist metrics: ``ranklist`` holds candidate indices sorted by score;
# targets are the indices 0..n_targets-1

def _target_positions(ranklist: torch.Tensor, n_targets: int) -> torch.Tensor:
    return ranklist < n_targets


def hit_count(ranklist: torch.Tensor, n_targets: int) -> torch.Tensor:
    return _target_positions(ranklist, n_targets).sum()


def precision_at(ranklist: torch.Tensor, n_targets: int,
                 topk: int) -> torch.Tensor:
    return hit_count(ranklist, n_targets) / topk


def recall_at(ranklist: torch.Tensor, n_targets: int) -> torch.Tensor:
    return hit_count(ranklist, n_targets) / n_targets


def idcg(n: int) -> torch.Tensor:
    arr = torch.arange(n, dtype=torch.float32) + 2.0
    return (1.0 / torch.log2(arr)).sum()


def ndcg(ranklist: torch.Tensor, n_targets: int) -> torch.Tensor:
    hits = _target_positions(ranklist, n_targets)
    pos = torch.arange(ranklist.shape[0], dtype=torch.float32,
                       device=ranklist.device)
    dcg = torch.where(hits, 1.0 / torch.log2(pos + 2.0),
                      torch.zeros_like(pos)).sum()
    return dcg / idcg(n_targets).to(ranklist.device)


def rec_ndcg(ranklist: torch.Tensor, n_targets: int):
    return recall_at(ranklist, n_targets), ndcg(ranklist, n_targets)


def mrr(ranklist: torch.Tensor, n_targets: int) -> torch.Tensor:
    hits = _target_positions(ranklist, n_targets)
    pos = torch.arange(ranklist.shape[0], dtype=torch.float32,
                       device=ranklist.device)
    first = torch.where(hits, pos, torch.full_like(pos, float("inf"))).min()
    return torch.where(torch.isfinite(first), 1.0 / (first + 1.0),
                       torch.zeros_like(first))


def average_precision(ranklist: torch.Tensor, n_targets: int) -> torch.Tensor:
    """Precision at each hit position, normalized by
    ``min(len(ranklist), n_targets)``."""
    hits = _target_positions(ranklist, n_targets).to(torch.float32)
    pos = torch.arange(ranklist.shape[0], dtype=torch.float32,
                       device=ranklist.device) + 1.0
    precs = torch.where(hits > 0, torch.cumsum(hits, 0) / pos,
                        torch.zeros_like(pos))
    return precs.sum() / (min(ranklist.shape[0], n_targets) * 1.0)
