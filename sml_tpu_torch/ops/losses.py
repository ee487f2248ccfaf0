"""Pairwise ranking losses, masked for padded batches (counterpart of
``sml_tpu/ops/losses.py``).

The live SML loss is the "BCE" pair form

    L = -mean(log(sigmoid(s_pos) + 1e-15)) - mean(log(sigmoid(-s_neg) + 1e-15))

with the negative term written as ``sigmoid(-x)``, which equals
``1 - sigmoid(x)`` and stays finite where ``1 - sigmoid(x)`` rounds to 0
(x ≳ 17 in f32). The alternative is summed BPR. Means and sums run over the
valid rows only (``mask``), so a padded batch equals the reference's shorter
final batch.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

_EPS = 1e-15


def bce_pair_loss(pos_score: torch.Tensor, neg_score: torch.Tensor,
                  mask: torch.Tensor,
                  denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked mean BCE over a (positive, negative) score-pair batch.
    ``denom`` replaces the batch's own valid-row count (a data rank's block
    of a batch divides by the whole batch's count)."""
    if denom is None:
        denom = torch.clamp(mask.sum(), min=1.0)
    pos = -torch.sum(mask * torch.log(torch.sigmoid(pos_score) + _EPS)) / denom
    neg = -torch.sum(mask * torch.log(torch.sigmoid(-neg_score) + _EPS)) / denom
    return pos + neg


def bpr_loss(pos_score: torch.Tensor, neg_score: torch.Tensor,
             mask: torch.Tensor,
             normalize_by: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked summed BPR; optional per-row score normalization."""
    diff = pos_score - neg_score
    if normalize_by is not None:
        diff = diff / normalize_by
    return -torch.sum(mask * F.logsigmoid(diff))


def l2_embedding_penalty(mask: torch.Tensor,
                         *embs: torch.Tensor) -> torch.Tensor:
    """``0.5 * sum(emb**2)`` over the valid rows."""
    total = torch.zeros((), dtype=torch.float32, device=mask.device)
    for e in embs:
        total = total + torch.sum(mask[:, None] * e * e)
    return 0.5 * total
