"""Plain PyTorch reference of full-catalog top-K serving: every item's
score of a user row is its dot product with the item's row; a user's
top-K are the K items of highest score."""

from __future__ import annotations

import torch


def all_scores(user_rows: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """``(n, I)`` float64 scores of every item for each user row."""
    return user_rows.double() @ items.double().T


def served(user_rows: torch.Tensor, items: torch.Tensor, k: int):
    """``(scores, ids)`` of the top ``k`` items, from a float32 product in
    the current precision (the reference served in the program's
    place)."""
    return torch.topk(user_rows.float() @ items.float().T, k, dim=1)
