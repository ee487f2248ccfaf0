"""Matrix-factorization core (counterpart of ``sml_tpu/models/mf.py``).

User/item latent tables plus bias tables that are carried in state and
checkpoints but excluded from scoring, as in the reference's live path.
Tables default to N(0,1) init, torch's ``nn.Embedding`` default.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sml_tpu_torch.device import resolve_device


class MFParams(NamedTuple):
    user_emb: torch.Tensor   # (U, d)
    item_emb: torch.Tensor   # (I, d)
    user_bias: torch.Tensor  # (U, 1)
    item_bias: torch.Tensor  # (I, 1)


def init_mf(generator: torch.Generator, n_users: int, n_items: int,
            dim: int, device="cuda", dtype=torch.float32,
            emb_scale: float = 1.0) -> MFParams:
    """N(0,1)·``emb_scale`` tables drawn from ``generator`` (a CPU
    generator, so the same seed gives the same tables on every device)."""
    device = resolve_device(device)

    def normal(shape):
        return (torch.randn(shape, generator=generator, dtype=dtype)
                * emb_scale).to(device)
    return MFParams(user_emb=normal((n_users, dim)),
                    item_emb=normal((n_items, dim)),
                    user_bias=normal((n_users, 1)),
                    item_bias=normal((n_items, 1)))


def score_pairs(params: MFParams, users: torch.Tensor,
                items: torch.Tensor) -> torch.Tensor:
    """Dot-product score per (user, item) pair."""
    return (params.user_emb[users] * params.item_emb[items]).sum(-1)


def score_pairs_biased(params: MFParams, users: torch.Tensor,
                       items: torch.Tensor) -> torch.Tensor:
    """Biased variant: the dot product plus both bias terms."""
    return (score_pairs(params, users, items) + params.user_bias[users, 0]
            + params.item_bias[items, 0])


def score_candidates(params: MFParams, users: torch.Tensor,
                     cand_items: torch.Tensor) -> torch.Tensor:
    """``users`` (B,), ``cand_items`` (B, C) -> (B, C) scores."""
    ue = params.user_emb[users]                  # (B, d)
    ce = params.item_emb[cand_items]             # (B, C, d)
    return torch.einsum("bd,bcd->bc", ue, ce)


def with_tables(params: MFParams, user_emb: torch.Tensor,
                item_emb: torch.Tensor) -> MFParams:
    return params._replace(user_emb=user_emb, item_emb=item_emb)
