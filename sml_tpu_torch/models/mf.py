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


# rows per piece of a table drawn for one row block (a multiple of 16)
_DRAW_ROWS = 65536


def _normal_block(generator: torch.Generator, n: int, d: int, block,
                  dtype) -> torch.Tensor:
    """Rows ``[block.offset, block.offset + block.local)`` of
    ``torch.randn((n, d), generator=generator)``, drawn in pieces of
    ``_DRAW_ROWS`` rows so no more than one piece of the whole table is
    ever held. Every piece but the last holds a multiple of 16 values and
    the last at least 16 (or the whole table): torch's CPU normal sampler
    turns uniforms into normals 16 at a time and redraws the last 16 of a
    tensor whose size is not a multiple of 16, so the pieces consume and
    transform the stream exactly as one draw does."""
    out = []
    start = 0
    while start < n:
        stop = min(n, start + _DRAW_ROWS)
        if 0 < (n - stop) * d < 16:
            stop = n
        piece = torch.randn((stop - start, d), generator=generator,
                            dtype=dtype)
        lo = max(start, block.offset)
        hi = min(stop, block.offset + block.local)
        if lo < hi:
            out.append(piece[lo - start:hi - start].clone())
        start = stop
    return torch.cat(out)


def init_mf(generator: torch.Generator, n_users: int, n_items: int,
            dim: int, device="cuda", dtype=torch.float32,
            emb_scale: float = 1.0, blocks=None) -> MFParams:
    """N(0,1)·``emb_scale`` tables drawn from ``generator`` (a CPU
    generator, so the same seed gives the same tables on every device).
    ``blocks`` (``{"user": RowBlock or None, "item": ...}``, row-sharded
    state) keeps only a side's row block, drawn without the whole table:
    the same values as the block of the whole draw."""
    device = resolve_device(device)

    def normal(n, d, side):
        block = None if blocks is None else blocks[side]
        t = (torch.randn((n, d), generator=generator, dtype=dtype)
             if block is None
             else _normal_block(generator, n, d, block, dtype))
        return (t * emb_scale).to(device)
    return MFParams(user_emb=normal(n_users, dim, "user"),
                    item_emb=normal(n_items, dim, "item"),
                    user_bias=normal(n_users, 1, "user"),
                    item_bias=normal(n_items, 1, "item"))


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
