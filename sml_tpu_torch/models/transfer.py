"""The transfer meta-network Θ (counterpart of ``sml_tpu/models/transfer.py``).

Per embedding row, Θ maps (W_{t-1}[r], W_hat_t[r]) -> W_t[r]. The live
architecture ``conv_com`` builds the detached interaction channel

    x_com = (x_t ⊙ x_hat) / ||x_t||      (0 on zero-norm rows)

stacks ``[x_t, x_hat, x_com]`` into a (3, d) "image" and runs, per side
(separate user and item towers):

    conv1: 3 -> C1 channel mix, gelu     -> (C1, d)
    conv2: C1 -> C2 channel mix, gelu    -> (C2, d)
    flatten channel-major (index c*d+j)  -> (C2*d,)
    fc1:   C2*d -> H, gelu
    fc2:   H -> d

with ``gelu(x) = x·σ(1.702x)``. Parameters are stored in the JAX package's
layout (``fc1_w`` is ``(C2·d, H)``, ``conv1_w`` is ``(C1, 3)``) so the CUDA
kernel, the parity tests and the checkpoints all read the same arrays.
Init mirrors torch's defaults: U(-1/sqrt(fan_in), 1/sqrt(fan_in)).

Only ``conv_com`` is ported; the six other kinds raise
``NotImplementedError`` (ROADMAP.md §1, "Other transfer kinds").
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch
from torch import nn

from sml_tpu_torch.config import TransferConfig
from sml_tpu_torch.device import resolve_device

_OTHER_KINDS = ("conv2ch", "conv_com_root", "mlp_delta", "linear", "gru",
                "gated")
TOWER_FIELDS = ("conv1_w", "conv1_b", "conv2_w", "conv2_b",
                "fc1_w", "fc1_b", "fc2_w", "fc2_b")


def _check_kind(cfg: TransferConfig) -> None:
    if cfg.kind == "conv_com":
        return
    if cfg.kind in _OTHER_KINDS:
        raise NotImplementedError(
            f"transfer kind {cfg.kind!r} is not ported yet (ROADMAP.md §1, "
            "'Other transfer kinds'); only 'conv_com' is")
    raise ValueError(f"unknown transfer kind {cfg.kind!r}")


def gelu_sig(x: torch.Tensor) -> torch.Tensor:
    """The reference's GELU approximation ``x * sigmoid(1.702 x)``."""
    return x * torch.sigmoid(1.702 * x)


class ConvTower(nn.Module):
    """One ``conv_com`` tower; parameters in the JAX package's layout."""

    def __init__(self, conv1_w, conv1_b, conv2_w, conv2_b,
                 fc1_w, fc1_b, fc2_w, fc2_b):
        super().__init__()
        self.conv1_w = nn.Parameter(conv1_w)   # (C1, 3)
        self.conv1_b = nn.Parameter(conv1_b)   # (C1,)
        self.conv2_w = nn.Parameter(conv2_w)   # (C2, C1)
        self.conv2_b = nn.Parameter(conv2_b)   # (C2,)
        self.fc1_w = nn.Parameter(fc1_w)       # (C2*d, H)
        self.fc1_b = nn.Parameter(fc1_b)       # (H,)
        self.fc2_w = nn.Parameter(fc2_w)       # (H, d)
        self.fc2_b = nn.Parameter(fc2_b)       # (d,)


class TransferParams(nn.Module):
    """Θ: a user tower and an item tower."""

    def __init__(self, user: ConvTower, item: ConvTower):
        super().__init__()
        self.user = user
        self.item = item


def _uniform(gen, shape, fan_in, dtype):
    bound = 1.0 / math.sqrt(fan_in)
    return (torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1) * bound


def _init_conv_tower(gen, cfg: TransferConfig, dtype) -> ConvTower:
    d, c1, c2, h = (cfg.latent_dim, cfg.conv1_channels, cfg.conv2_channels,
                    cfg.fc_hidden)
    return ConvTower(
        conv1_w=_uniform(gen, (c1, 3), 3, dtype),
        conv1_b=_uniform(gen, (c1,), 3, dtype),
        conv2_w=_uniform(gen, (c2, c1), c1, dtype),
        conv2_b=_uniform(gen, (c2,), c1, dtype),
        fc1_w=_uniform(gen, (c2 * d, h), c2 * d, dtype),
        fc1_b=_uniform(gen, (h,), c2 * d, dtype),
        fc2_w=_uniform(gen, (h, d), h, dtype),
        fc2_b=_uniform(gen, (d,), h, dtype))


def init_transfer(generator: torch.Generator, cfg: TransferConfig,
                  device="cuda", dtype=torch.float32) -> TransferParams:
    """Fresh Θ drawn from ``generator`` (a CPU generator, so one seed gives
    the same weights on every device)."""
    _check_kind(cfg)
    device = resolve_device(device)
    return TransferParams(_init_conv_tower(generator, cfg, dtype),
                          _init_conv_tower(generator, cfg, dtype)).to(device)


def _field(obj, name):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def theta_from_numpy(tree, device="cuda") -> TransferParams:
    """Carry Θ across from the JAX package onto ``device``.

    ``tree`` is the JAX ``TransferParams`` with numpy leaves (e.g.
    ``jax.tree.map(np.asarray, theta)``) or the same nesting as mappings
    (``{"user": {"conv1_w": ...}, "item": {...}}``). The layouts are the
    same, so the arrays are copied as they are. Its optimizer state comes
    across with ``sml_tpu_torch.train.optim.opt_state_from_numpy``."""
    device = resolve_device(device)

    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to(torch.float32).clone()
        return torch.from_numpy(np.array(x, dtype=np.float32))

    def tower(t):
        return ConvTower(*(leaf(_field(t, f)) for f in TOWER_FIELDS))
    return TransferParams(tower(_field(tree, "user")),
                          tower(_field(tree, "item"))).to(device)


def theta_leaves(theta: TransferParams) -> Dict[str, nn.Parameter]:
    """Θ's parameters by the JAX leaf path (``user/conv1_w``, ...), the
    names its optimizer moments and checkpoint keys use."""
    return {f"{side}/{f}": getattr(getattr(theta, side), f)
            for side in ("user", "item") for f in TOWER_FIELDS}


def conv_tower_apply(tw: ConvTower, stack: torch.Tensor) -> torch.Tensor:
    """Apply one tower to a stacked batch ``(N, 3, d)`` -> ``(N, d)``."""
    n = stack.shape[0]
    h1 = torch.einsum("ck,nkj->ncj", tw.conv1_w, stack) \
        + tw.conv1_b[None, :, None]
    h1 = gelu_sig(h1)                                        # (N, C1, d)
    h2 = torch.einsum("ec,ncj->nej", tw.conv2_w, h1) \
        + tw.conv2_b[None, :, None]
    h2 = gelu_sig(h2)                                        # (N, C2, d)
    flat = h2.reshape(n, -1)                                 # channel-major
    h3 = gelu_sig(flat @ tw.fc1_w + tw.fc1_b)                # (N, H)
    return h3 @ tw.fc2_w + tw.fc2_b                          # (N, d)


def build_x_com(x_t: torch.Tensor, x_hat: torch.Tensor) -> torch.Tensor:
    """Interaction channel ``(x_t ⊙ x_hat) / ||x_t||``, detached; zero-norm
    rows give 0 instead of NaN."""
    with torch.no_grad():
        prod = x_t * x_hat
        norm = torch.sqrt(torch.sum(x_t * x_t, dim=-1, keepdim=True))
        safe = torch.where(norm > 0, norm, torch.ones_like(norm))
        return torch.where(norm > 0, prod / safe, torch.zeros_like(prod))


def apply_rows(theta: TransferParams, cfg: TransferConfig, side: str,
               x_t: torch.Tensor, x_hat: torch.Tensor) -> torch.Tensor:
    """Transfer a batch of rows for one side ('user' | 'item');
    ``x_t`` = W_{t-1} rows, ``x_hat`` = W_hat_t rows, both (N, d)."""
    _check_kind(cfg)
    tower = theta.user if side == "user" else theta.item
    stack = torch.stack([x_t, x_hat, build_x_com(x_t, x_hat)], dim=1)
    return conv_tower_apply(tower, stack)


def apply_tables(theta: TransferParams, cfg: TransferConfig,
                 last_user: torch.Tensor, hat_user: torch.Tensor,
                 last_item: torch.Tensor, hat_item: torch.Tensor,
                 block_rows: int = 65536):
    """Full-table refresh W_t = Θ(W_{t-1}, W_hat_t), forward only.

    Each side goes through :func:`ops.transfer_kernel.fused_table_transfer`:
    the CUDA kernel for tensors on the card (one launch per side), the
    row-blocked plain version for tensors on the CPU. Snapshots may be
    bf16; the output is f32."""
    _check_kind(cfg)
    from sml_tpu_torch.ops import transfer_kernel
    with torch.no_grad():
        return (transfer_kernel.fused_table_transfer(
                    theta.user, last_user, hat_user, block_rows=block_rows),
                transfer_kernel.fused_table_transfer(
                    theta.item, last_item, hat_item, block_rows=block_rows))
