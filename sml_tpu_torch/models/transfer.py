"""The transfer meta-network Θ (counterpart of ``sml_tpu/models/transfer.py``).

Per embedding row, Θ maps (W_{t-1}[r], W_hat_t[r]) -> W_t[r], with
separate user and item towers. The live architecture ``conv_com`` builds
the detached interaction channel

    x_com = (x_t ⊙ x_hat) / ||x_t||      (0 on zero-norm rows)

stacks ``[x_t, x_hat, x_com]`` into a (3, d) "image" and runs

    conv1: 3 -> C1 channel mix, gelu     -> (C1, d)
    conv2: C1 -> C2 channel mix, gelu    -> (C2, d)
    flatten channel-major (index c*d+j)  -> (C2*d,)
    fc1:   C2*d -> H, gelu
    fc2:   H -> d

with ``gelu(x) = x·σ(1.702x)``. The six other kinds of the JAX package:

``conv2ch``        the same tower over ``[x_t, x_hat]`` (a (C1, 2) conv1);
                   the user side is divided by its own detached norm.
``conv_com_root``  conv1 over ``[x_t, x_hat]``, flattened, then the detached
                   channel ``|x_t|^1/2 ⊙ |x_hat|^1/2`` appended and gelu over
                   the concatenation; fc1 (C1·d + d -> H), gelu, fc2.
``mlp_delta``      ``x_t + fc2(tanh(fc1(x_hat - x_t)))``, hidden width 128.
``linear``         ``[x_t, x_hat] @ w``, no bias.
``gru``            a GRU cell on ``[x_t, x_hat]`` with hidden state x_t.
``gated``          ``α ⊙ [x_t, x_hat]`` folded to d, α a sigmoid of a
                   128-wide tanh layer; the user side gates with 6σ-3.

Parameters are stored in the JAX package's layout, field names and order
(``fc1_w`` is ``(in, out)``, ``conv1_w`` is ``(C1, K)``, ``gru``'s gates
r, z, n in that order along the 3d axis), so the CUDA kernel, the parity
tests and the checkpoints all read the same arrays. Init mirrors torch's
defaults, U(-1/sqrt(fan_in), 1/sqrt(fan_in)), with the reference's fan-ins
(``gru``'s ``w_ih`` takes fan-in d, not 2d).

The full-table refresh (:func:`apply_tables`) of ``conv_com`` is kernel K1
on the card. The other kinds have no kernel in the reference either (its
Pallas kernel is ``conv_com``'s alone): they refresh through row-blocked
plain tensor operations on any device, which is their port, not a
fallback.
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


def gelu_sig(x: torch.Tensor) -> torch.Tensor:
    """The reference's GELU approximation ``x * sigmoid(1.702 x)``."""
    return x * torch.sigmoid(1.702 * x)


class _Tower(nn.Module):
    """One side's parameters, registered in ``FIELDS`` order."""

    FIELDS: tuple = ()

    def __init__(self, *tensors):
        super().__init__()
        if len(tensors) != len(self.FIELDS):
            raise ValueError(f"{type(self).__name__} takes "
                             f"{len(self.FIELDS)} tensors {self.FIELDS}, "
                             f"got {len(tensors)}")
        for name, t in zip(self.FIELDS, tensors):
            setattr(self, name, nn.Parameter(t))


class ConvTower(_Tower):
    """``conv_com`` and ``conv2ch``: conv1_w (C1, K), conv1_b (C1,),
    conv2_w (C2, C1), conv2_b (C2,), fc1_w (C2·d, H), fc1_b (H,),
    fc2_w (H, d), fc2_b (d,); K = 3 or 2."""
    FIELDS = ("conv1_w", "conv1_b", "conv2_w", "conv2_b",
              "fc1_w", "fc1_b", "fc2_w", "fc2_b")


class ConvRootTower(_Tower):
    """``conv_com_root``: conv1_w (C1, 2), conv1_b (C1,),
    fc1_w (C1·d + d, H), fc1_b (H,), fc2_w (H, d), fc2_b (d,)."""
    FIELDS = ("conv1_w", "conv1_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b")


class MlpTower(_Tower):
    """``mlp_delta`` (w1 (d, 128), w2 (128, d)) and ``gated``
    (w1 (2d, 128), w2 (128, 2d)), with their biases."""
    FIELDS = ("w1", "b1", "w2", "b2")


class LinearTower(_Tower):
    """``linear``: w (2d, d), no bias."""
    FIELDS = ("w",)


class GruTower(_Tower):
    """``gru``: w_ih (2d, 3d), w_hh (d, 3d), b_ih (3d,), b_hh (3d,); the
    3d axis holds the r, z, n gates in that order."""
    FIELDS = ("w_ih", "w_hh", "b_ih", "b_hh")


TOWERS = {"conv_com": ConvTower, "conv2ch": ConvTower,
          "conv_com_root": ConvRootTower, "mlp_delta": MlpTower,
          "linear": LinearTower, "gru": GruTower, "gated": MlpTower}


def _check_kind(cfg: TransferConfig) -> None:
    if cfg.kind not in TOWERS:
        raise ValueError(f"unknown transfer kind {cfg.kind!r}")


def _tower_class(fields) -> type:
    """The tower class whose parameters are exactly ``fields``."""
    for cls in (ConvTower, ConvRootTower, MlpTower, LinearTower, GruTower):
        if set(cls.FIELDS) == set(fields):
            return cls
    raise ValueError(f"no transfer tower has the fields {sorted(fields)}")


class TransferParams(nn.Module):
    """Θ: a user tower and an item tower."""

    def __init__(self, user: _Tower, item: _Tower):
        super().__init__()
        self.user = user
        self.item = item


def _uniform(gen, shape, fan_in, dtype):
    bound = 1.0 / math.sqrt(fan_in)
    return (torch.rand(shape, generator=gen, dtype=dtype) * 2 - 1) * bound


def _init_tower(gen, cfg: TransferConfig, dtype) -> _Tower:
    """One tower of ``cfg.kind``: ``(shape, fan_in)`` per field, drawn in
    field order (the bounds of ``sml_tpu/models/transfer.py``)."""
    d, c1, c2, h = (cfg.latent_dim, cfg.conv1_channels, cfg.conv2_channels,
                    cfg.fc_hidden)
    kind = cfg.kind
    if kind in ("conv_com", "conv2ch"):
        k = 3 if kind == "conv_com" else 2
        spec = [((c1, k), k), ((c1,), k), ((c2, c1), c1), ((c2,), c1),
                ((c2 * d, h), c2 * d), ((h,), c2 * d), ((h, d), h),
                ((d,), h)]
    elif kind == "conv_com_root":
        fan1 = c1 * d + d
        spec = [((c1, 2), 2), ((c1,), 2), ((fan1, h), fan1), ((h,), fan1),
                ((h, d), h), ((d,), h)]
    elif kind == "mlp_delta":
        spec = [((d, 128), d), ((128,), d), ((128, d), 128), ((d,), 128)]
    elif kind == "linear":
        spec = [((2 * d, d), 2 * d)]
    elif kind == "gru":
        spec = [((2 * d, 3 * d), d), ((d, 3 * d), d), ((3 * d,), d),
                ((3 * d,), d)]
    else:   # gated
        spec = [((2 * d, 128), 2 * d), ((128,), 2 * d),
                ((128, 2 * d), 128), ((2 * d,), 128)]
    return TOWERS[kind](*(_uniform(gen, shape, fan, dtype)
                          for shape, fan in spec))


def init_transfer(generator: torch.Generator, cfg: TransferConfig,
                  device="cuda", dtype=torch.float32) -> TransferParams:
    """Fresh Θ of ``cfg.kind`` drawn from ``generator`` (a CPU generator,
    so one seed gives the same weights on every device)."""
    _check_kind(cfg)
    device = resolve_device(device)
    return TransferParams(_init_tower(generator, cfg, dtype),
                          _init_tower(generator, cfg, dtype)).to(device)


def _field(obj, name):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _fields_of(tower) -> tuple:
    return tuple(tower.keys() if isinstance(tower, Mapping)
                 else type(tower)._fields)


def theta_from_numpy(tree, device="cuda", cfg: TransferConfig = None
                     ) -> TransferParams:
    """Carry Θ across from the JAX package onto ``device``.

    ``tree`` is the JAX ``TransferParams`` with numpy leaves (e.g.
    ``jax.tree.map(np.asarray, theta)``) or the same nesting as mappings
    (``{"user": {"conv1_w": ...}, "item": {...}}``). The tower's class
    comes from ``cfg.kind`` where ``cfg`` is given, else from the JAX
    tower's ``_fields`` (or the mapping's keys). The layouts are the same,
    so the arrays are copied as they are. Its optimizer state comes across
    with ``sml_tpu_torch.train.optim.opt_state_from_numpy``."""
    device = resolve_device(device)

    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to(torch.float32).clone()
        return torch.from_numpy(np.array(x, dtype=np.float32))

    def tower(t):
        if cfg is not None:
            _check_kind(cfg)
            cls = TOWERS[cfg.kind]
        else:
            cls = _tower_class(_fields_of(t))
        return cls(*(leaf(_field(t, f)) for f in cls.FIELDS))
    return TransferParams(tower(_field(tree, "user")),
                          tower(_field(tree, "item"))).to(device)


def theta_leaves(theta: TransferParams) -> Dict[str, nn.Parameter]:
    """Θ's parameters by the JAX leaf path (``user/conv1_w``, ...), the
    names its optimizer moments and checkpoint keys use."""
    return {f"{side}/{f}": getattr(getattr(theta, side), f)
            for side in ("user", "item")
            for f in getattr(theta, side).FIELDS}


def theta_alias(theta: TransferParams) -> TransferParams:
    """Θ as new parameters on ``theta``'s own storage: a step that
    differentiates these writes ``theta``'s values in place, and no autograd
    graph into ``theta``'s parameters (a copy made with gradients on) reaches
    it."""
    return TransferParams(*(type(tw)(*(getattr(tw, f).detach()
                                        for f in tw.FIELDS))
                            for tw in (theta.user, theta.item)))


def conv_tower_apply(tw: ConvTower, stack: torch.Tensor) -> torch.Tensor:
    """Apply one conv tower to a stacked batch ``(N, K, d)`` -> ``(N, d)``."""
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


def _conv_root_apply(tw: ConvRootTower, x_t, x_hat):
    with torch.no_grad():
        x_com = (torch.sqrt(torch.sqrt(x_t * x_t))
                 * torch.sqrt(torch.sqrt(x_hat * x_hat)))
    stack = torch.stack([x_t, x_hat], dim=1)                 # (N, 2, d)
    h1 = torch.einsum("ck,nkj->ncj", tw.conv1_w, stack) \
        + tw.conv1_b[None, :, None]                          # (N, C1, d)
    flat = h1.reshape(x_t.shape[0], -1)                      # (N, C1*d)
    cat = gelu_sig(torch.cat([flat, x_com], dim=-1))
    h3 = gelu_sig(cat @ tw.fc1_w + tw.fc1_b)
    return h3 @ tw.fc2_w + tw.fc2_b


def _mlp_delta_apply(tw: MlpTower, x_t, x_hat):
    """Residual on x_t; tanh hidden layer (dropout in eval mode)."""
    h = torch.tanh((x_hat - x_t) @ tw.w1 + tw.b1)
    return x_t + (h @ tw.w2 + tw.b2)


def _gru_apply(tw: GruTower, x_t, x_hat):
    """GRUCell(concat(x_t, x_hat), hidden=x_t), gates r, z, n."""
    d = x_t.shape[-1]
    x = torch.cat([x_t, x_hat], dim=-1)
    gi = x @ tw.w_ih + tw.b_ih
    gh = x_t @ tw.w_hh + tw.b_hh
    i_r, i_z, i_n = gi[..., :d], gi[..., d:2 * d], gi[..., 2 * d:]
    h_r, h_z, h_n = gh[..., :d], gh[..., d:2 * d], gh[..., 2 * d:]
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1 - z) * n + z * x_t


def _gated_apply(tw: MlpTower, x_t, x_hat, wide_range: bool):
    """Sigmoid-gated mix; ``wide_range`` (the user side) gates with
    ``6σ-3``, the item side with ``σ``."""
    d = x_t.shape[-1]
    x = torch.cat([x_t, x_hat], dim=-1)
    h = torch.tanh(x @ tw.w1 + tw.b1)
    alpha = torch.sigmoid(h @ tw.w2 + tw.b2)
    if wide_range:
        alpha = 6.0 * alpha - 3.0
    y = alpha * x
    return y[..., :d] + y[..., d:]


def apply_rows(theta: TransferParams, cfg: TransferConfig, side: str,
               x_t: torch.Tensor, x_hat: torch.Tensor) -> torch.Tensor:
    """Transfer a batch of rows for one side ('user' | 'item');
    ``x_t`` = W_{t-1} rows, ``x_hat`` = W_hat_t rows, both (N, d)."""
    _check_kind(cfg)
    tower = theta.user if side == "user" else theta.item
    kind = cfg.kind
    if kind == "conv_com":
        stack = torch.stack([x_t, x_hat, build_x_com(x_t, x_hat)], dim=1)
        return conv_tower_apply(tower, stack)
    if kind == "conv2ch":
        out = conv_tower_apply(tower, torch.stack([x_t, x_hat], dim=1))
        if side == "user":
            norm = torch.sqrt(torch.sum(out * out, dim=-1, keepdim=True))
            out = out / torch.where(norm > 0, norm,
                                    torch.ones_like(norm)).detach()
        return out
    if kind == "conv_com_root":
        return _conv_root_apply(tower, x_t, x_hat)
    if kind == "mlp_delta":
        return _mlp_delta_apply(tower, x_t, x_hat)
    if kind == "linear":
        return torch.cat([x_t, x_hat], dim=-1) @ tower.w
    if kind == "gru":
        return _gru_apply(tower, x_t, x_hat)
    return _gated_apply(tower, x_t, x_hat, wide_range=(side == "user"))


def _apply_blocked(theta: TransferParams, cfg: TransferConfig, side: str,
                   last: torch.Tensor, hat: torch.Tensor,
                   block_rows: int, out=None) -> torch.Tensor:
    """Θ_side over every row in blocks of ``block_rows``, each block
    upcast to f32 (snapshots may be stored bf16), so only one block's
    intermediates and f32 copy are live; into ``out`` when given."""
    n, d = last.shape
    if out is None:
        out = torch.empty((n, d), dtype=torch.float32, device=last.device)
    elif out.shape != (n, d) or out.dtype != torch.float32:
        raise ValueError(f"out must be ({n}, {d}) float32, got "
                         f"{tuple(out.shape)} {out.dtype}")
    for s in range(0, n, block_rows):
        out[s:s + block_rows] = apply_rows(
            theta, cfg, side, last[s:s + block_rows].float(),
            hat[s:s + block_rows].float())
    return out


def apply_tables(theta: TransferParams, cfg: TransferConfig,
                 last_user: torch.Tensor, hat_user: torch.Tensor,
                 last_item: torch.Tensor, hat_item: torch.Tensor,
                 block_rows: int = 65536, out=None):
    """Full-table refresh W_t = Θ(W_{t-1}, W_hat_t), forward only; the
    output is f32 whatever the snapshots' dtype. ``out``: a ``(user,
    item)`` pair of f32 tables to write into (they may be the MF tables
    themselves: only the snapshots and Θ are read), else new tensors.

    ``conv_com`` goes through :func:`ops.transfer_kernel.fused_table_transfer`,
    one side at a time: kernel K1 for tensors on the card, its row-blocked
    plain version for tensors on the CPU. Every other kind runs the
    row-blocked plain operations on either device (the reference has no
    kernel for them), so K1 never receives another kind's tower."""
    _check_kind(cfg)
    out_u, out_i = (None, None) if out is None else out
    with torch.no_grad():
        if cfg.kind == "conv_com":
            from sml_tpu_torch.ops import transfer_kernel
            return (transfer_kernel.fused_table_transfer(
                        theta.user, last_user, hat_user,
                        block_rows=block_rows, out=out_u),
                    transfer_kernel.fused_table_transfer(
                        theta.item, last_item, hat_item,
                        block_rows=block_rows, out=out_i))
        return (_apply_blocked(theta, cfg, "user", last_user, hat_user,
                               block_rows, out=out_u),
                _apply_blocked(theta, cfg, "item", last_item, hat_item,
                               block_rows, out=out_i))


# The JAX package's ``apply_tables_sharded``: the refresh is row-parallel,
# so on row-sharded tables each rank runs :func:`apply_tables` on its own
# row blocks (the snapshots it holds), with no collective. For
# ``conv_com`` on the card that is two K1 launches per rank; a side that
# stays replicated is refreshed whole on every rank.
apply_tables_sharded = apply_tables
