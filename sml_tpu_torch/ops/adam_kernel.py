"""K3: the full-table decay-Adam pass as a hand-written CUDA kernel.

Replaces the Pallas TPU kernel ``sml_tpu/ops/adam_kernel.py``
``fused_decay_adam``. One g=0 dense-Adam step over whole tables, in place:

    mu <- b1*mu;  nu <- b2*nu;  p <- p + (-lr) * ((mu/bc1) / (sqrt(nu/bc2) + eps))

with ``bc1 = 1 - b1**t``, ``bc2 = 1 - b2**t`` computed on the host in f32
from the integer step count (:func:`sml_tpu_torch.train.optim.bias_corrections`).
It is the full-table half of ``sparse_dense_adam_update``; the touched rows
are fixed up by the caller. ``bc1``/``bc2`` come as Python floats or as
0-d f32 tensors on the tables' device; the kernel reads them through
pointers when it runs, so a step a CUDA graph replays reads each replay's
values (``train/optim.py`` ``BiasTable``).

The function is bound by bytes on the card: 24 bytes per element (read and
write ``p``, ``mu``, ``nu``) for 8 operations. The kernel
(``csrc/adam_kernel.cu``) takes up to :data:`MAX_LEAVES` tables in one
launch (the MF step's four leaves: one launch per step), streams them once
with 16-byte loads and stores and rounds every operation explicitly, so it
agrees with :func:`decay_adam_plain` bit for bit; its source note gives the
bound at the Yelp shape and the design. It takes every length and every
f32 table, bias columns and views off a 16-byte boundary included (the TPU
kernel's 2^20-element and 128-lane gates were tiling limits of the TPU).

:func:`fused_decay_adam_multi` routes by device: CUDA tensors launch the
kernel (or raise), CPU tensors take :func:`decay_adam_plain` leaf by leaf;
:func:`fused_decay_adam` is its one-table case.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from sml_tpu_torch import _build

MAX_LEAVES = 8    # tables per launch (the kernel's by-value leaf table)


def _bias_tensor(bc, like: torch.Tensor) -> torch.Tensor:
    if isinstance(bc, torch.Tensor):
        return bc
    return torch.full((), bc, dtype=torch.float32, device=like.device)


def decay_adam_plain(p: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                     bc1, bc2, *, lr: float, b1: float, b2: float,
                     eps: float) -> None:
    """Plain PyTorch version, in place: the same chain of f32 ops. The
    bias corrections (floats, or 0-d f32 tensors on the table's device)
    divide as 0-d tensors on the table's device (on the card a division by
    a host scalar becomes a multiplication by its reciprocal, which rounds
    differently)."""
    bc1_t, bc2_t = _bias_tensor(bc1, p), _bias_tensor(bc2, p)
    with torch.no_grad():
        mu.mul_(b1)
        nu.mul_(b2)
        p.add_((mu / bc1_t) / (torch.sqrt(nu / bc2_t) + eps) * (-lr))


@_build.counted
def decay_adam_cuda(leaves, bc1, bc2, *, lr: float, b1: float, b2: float,
                    eps: float) -> None:
    """Launch ``decay_adam_kernel`` once over ``leaves``, up to
    :data:`MAX_LEAVES` ``(p, mu, nu)`` triples on one card, in place.
    ``bc1``/``bc2``: 0-d f32 tensors on the card, which the kernel reads
    when it runs, or floats, put into such tensors first."""
    # every optimizer step pays these checks on the host: one pass over the
    # tensors, and no device guard when the card is already current
    leaves = list(leaves)
    flat, dev = [], None
    for leaf in leaves:
        p, mu, nu = leaf
        if dev is None:
            dev = p.get_device()
        for t in leaf:
            if not t.is_cuda or t.get_device() != dev:
                raise ValueError("decay_adam_cuda takes CUDA tensors, every "
                                 "p, mu and nu on one device")
            if t.dtype is not torch.float32:
                raise ValueError(f"p, mu, nu must be float32, got {t.dtype}")
            if t.shape != p.shape:
                raise ValueError(f"p {tuple(p.shape)}, mu {tuple(mu.shape)} "
                                 f"and nu {tuple(nu.shape)} must have one "
                                 f"shape")
            if not t.is_contiguous():
                raise ValueError("p, mu, nu must be contiguous (updated in "
                                 "place)")
        ptrs = [t.data_ptr() for t in leaf]
        if len(set(ptrs)) != 3:
            raise ValueError("p, mu, nu must be three distinct buffers")
        n = p.numel()
        if n:
            flat += ptrs
            flat.append(n)
    if not flat:
        return
    bc1, bc2 = _bias_tensor(bc1, p), _bias_tensor(bc2, p)
    for bc in (bc1, bc2):
        if not (bc.is_cuda and bc.get_device() == dev and bc.numel() == 1
                and bc.dtype is torch.float32):
            raise ValueError("bias corrections must be one f32 value each "
                             "on the tables' card")
    if len(flat) > 4 * MAX_LEAVES:
        raise ValueError(f"one launch takes at most {MAX_LEAVES} non-empty "
                         f"leaves, got {len(flat) // 4}")
    lib = _build.load_library()
    guard = (torch.cuda.device(dev) if dev != torch.cuda.current_device()
             else contextlib.nullcontext())
    with guard:
        table = (ctypes.c_int64 * len(flat))(*flat)
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sml_decay_adam(table, len(flat) // 4, lr, b1, b2, eps,
                                bc1.data_ptr(), bc2.data_ptr(), stream)
    _build.check(rc, "decay_adam_kernel")
    decay_adam_cuda.launches += 1



def fused_decay_adam_multi(leaves, bc1, bc2, *, lr: float, b1: float,
                           b2: float, eps: float) -> None:
    """One g=0 dense-Adam step over every ``(p, mu, nu)`` triple of
    ``leaves``, in place: one kernel launch for tensors on the card, the
    plain version leaf by leaf for CPU tensors. ``bc1``/``bc2``: floats or
    0-d f32 tensors on the tables' device."""
    leaves = [tuple(leaf) for leaf in leaves]
    kw = dict(lr=lr, b1=b1, b2=b2, eps=eps)
    if any(t.is_cuda for leaf in leaves for t in leaf):
        return decay_adam_cuda(leaves, bc1, bc2, **kw)
    for leaf in leaves:
        if any(t.device.type != "cpu" for t in leaf):
            raise ValueError(f"unsupported device {leaf[0].device}")
    for leaf in leaves:
        decay_adam_plain(*leaf, bc1, bc2, **kw)


def fused_decay_adam(p: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                     bc1, bc2, *, lr: float, b1: float, b2: float,
                     eps: float) -> None:
    """One g=0 dense-Adam step over one table, in place: the one-leaf case
    of :func:`fused_decay_adam_multi`."""
    fused_decay_adam_multi([(p, mu, nu)], bc1, bc2, lr=lr, b1=b1, b2=b2,
                           eps=eps)
