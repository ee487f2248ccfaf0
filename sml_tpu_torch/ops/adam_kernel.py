"""K3: the full-table decay-Adam pass as a hand-written CUDA kernel.

Replaces the Pallas TPU kernel ``sml_tpu/ops/adam_kernel.py``
``fused_decay_adam``. One g=0 dense-Adam step over a whole table, in place:

    mu <- b1*mu;  nu <- b2*nu;  p <- p + (-lr) * ((mu/bc1) / (sqrt(nu/bc2) + eps))

with ``bc1 = 1 - b1**t``, ``bc2 = 1 - b2**t`` computed on the host in f32
from the integer step count (:func:`sml_tpu_torch.train.optim.bias_corrections`).
It is the full-table half of ``sparse_dense_adam_update``; the touched rows
are fixed up by the caller.

The function is bound by bytes on the card: 24 bytes per element (read and
write ``p``, ``mu``, ``nu``) for 8 operations. The kernel
(``csrc/adam_kernel.cu``) streams the flat table once with 16-byte loads and
stores and rounds every operation explicitly, so it agrees with
:func:`decay_adam_plain` bit for bit; its source note gives the bound at
the Yelp shape and the design. It takes every length and every f32 table,
bias columns included (the TPU kernel's 2^20-element and 128-lane gates
were tiling limits of the TPU).

:func:`fused_decay_adam` routes by device: a CUDA tensor launches the kernel
(or raises), a CPU tensor takes :func:`decay_adam_plain`.
"""

from __future__ import annotations

import torch

from sml_tpu_torch import _build


def decay_adam_plain(p: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                     bc1: float, bc2: float, *, lr: float, b1: float,
                     b2: float, eps: float) -> None:
    """Plain PyTorch version, in place: the same chain of f32 ops. The
    bias corrections divide as 0-d tensors on the table's device (on the
    card a division by a host scalar becomes a multiplication by its
    reciprocal, which rounds differently)."""
    bc1_t = torch.full((), bc1, dtype=torch.float32, device=p.device)
    bc2_t = torch.full((), bc2, dtype=torch.float32, device=p.device)
    with torch.no_grad():
        mu.mul_(b1)
        nu.mul_(b2)
        p.add_((mu / bc1_t) / (torch.sqrt(nu / bc2_t) + eps) * (-lr))


def decay_adam_cuda(p: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                    bc1: float, bc2: float, *, lr: float, b1: float,
                    b2: float, eps: float) -> None:
    """Launch ``decay_adam_kernel`` once over the whole table, in place."""
    tensors = (p, mu, nu)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("decay_adam_cuda takes CUDA tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("p, mu and nu must be on one device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"p, mu, nu must be float32, got "
                         f"{[str(t.dtype) for t in tensors]}")
    if not (p.shape == mu.shape == nu.shape):
        raise ValueError(f"p {tuple(p.shape)}, mu {tuple(mu.shape)} and nu "
                         f"{tuple(nu.shape)} must have one shape")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("p, mu, nu must be contiguous (updated in place)")
    if len({t.data_ptr() for t in tensors}) != 3:
        raise ValueError("p, mu, nu must be three distinct buffers")
    n = p.numel()
    if n == 0:
        return
    vec = all(t.data_ptr() % 16 == 0 for t in tensors)
    lib = _build.load_library()
    with torch.cuda.device(p.device):
        rc = lib.sml_decay_adam(p.data_ptr(), mu.data_ptr(), nu.data_ptr(),
                                n, int(vec), lr, b1, b2, eps, bc1, bc2,
                                _build.stream_of(p))
    _build.check(rc, "decay_adam_kernel")
    decay_adam_cuda.launches += 1


decay_adam_cuda.launches = 0


def fused_decay_adam(p: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                     bc1: float, bc2: float, *, lr: float, b1: float,
                     b2: float, eps: float) -> None:
    """One g=0 dense-Adam step over a whole table, in place: the CUDA
    kernel for tensors on the card, the plain version for CPU tensors."""
    kw = dict(lr=lr, b1=b1, b2=b2, eps=eps)
    if p.is_cuda:
        return decay_adam_cuda(p, mu, nu, bc1, bc2, **kw)
    if p.device.type == "cpu":
        return decay_adam_plain(p, mu, nu, bc1, bc2, **kw)
    raise ValueError(f"unsupported device {p.device}")
