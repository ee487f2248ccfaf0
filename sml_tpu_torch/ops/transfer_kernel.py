"""K1: the full-table transfer refresh as a hand-written CUDA kernel.

Replaces the Pallas TPU kernel ``sml_tpu/ops/transfer_kernel.py``
``fused_table_transfer``. The kernel (``csrc/transfer_kernel.cu``) runs the
whole per-row chain ``x_com -> conv1 -> gelu -> conv2 -> gelu -> flatten ->
fc1 -> gelu -> fc2`` with every intermediate in shared memory or registers,
so HBM sees only ``last``, ``hat`` and the output. It is bound by
operations (f32, ~403k per row at the Yelp shape); the source note in the
``.cu`` file gives the bound and the design. It takes every ``d`` up to
:data:`MAX_D`, ``C1`` up to :data:`MAX_C1` and any ``C2`` and ``H``: its
shared memory grows with ``d`` only.

:func:`fused_table_transfer` routes by device: a CUDA tensor launches the
kernel (or raises), a CPU tensor takes :func:`transfer_rows_plain`, the
plain PyTorch version of the same function. Forward only: gradients never
flow through the full-table refresh. Both write into ``out`` when it is
given: the kernel reads only ``last``, ``hat`` and the tower, so ``out``
may be the MF table the refresh replaces (the fused phase refreshes the
tables in place, so a CUDA graph that captured it keeps its addresses).
"""

from __future__ import annotations

import torch

from sml_tpu_torch import _build
from sml_tpu_torch.models.transfer import (ConvTower, build_x_com,
                                           conv_tower_apply)

MAX_D = 512    # the kernel's fc2 register tiles cover d <= 512
MAX_C1 = 16    # conv1's outputs are held in registers


def _check_out(out: torch.Tensor, last: torch.Tensor,
               hat: torch.Tensor) -> None:
    """``out`` must be a contiguous (N, d) f32 tensor on the rows' device
    that shares no memory with ``last`` or ``hat``."""
    if (out.shape != last.shape or out.dtype != torch.float32
            or out.device != last.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {tuple(last.shape)} "
                         f"float32 tensor on {last.device}, got "
                         f"{tuple(out.shape)} {out.dtype} on {out.device}")
    lo, hi = out.data_ptr(), out.data_ptr() + out.numel() * 4
    for t in (last, hat):
        t_lo = t.data_ptr()
        if t_lo < hi and lo < t_lo + t.numel() * t.element_size():
            raise ValueError("out must not overlap last or hat")


def transfer_rows_plain(tower: ConvTower, last: torch.Tensor,
                        hat: torch.Tensor, block_rows: int = 65536,
                        out: torch.Tensor = None) -> torch.Tensor:
    """Plain PyTorch Θ_side(last, hat) over all rows, blocked so the (R, H)
    intermediates stay one block in size; rows are upcast to f32 per block
    (snapshots may be stored bf16). Written into ``out`` when given."""
    n, d = last.shape
    if out is None:
        out = torch.empty((n, d), dtype=torch.float32, device=last.device)
    else:
        _check_out(out, last, hat)
    with torch.no_grad():
        for s in range(0, n, block_rows):
            x_t = last[s:s + block_rows].float()
            x_hat = hat[s:s + block_rows].float()
            stack = torch.stack([x_t, x_hat, build_x_com(x_t, x_hat)], dim=1)
            out[s:s + block_rows] = conv_tower_apply(tower, stack)
    return out


@_build.counted
def transfer_rows_cuda(tower: ConvTower, last: torch.Tensor,
                       hat: torch.Tensor,
                       out: torch.Tensor = None) -> torch.Tensor:
    """Launch ``transfer_rows_kernel`` once over all N rows; (N, d) f32,
    written into ``out`` when given."""
    if not (last.is_cuda and hat.is_cuda):
        raise ValueError("transfer_rows_cuda takes CUDA tensors")
    if last.shape != hat.shape or last.dim() != 2:
        raise ValueError(f"last {tuple(last.shape)} and hat "
                         f"{tuple(hat.shape)} must be the same (N, d)")
    if last.dtype != hat.dtype or last.dtype not in (torch.float32,
                                                     torch.bfloat16):
        raise ValueError(f"last/hat must both be float32 or bfloat16, got "
                         f"{last.dtype}/{hat.dtype}")
    n, d = last.shape
    c1 = tower.conv1_w.shape[0]
    c2 = tower.conv2_w.shape[0]
    h = tower.fc1_w.shape[1]
    if d > MAX_D or c1 > MAX_C1:
        raise ValueError(f"transfer_rows_kernel supports d <= MAX_D = {MAX_D} "
                         f"and C1 <= MAX_C1 = {MAX_C1}; got d={d}, C1={c1}")
    if tower.conv1_w.shape[1] != 3 or tower.fc1_w.shape[0] != c2 * d \
            or tuple(tower.fc2_w.shape) != (h, d):
        raise ValueError("tower shapes do not match a conv_com tower at "
                         f"d={d}")
    weights = [getattr(tower, f).detach() for f in ConvTower.FIELDS]
    if any(w.device != last.device or w.dtype != torch.float32
           for w in weights):
        raise ValueError(f"the tower's parameters must be float32 on "
                         f"{last.device}, like the rows; got "
                         f"{sorted({str(w.device) for w in weights})} "
                         f"{sorted({str(w.dtype) for w in weights})}")
    weights = [w.contiguous() for w in weights]
    last = last.contiguous()
    hat = hat.contiguous()
    if out is None:
        out = torch.empty((n, d), dtype=torch.float32, device=last.device)
    else:
        _check_out(out, last, hat)
    lib = _build.load_library()
    with torch.cuda.device(last.device):
        rc = lib.sml_transfer_rows(
            last.data_ptr(), hat.data_ptr(), int(last.dtype == torch.bfloat16),
            *[w.data_ptr() for w in weights], out.data_ptr(),
            n, d, c1, c2, h, _build.stream_of(last))
    _build.check(rc, "transfer_rows_kernel")
    transfer_rows_cuda.launches += 1
    return out



def fused_table_transfer(tower: ConvTower, last: torch.Tensor,
                         hat: torch.Tensor, block_rows: int = 65536,
                         out: torch.Tensor = None) -> torch.Tensor:
    """Θ_side(last, hat) over all N rows, (N, d) -> (N, d) f32: the CUDA
    kernel for tensors on the card, the plain version for CPU tensors;
    written into ``out`` (contiguous f32, not overlapping the rows) when
    given."""
    if last.is_cuda:
        return transfer_rows_cuda(tower, last, hat, out=out)
    if last.device.type == "cpu":
        return transfer_rows_plain(tower, last, hat, block_rows, out=out)
    raise ValueError(f"unsupported device {last.device}")
