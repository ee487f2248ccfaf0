"""P2 and P3: the eval-design probes' kernels as hand-written CUDA kernels.

``scripts/eval_variants.py`` measures candidate designs of the
999-negative leave-one-out test; two of them are Pallas TPU kernels, ported
here (their entry point is :mod:`sml_tpu_torch.scripts.eval_variants`):

* P2, :func:`candidate_scores` (``make_pallas_scorer``): the scores of each
  row's candidate slate, ``out[b, c] = ue[b] . table[cand[b, c]]`` with
  bf16 inputs and f32 sums. The TPU scored the whole table and picked the
  candidates; ``csrc/candidate_scores.cu`` gathers the candidates' rows.
* P3, :func:`dense_mask_rank` (``make_masked_rank_pallas``): the
  strictly-greater count of masked columns over the target's score, with a
  dense int8 mask that holds every candidate, the target included. The TPU
  scored every column twice; ``csrc/dense_mask_rank.cu`` compacts each
  row's set entries warp by warp and gathers only their rows, in P2's
  layout (the device code it shares with K2 is ``csrc/gather_rank.cuh``).

Each source note gives the kernel's bound and design. Each function routes
by device: a CUDA tensor launches the kernel (or raises), a CPU tensor
takes the plain PyTorch version beside it.
"""

from __future__ import annotations

import torch

from sml_tpu_torch import _build

DIM = 64          # the kernels' latent width (the probes' DIM)


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def candidate_scores_plain(ue: torch.Tensor, cand: torch.Tensor,
                           table: torch.Tensor) -> torch.Tensor:
    """(B, d) users, (B, C) candidate ids, (I, d) table -> (B, C) f32
    scores, with every product in f32 (exact for bf16 inputs)."""
    return (ue.float()[:, None, :] * table.float()[cand.long()]).sum(-1)


def candidate_scores_cuda(ue: torch.Tensor, cand: torch.Tensor,
                          table: torch.Tensor) -> torch.Tensor:
    """Launch ``candidate_scores_kernel`` once for the batch; (B, C) f32."""
    if not all(t.is_cuda for t in (ue, cand, table)):
        raise ValueError("candidate_scores_cuda takes CUDA tensors")
    if ue.dtype != torch.bfloat16 or table.dtype != torch.bfloat16:
        raise ValueError(f"ue and table must be bfloat16, got "
                         f"{ue.dtype}/{table.dtype}")
    if ue.dim() != 2 or ue.shape[1] != DIM or table.dim() != 2 \
            or table.shape[1] != DIM:
        raise ValueError(f"ue (B, {DIM}) and table (I, {DIM}) expected, got "
                         f"{tuple(ue.shape)} and {tuple(table.shape)}")
    if cand.dim() != 2 or cand.shape[0] != ue.shape[0]:
        raise ValueError(f"cand must be ({ue.shape[0]}, C), got "
                         f"{tuple(cand.shape)}")
    ue, table = ue.contiguous(), table.contiguous()
    cand = cand.to(torch.int32).contiguous()
    if not (_aligned(ue) and _aligned(table)):
        raise ValueError("ue and table must start on a 16-byte boundary")
    B, C = cand.shape
    out = torch.empty((B, C), dtype=torch.float32, device=ue.device)
    lib = _build.load_library()
    with torch.cuda.device(ue.device):
        rc = lib.sml_candidate_scores(ue.data_ptr(), cand.data_ptr(),
                                      table.data_ptr(), out.data_ptr(), B, C,
                                      table.shape[0], _build.stream_of(ue))
    _build.check(rc, "candidate_scores_kernel")
    candidate_scores_cuda.launches += 1
    return out


candidate_scores_cuda.launches = 0


def candidate_scores(ue: torch.Tensor, cand: torch.Tensor,
                     table: torch.Tensor) -> torch.Tensor:
    """P2: the CUDA kernel for tensors on the card, the plain version for
    CPU tensors."""
    if ue.is_cuda:
        return candidate_scores_cuda(ue, cand, table)
    if ue.device.type == "cpu":
        return candidate_scores_plain(ue, cand, table)
    raise ValueError(f"unsupported device {ue.device}")


def dense_mask_rank_plain(table: torch.Tensor, ue: torch.Tensor,
                          tgt: torch.Tensor,
                          maskm: torch.Tensor) -> torch.Tensor:
    """(I_pad, d) bf16 table, (B, d) users, (B,) target ids, (B, I_pad)
    int8 mask -> (B,) int32 ranks. Scores every column, ``bf16(ue) @
    table.T`` in f32, and takes the target's score from that same matrix
    (by ``gather``), so the target never outranks itself."""
    s = ue.to(torch.bfloat16).float() @ table.float().T          # (B, I_pad)
    sstar = torch.gather(s, 1, tgt.long().reshape(-1, 1))
    return ((maskm != 0) & (s > sstar)).sum(dim=1, dtype=torch.int32)


def dense_mask_rank_cuda(table: torch.Tensor, ue: torch.Tensor,
                         tgt: torch.Tensor,
                         maskm: torch.Tensor) -> torch.Tensor:
    """Launch ``dense_mask_rank_kernel`` once for the batch; (B,) int32."""
    if not all(t.is_cuda for t in (table, ue, tgt, maskm)):
        raise ValueError("dense_mask_rank_cuda takes CUDA tensors")
    if table.dtype != torch.bfloat16 or table.dim() != 2 \
            or table.shape[1] != DIM:
        raise ValueError(f"table must be (I_pad, {DIM}) bfloat16, got "
                         f"{tuple(table.shape)} {table.dtype}")
    ipad = table.shape[0]
    B = ue.shape[0]
    if ue.dim() != 2 or ue.shape[1] != DIM:
        raise ValueError(f"ue must be (B, {DIM}), got {tuple(ue.shape)}")
    if tuple(maskm.shape) != (B, ipad) or maskm.dtype != torch.int8 \
            or ipad % 16:
        raise ValueError(f"maskm must be ({B}, {ipad}) int8 with {ipad} a "
                         f"multiple of 16, got {tuple(maskm.shape)} "
                         f"{maskm.dtype}")
    if tgt.numel() != B:
        raise ValueError(f"tgt must hold {B} target ids")
    ue = ue.to(torch.bfloat16).contiguous()
    table, maskm = table.contiguous(), maskm.contiguous()
    tgt = tgt.reshape(B).to(torch.int32).contiguous()
    if not (_aligned(ue) and _aligned(table) and _aligned(maskm)):
        raise ValueError("ue, table and maskm must start on a 16-byte "
                         "boundary")
    rank = torch.empty((B,), dtype=torch.int32, device=ue.device)
    lib = _build.load_library()
    with torch.cuda.device(ue.device):
        rc = lib.sml_dense_mask_rank(ue.data_ptr(), tgt.data_ptr(),
                                     maskm.data_ptr(), table.data_ptr(),
                                     rank.data_ptr(), B, ipad,
                                     _build.stream_of(ue))
    _build.check(rc, "dense_mask_rank_kernel")
    dense_mask_rank_cuda.launches += 1
    return rank


dense_mask_rank_cuda.launches = 0


def dense_mask_rank(table: torch.Tensor, ue: torch.Tensor, tgt: torch.Tensor,
                    maskm: torch.Tensor) -> torch.Tensor:
    """P3: the CUDA kernel for tensors on the card, the plain version for
    CPU tensors."""
    if ue.is_cuda:
        return dense_mask_rank_cuda(table, ue, tgt, maskm)
    if ue.device.type == "cpu":
        return dense_mask_rank_plain(table, ue, tgt, maskm)
    raise ValueError(f"unsupported device {ue.device}")
