"""P2 and P3: the eval-design probes' kernels as hand-written CUDA kernels.

``scripts/eval_variants.py`` measures candidate designs of the
999-negative leave-one-out test; two of them are Pallas TPU kernels, ported
here (their entry point is :mod:`sml_tpu_torch.scripts.eval_variants`):

* P2, :func:`candidate_scores` (``make_pallas_scorer``'s scorer): the
  scores of each row's candidate slate, ``out[b, c] = ue_t[users[b]] .
  table[cand[b, c]]`` with bf16 inputs and f32 sums, out-of-range ids as
  the JAX function takes them. The TPU scored the whole table and picked
  the candidates; ``csrc/candidate_scores.cu`` gathers the user row and the
  candidates' rows, in one launch per call.
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

import contextlib
import functools

import torch

from sml_tpu_torch import _build

DIM = 64          # the kernels' latent width (the probes' DIM)


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


_ID_DTYPES = (torch.int32, torch.int64)


def candidate_scores_plain(ue_t: torch.Tensor, users: torch.Tensor,
                           cand: torch.Tensor,
                           table: torch.Tensor) -> torch.Tensor:
    """(U, d) user table, (B,) user ids, (B, C) candidate ids, (I, d) item
    table -> (B, C) f32 scores of ``bf16(ue_t[users]) . table[cand]``,
    every product in f32 (exact for bf16 inputs). Ids as the JAX scorer
    takes them: a user id in [-U, 0) wraps and every user id is then
    clamped into [0, U-1]; a candidate id in [-I, 0) wraps and any other
    candidate id outside [0, I) scores NaN."""
    n_users, n_items = ue_t.shape[0], table.shape[0]
    if n_users == 0:
        raise ValueError("ue_t has no rows")
    u = users.long()
    u = torch.where(u < 0, u + n_users, u).clamp(0, n_users - 1)
    c = cand.long()
    c = torch.where(c < 0, c + n_items, c)
    valid = (c >= 0) & (c < n_items)
    ue = ue_t[u].to(torch.bfloat16).float()
    # row I of the padded table is zeros, read by the ids that score NaN
    rows = torch.nn.functional.pad(table.float(), (0, 0, 0, 1))[
        torch.where(valid, c, n_items)]
    scores = (ue[:, None, :] * rows).sum(-1)
    return scores.masked_fill(~valid, float("nan"))


@functools.cache
def _candidate_scores_entry():
    return _build.load_library().sml_candidate_scores


@_build.counted
def candidate_scores_cuda(ue_t: torch.Tensor, users: torch.Tensor,
                          cand: torch.Tensor,
                          table: torch.Tensor) -> torch.Tensor:
    """Launch ``candidate_scores_kernel`` once for the batch, the user
    gather inside it; (B, C) f32. ``users`` and ``cand`` are int32 or int64
    and may be strided views; the tables are contiguous bf16 of width
    :data:`DIM`. Only ``out`` is allocated."""
    # the probe pays these checks per batch: attributes only
    dev = table.get_device()
    if not (ue_t.is_cuda and users.is_cuda and cand.is_cuda and table.is_cuda
            and ue_t.get_device() == users.get_device() == cand.get_device()
            == dev):
        raise ValueError("candidate_scores_cuda takes CUDA tensors on one "
                         "device")
    if ue_t.dtype != torch.bfloat16 or table.dtype != torch.bfloat16:
        raise ValueError(f"ue_t and table must be bfloat16, got "
                         f"{ue_t.dtype}/{table.dtype}")
    if ue_t.dim() != 2 or ue_t.shape[1] != DIM or table.dim() != 2 \
            or table.shape[1] != DIM:
        raise ValueError(f"the kernel takes width DIM={DIM}: ue_t (U, {DIM}) "
                         f"and table (I, {DIM}) expected, got "
                         f"{tuple(ue_t.shape)} and {tuple(table.shape)}")
    if not (ue_t.is_contiguous() and table.is_contiguous()
            and _aligned(ue_t) and _aligned(table)):
        raise ValueError("ue_t and table must be contiguous and start on a "
                         "16-byte boundary")
    if ue_t.shape[0] == 0:
        raise ValueError("ue_t has no rows")
    if users.dtype not in _ID_DTYPES or cand.dtype not in _ID_DTYPES:
        raise ValueError(f"ids must be int32 or int64, got {users.dtype}/"
                         f"{cand.dtype}")
    if users.dim() != 1 or cand.dim() != 2 \
            or cand.shape[0] != users.shape[0]:
        raise ValueError(f"users (B,) and cand (B, C) expected, got "
                         f"{tuple(users.shape)} and {tuple(cand.shape)}")
    B, C = cand.shape
    out = torch.empty((B, C), dtype=torch.float32, device=table.device)
    guard = (torch.cuda.device(dev) if dev != torch.cuda.current_device()
             else contextlib.nullcontext())
    with guard:
        rc = _candidate_scores_entry()(
            ue_t.data_ptr(), ue_t.shape[0], users.data_ptr(),
            users.stride(0), users.dtype == torch.int64, cand.data_ptr(),
            cand.stride(0), cand.stride(1), cand.dtype == torch.int64,
            table.data_ptr(), table.shape[0], out.data_ptr(), B, C,
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "candidate_scores_kernel")
    candidate_scores_cuda.launches += 1
    return out



def candidate_scores(ue_t: torch.Tensor, users: torch.Tensor,
                     cand: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """P2, the probe's whole scorer: the CUDA kernel for tensors on the card,
    the plain version for CPU tensors."""
    if table.is_cuda:
        return candidate_scores_cuda(ue_t, users, cand, table)
    if table.device.type == "cpu":
        return candidate_scores_plain(ue_t, users, cand, table)
    raise ValueError(f"unsupported device {table.device}")


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


@_build.counted
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



def dense_mask_rank(table: torch.Tensor, ue: torch.Tensor, tgt: torch.Tensor,
                    maskm: torch.Tensor) -> torch.Tensor:
    """P3: the CUDA kernel for tensors on the card, the plain version for
    CPU tensors."""
    if ue.is_cuda:
        return dense_mask_rank_cuda(table, ue, tgt, maskm)
    if ue.device.type == "cpu":
        return dense_mask_rank_plain(table, ue, tgt, maskm)
    raise ValueError(f"unsupported device {ue.device}")
