"""K2: masked leave-one-out ranking as a hand-written CUDA kernel.

Replaces the Pallas TPU kernel ``sml_tpu/ops/eval_kernel.py``
``masked_rank_pallas``. Each eval row ``[user, target, neg_1..neg_C]`` is
ranked by the strictly-greater count of its negatives' scores over the
target score, with the negatives given as a packed membership mask; the
(B, I) score matrix is never written out. The function is bound by bytes:
2*d*popcount(mask) operations against the bytes of ue, the item table and
the mask, ~0.0024 ms per 1024-row call at the Yelp shape on an H100. K2
(``csrc/masked_rank_gather.cu``, :func:`masked_rank_cuda`) compacts each
row's set bits and gathers only those items' rows from the row-major
``(I_pad, d)`` table, which stays in L2; its design floor is the L2 gather
rate (~262 MB of f32 rows per call, ~0.056 ms at the rate P2 reached). The
source note gives both and the design.

P1 (``csrc/eval_kernel.cu``, :func:`masked_rank_variant`) computes the same
function densely, every column scored: the variants of the eval-design
probe ``scripts/eval_kernel_probe.py``, a template over rows per block and
grid order, f32 on the CUDA cores and bf16 on the tensor cores. It takes
the table transposed, ``(d, I_pad)``, as do the plain version and the JAX
package.

Mask layout (bitplane packing, unchanged from the JAX package): items are
grouped into blocks of ``I_BLK = 4096 = 32 planes x 128 lanes``; bit ``k``
of word ``jb*128 + w`` marks item ``jb*4096 + k*128 + w``. The port holds
the uint32 words in an int32 tensor (same bits; ``.numpy().view(np.uint32)``
gives JAX's words), because PyTorch's bit operations cover int32 on every
device.

:func:`masked_rank` routes by device: a CUDA tensor launches K2 (or
raises), a CPU tensor takes :func:`masked_rank_plain`.
"""

from __future__ import annotations

import torch

from sml_tpu_torch import _build

I_BLK = 4096          # items per mask block = PLANES * LANES
PLANES = 32           # bits per mask word
LANES = 128           # items per bit plane


def pad_items(n_items: int) -> int:
    """Item-axis padding so the mask/bitplane grid tiles exactly."""
    return -(-n_items // I_BLK) * I_BLK


def mask_words(n_items: int) -> int:
    """uint32 words per row of the packed mask."""
    return pad_items(n_items) // PLANES


def build_packed_mask(neg: torch.Tensor, n_items: int,
                      row_chunk: int = 1024) -> torch.Tensor:
    """(B, C) negative ids -> (B, mask_words) packed mask (int32 storage of
    the uint32 words).

    A bit-set scatter: per chunk of rows, scatter True into a dense (rows,
    I_pad) membership, then OR the 32 planes of each word together.
    Repeated ids set the same bit once, as in the JAX package."""
    B, _ = neg.shape
    ipad = pad_items(n_items)
    nblk = ipad // I_BLK
    out = torch.empty((B, nblk * LANES), dtype=torch.int32, device=neg.device)
    for s in range(0, B, row_chunk):
        cd = neg[s:s + row_chunk].long()
        hit = torch.zeros((cd.shape[0], ipad), dtype=torch.bool,
                          device=neg.device)
        hit.scatter_(1, cd, True)
        planes = hit.view(-1, nblk, PLANES, LANES)
        words = torch.zeros((cd.shape[0], nblk, LANES), dtype=torch.int64,
                            device=neg.device)
        for k in range(PLANES):
            words |= planes[:, :, k, :].long() << k
        # the uint32 bits, reinterpreted as int32
        words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
        out[s:s + row_chunk] = words.view(-1, nblk * LANES).to(torch.int32)
    return out


def masked_rank_plain(ue: torch.Tensor, items_t: torch.Tensor,
                      sstar: torch.Tensor,
                      maskp: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: materializes the (B, I_pad) f32 scores (bf16
    inputs are widened first, matching f32 accumulation), unpacks the mask
    and counts. Returns (B,) int32."""
    s = ue.float() @ items_t.float()                        # (B, ipad)
    B, ipad = s.shape
    nblk = ipad // I_BLK
    s4 = s.view(B, nblk, PLANES, LANES)
    w = maskp.view(B, nblk, 1, LANES)
    shifts = torch.arange(PLANES, dtype=torch.int32,
                          device=maskp.device).view(1, 1, PLANES, 1)
    bits = ((w >> shifts) & 1) != 0
    gt = s4 > sstar.reshape(B, 1, 1, 1)
    return (bits & gt).sum(dim=(1, 2, 3)).to(torch.int32)


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


@_build.counted
def masked_rank_cuda(ue: torch.Tensor, items: torch.Tensor,
                     sstar: torch.Tensor, maskp: torch.Tensor) -> torch.Tensor:
    """K2: launch ``masked_rank_gather_kernel`` once for the batch; ``items``
    is the row-major ``(I_pad, d)`` table. (B,) int32."""
    if not all(t.is_cuda for t in (ue, items, sstar, maskp)):
        raise ValueError("masked_rank_cuda takes CUDA tensors")
    B, d = ue.shape
    ipad = items.shape[0]
    if items.dim() != 2 or items.shape[1] != d or ipad % I_BLK:
        raise ValueError(f"items must be (I_pad, d={d}) with I_pad a "
                         f"multiple of {I_BLK}, got {tuple(items.shape)}")
    if ue.dtype != items.dtype or ue.dtype not in (torch.float32,
                                                   torch.bfloat16):
        raise ValueError(f"ue/items must both be float32 or bfloat16, got "
                         f"{ue.dtype}/{items.dtype}")
    if tuple(maskp.shape) != (B, ipad // PLANES) or maskp.dtype != torch.int32:
        raise ValueError(f"maskp must be ({B}, {ipad // PLANES}) int32 "
                         f"words, got {tuple(maskp.shape)} {maskp.dtype}")
    if sstar.numel() != B:
        raise ValueError(f"sstar must hold {B} target scores")
    maskp = maskp.contiguous()
    if not _aligned(maskp):
        raise ValueError("maskp must start on a 16-byte boundary")
    ue = ue.contiguous()
    items = items.contiguous()
    sstar = sstar.reshape(B).to(torch.float32).contiguous()
    rank = torch.empty((B,), dtype=torch.int32, device=ue.device)
    lib = _build.load_library()
    with torch.cuda.device(ue.device):
        rc = lib.sml_masked_rank_gather(
            ue.data_ptr(), items.data_ptr(), int(ue.dtype == torch.bfloat16),
            sstar.data_ptr(), maskp.data_ptr(), rank.data_ptr(), B, d,
            items.shape[0], _build.stream_of(ue))
    _build.check(rc, "masked_rank_gather_kernel")
    masked_rank_cuda.launches += 1
    return rank



# P1: the eval-design probe ``scripts/eval_kernel_probe.py`` runs K2's
# function under layout variants. On the card a variant is an instantiation
# of the dense kernel ``masked_rank_kernel``: rows per block (the probe's
# rblk 256/512 become 64/128), grid order ("ij": row tiles on blockIdx.x;
# "ji": item blocks on blockIdx.x) and input type (f32 by CUDA-core FMAs,
# bf16 by tensor-core mma.sync). The probe's dimension_semantics has no
# counterpart (see csrc/eval_kernel.cu).
VARIANT_ROWS_PER_BLOCK = (64, 128)
VARIANT_ORDERS = ("ij", "ji")
VARIANT_K = 16        # the kernel's width step: one bf16 k-step of mma.sync
MAX_SMEM = 232_448    # shared memory one H100 block may opt in to, bytes


def variant_smem_bytes(in_dtype: str, rows_per_block: int, d: int) -> int:
    """Dynamic shared memory of one P1 block (``in_dtype`` "f32" or
    "bf16"), as ``smem_bytes`` in ``csrc/eval_kernel.cu`` asks for it: the
    int32 row counts, then for f32 the k-major user rows and a 2-stage ring
    of d x 128 item tiles, for bf16 the user rows and a 3-stage ring, each
    row padded by 16 bytes."""
    counts = rows_per_block * 4
    if in_dtype == "bf16":
        return counts + (rows_per_block * (d + 8) + 3 * d * 136) * 2
    return counts + d * (rows_per_block + 2 * 128) * 4


def variant_max_d(in_dtype: str, rows_per_block: int) -> int:
    """The widest (padded) d whose tiles fit one block's shared memory."""
    d = VARIANT_K
    while variant_smem_bytes(in_dtype, rows_per_block,
                             d + VARIANT_K) <= MAX_SMEM:
        d += VARIANT_K
    return d


def pad_width(ue: torch.Tensor, items_t: torch.Tensor):
    """``ue`` (B, d) and ``items_t`` (d, I_pad) with zero columns / rows up
    to a multiple of ``VARIANT_K``: each added product is 0, so every f32
    FMA sum and every bf16 ``mma.sync`` sum, and so every rank, is
    unchanged."""
    extra = -ue.shape[1] % VARIANT_K
    if extra == 0:
        return ue, items_t
    return (torch.nn.functional.pad(ue, (0, extra)),
            torch.nn.functional.pad(items_t, (0, 0, 0, extra)))


@_build.counted
def masked_rank_variant_cuda(ue: torch.Tensor, items_t: torch.Tensor,
                             sstar: torch.Tensor, maskp: torch.Tensor,
                             rows_per_block: int = 64,
                             order: str = "ij") -> torch.Tensor:
    """P1: launch one instantiation of ``masked_rank_kernel`` on the
    transposed ``(d, I_pad)`` table, d padded by :func:`pad_width`; (B,)
    int32."""
    if not all(t.is_cuda for t in (ue, items_t, sstar, maskp)):
        raise ValueError("masked_rank_variant_cuda takes CUDA tensors")
    if rows_per_block not in VARIANT_ROWS_PER_BLOCK:
        raise ValueError(f"rows_per_block must be one of "
                         f"{VARIANT_ROWS_PER_BLOCK}, got {rows_per_block}")
    if order not in VARIANT_ORDERS:
        raise ValueError(f"order must be one of {VARIANT_ORDERS}, got "
                         f"{order!r}")
    B, d = ue.shape
    ipad = items_t.shape[1]
    if items_t.shape[0] != d or ipad % I_BLK:
        raise ValueError(f"items_t must be (d={d}, I_pad) with I_pad a "
                         f"multiple of {I_BLK}, got {tuple(items_t.shape)}")
    if ue.dtype != items_t.dtype or ue.dtype not in (torch.float32,
                                                     torch.bfloat16):
        raise ValueError(f"ue/items_t must both be float32 or bfloat16, got "
                         f"{ue.dtype}/{items_t.dtype}")
    if tuple(maskp.shape) != (B, ipad // PLANES) or maskp.dtype != torch.int32:
        raise ValueError(f"maskp must be ({B}, {ipad // PLANES}) int32 "
                         f"words, got {tuple(maskp.shape)} {maskp.dtype}")
    if sstar.numel() != B:
        raise ValueError(f"sstar must hold {B} target scores")
    in_dtype = "bf16" if ue.dtype == torch.bfloat16 else "f32"
    limit = variant_max_d(in_dtype, rows_per_block)
    dp = d + -d % VARIANT_K
    if dp > limit:
        raise ValueError(f"P1's {in_dtype} tiles at {rows_per_block} rows per "
                         f"block hold d <= {limit} in one block's "
                         f"{MAX_SMEM} bytes of shared memory; d={d} pads to "
                         f"{dp}")
    ue, items_t = pad_width(ue, items_t)
    ue = ue.contiguous()
    items_t = items_t.contiguous()
    sstar = sstar.reshape(B).to(torch.float32).contiguous()
    maskp = maskp.contiguous()
    if not all(_aligned(t) for t in (ue, items_t, maskp)):
        raise ValueError("ue, items_t and maskp must start on 16-byte "
                         "boundaries (the kernel copies 16 bytes at a time)")
    rank = torch.zeros((B,), dtype=torch.int32, device=ue.device)
    lib = _build.load_library()
    with torch.cuda.device(ue.device):
        rc = lib.sml_masked_rank(
            ue.data_ptr(), items_t.data_ptr(), int(ue.dtype == torch.bfloat16),
            sstar.data_ptr(), maskp.data_ptr(), rank.data_ptr(),
            B, dp, ipad, rows_per_block, int(order == "ji"),
            _build.stream_of(ue))
    _build.check(rc, "masked_rank_kernel")
    masked_rank_variant_cuda.launches += 1
    return rank



def masked_rank_variant(ue: torch.Tensor, items_t: torch.Tensor,
                        sstar: torch.Tensor, maskp: torch.Tensor,
                        rows_per_block: int = 64,
                        order: str = "ij") -> torch.Tensor:
    """P1's rank counts: one kernel instantiation for tensors on the card,
    the plain version (the same function) for CPU tensors."""
    if ue.is_cuda:
        return masked_rank_variant_cuda(ue, items_t, sstar, maskp,
                                        rows_per_block, order)
    if ue.device.type == "cpu":
        return masked_rank_plain(ue, items_t, sstar, maskp)
    raise ValueError(f"unsupported device {ue.device}")


def masked_rank(ue: torch.Tensor, items: torch.Tensor, sstar: torch.Tensor,
                maskp: torch.Tensor) -> torch.Tensor:
    """Rank counts against the row-major ``(I_pad, d)`` item table: K2 for
    tensors on the card, the plain version (on the transposed view) for
    CPU tensors."""
    if ue.is_cuda:
        return masked_rank_cuda(ue, items, sstar, maskp)
    if ue.device.type == "cpu":
        return masked_rank_plain(ue, items.T, sstar, maskp)
    raise ValueError(f"unsupported device {ue.device}")
