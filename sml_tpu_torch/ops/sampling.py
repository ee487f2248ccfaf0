"""Negative sampling on the device (counterpart of ``sml_tpu/ops/sampling.py``).

The reference's ``'alone'`` sampler draws uniformly from the period's
unique items until the draw is not among the user's positives in that
period. Here, as in the JAX package, it is a bounded-retry sampler:

1. on the host, once per period: the unique-item pool, the sorted 32-bit
   (user, item) pair hashes and a 2-probe bloom filter over them
   (:func:`build_period_index`, numpy, bit for bit the JAX package's);
2. on the device, per batch: ``tries`` candidates per row, a bloom probe
   each, and the first candidate the bloom does not flag; if all are
   flagged, the last draw (:func:`sample_negatives`).

The pair hash is uint32 arithmetic. PyTorch has little uint32 support, so
the device side emulates it in int64: every value stays in ``[0, 2**32)``
and each 32x32-bit product is formed from 16-bit halves, so nothing
overflows int64 and the low 32 bits are exact. The sorted hashes are kept
in int64: as int32 every hash >= 2**31 would turn negative and
``searchsorted`` would search an unsorted array.

Membership is exact for true positives (a positive's hash is always
present); a collision can only reject a valid negative. The random draws
come from a ``torch.Generator``, so they differ from the JAX package's
draws while the contract (pool items, first non-positive, last draw on
fallback) is the same.

As in the JAX package, the per-period values ``pool_size`` and
``bloom_mask`` are 0-d device tensors, not host ints: a CUDA graph that
captured a sampled step (``train/graphs.py``) then reads each period's
values. A pool slot is one 32-bit draw (``randint(0, 2**32 - 1)``)
reduced modulo the pool size, so the draw takes no host bound; like
``randint(0, pool_size)`` it takes one 32-bit value per candidate (the
same Philox offsets on the card), and its modulo bias is below pool size /
2**32. :func:`draw_offset` gives the Philox offset one draw reserves on a
CUDA generator, which the eager epochs skip for the steps they do not
run.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from sml_tpu_torch.device import resolve_device

_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_M3 = 0x27D4EB2F
_BLOOM_MUL = 0x9E3779B1
_U32 = 0xFFFFFFFF

# bloom sizing: ~16 bits per key with 2 probes -> ~1.4% false positives,
# each of which only over-rejects a valid negative
_BLOOM_BITS_PER_KEY = 16


def _hash_pair_np(u: np.ndarray, i: np.ndarray) -> np.ndarray:
    """Mix a (user, item) pair into a uint32 key (host side)."""
    with np.errstate(over="ignore"):
        u = u.astype(np.uint32)
        i = i.astype(np.uint32)
        h = u * np.uint32(_M1)
        h ^= h >> np.uint32(13)
        h ^= i * np.uint32(_M2)
        h *= np.uint32(_M3)
        h ^= h >> np.uint32(15)
    return h


def _bloom_second_hash_np(h: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        return (h * np.uint32(_BLOOM_MUL)) ^ (h >> np.uint32(16))


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2**32`` for int64 ``a`` in [0, 2**32) and a 32-bit
    constant ``c``, from 16-bit halves of ``c`` (no product above 2**49)."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _hash_pair_torch(u: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """:func:`_hash_pair_np` on the device: int64 values in [0, 2**32)."""
    u = u.long() & _U32
    i = i.long() & _U32
    h = _mul32(u, _M1)
    h = h ^ (h >> 13)
    h = h ^ _mul32(i, _M2)
    h = _mul32(h, _M3)
    return h ^ (h >> 15)


def _bloom_second_hash_torch(h: torch.Tensor) -> torch.Tensor:
    return _mul32(h, _BLOOM_MUL) ^ (h >> 16)


class PeriodIndex(NamedTuple):
    """Per-period sampling index (device tensors, padded)."""
    item_pool: torch.Tensor   # (P,) int64 unique items, padded by repeating
    pool_size: torch.Tensor   # () int64 true number of unique items
    pos_hashes: torch.Tensor  # (K,) int64 sorted uint32 pair hashes, pad MAX
    bloom: torch.Tensor       # (M/32,) int64 holding uint32 bloom words
    bloom_mask: torch.Tensor  # () int64, M - 1 (M = a power-of-two bit count)


def build_period_index(interactions: np.ndarray, n_items: int,
                       pad_to_multiple: int = 1024, min_rows: int = 0,
                       device="cuda") -> PeriodIndex:
    """The sampling index for one period's ``[user, item]`` rows.

    ``min_rows`` (a sweep-wide row-count bound) floors the padded lengths
    and the bloom size, exactly as in the JAX package, so the arrays equal
    its arrays element for element."""
    device = resolve_device(device)
    users = interactions[:, 0]
    items = interactions[:, 1]
    if items.max(initial=0) >= n_items:
        raise ValueError(f"item id {int(items.max())} >= n_items {n_items}")
    pool = np.unique(items)
    psize = int(pool.shape[0])
    pfloor = max(psize, min(min_rows, n_items))
    ppad = -(-pfloor // pad_to_multiple) * pad_to_multiple
    pool_padded = np.concatenate(
        [pool, np.full(ppad - psize, pool[0], dtype=pool.dtype)])

    hashes = np.unique(_hash_pair_np(users, items))
    kfloor = max(hashes.shape[0], min_rows)
    kpad = -(-kfloor // pad_to_multiple) * pad_to_multiple
    hashes_padded = np.concatenate(
        [hashes, np.full(kpad - hashes.shape[0], np.uint32(_U32))])

    m_bits = 1024
    while m_bits < _BLOOM_BITS_PER_KEY * max(hashes.shape[0], min_rows):
        m_bits <<= 1
    mask = np.uint32(m_bits - 1)
    words = np.zeros(m_bits // 32, dtype=np.uint32)
    with np.errstate(over="ignore"):
        for pos in (hashes & mask, _bloom_second_hash_np(hashes) & mask):
            np.bitwise_or.at(words, pos >> 5,
                             np.uint32(1) << (pos & np.uint32(31)))

    def up(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(device)
    return PeriodIndex(item_pool=up(pool_padded), pool_size=up(psize),
                       pos_hashes=up(hashes_padded), bloom=up(words),
                       bloom_mask=up(mask))


def maybe_positive(index: PeriodIndex, users: torch.Tensor,
                   items: torch.Tensor) -> torch.Tensor:
    """Bloom membership: True for every true positive, plus ~1.4% false
    positives; two word reads per query."""
    h = _hash_pair_torch(users, items)
    hit = None
    for probe in (h, _bloom_second_hash_torch(h)):
        b = probe & index.bloom_mask
        bit = (index.bloom[b >> 5] >> (b & 31)) & 1
        hit = bit if hit is None else (hit & bit)
    return hit == 1


def is_positive(index: PeriodIndex, users: torch.Tensor,
                items: torch.Tensor) -> torch.Tensor:
    """Exact membership of (user, item) in the period's positives, any
    broadcast shape; false positives only on a 32-bit hash collision."""
    key = _hash_pair_torch(users, items)
    loc = torch.searchsorted(index.pos_hashes, key.contiguous())
    loc = torch.clamp(loc, 0, index.pos_hashes.shape[0] - 1)
    return index.pos_hashes[loc] == key


_DRAW_HIGH = (1 << 32) - 1


def pool_draws(index: PeriodIndex, shape, generator: torch.Generator
               ) -> torch.Tensor:
    """Uniform pool slots in ``[0, pool_size)``, int64 of ``shape``, on the
    index's device: one random op whatever the period's pool size."""
    return torch.randint(0, _DRAW_HIGH, tuple(shape), generator=generator,
                         device=index.item_pool.device) % index.pool_size


_DRAW_OFFSETS: Dict[Tuple, int] = {}


def draw_offset(rows: int, tries: int, device) -> int:
    """The Philox offset that one :func:`sample_negatives` call on ``rows``
    users reserves on a CUDA generator of ``device`` (it depends on the
    shape alone)."""
    return _reserved_offset(
        ("draw", rows, tries), device,
        lambda gen, dev: torch.randint(0, _DRAW_HIGH, (rows, tries),
                                       generator=gen, device=dev))


def rand_offset(n: int, device) -> int:
    """The Philox offset that ``torch.rand(n)`` reserves on a CUDA
    generator of ``device``."""
    return _reserved_offset(
        ("rand", n), device,
        lambda gen, dev: torch.rand(n, generator=gen, device=dev))


def _reserved_offset(key: tuple, device, draw) -> int:
    """The Philox offset ``draw(generator, device)`` reserves, measured
    once per device on a scratch generator."""
    device = torch.device(device)
    key = (device.index, *key)
    if key not in _DRAW_OFFSETS:
        gen = torch.Generator(device=device).manual_seed(0)
        start = gen.get_offset()
        draw(gen, device)
        _DRAW_OFFSETS[key] = gen.get_offset() - start
    return _DRAW_OFFSETS[key]


def _draw_negatives(index: PeriodIndex, users: torch.Tensor,
                    generator: torch.Generator, tries: int):
    """``(picked, all_pos)``: the first candidate the bloom does not flag
    (the last draw where it flags all), and the fallback rows."""
    draws = pool_draws(index, (users.shape[0], tries), generator)
    cands = index.item_pool[draws]                            # (B, T)
    pos = maybe_positive(index, users[:, None], cands)        # (B, T)
    first_ok = torch.argmax((~pos).to(torch.int32), dim=1)
    all_pos = pos.all(dim=1)
    pick = torch.where(all_pos, torch.full_like(first_ok, tries - 1),
                       first_ok)
    return cands.gather(1, pick[:, None])[:, 0], all_pos


def sample_negatives(index: PeriodIndex, users: torch.Tensor,
                     generator: torch.Generator,
                     tries: int = 16) -> torch.Tensor:
    """One negative item per user, drawn from ``generator`` (on the users'
    device); (B,) int64 items from the period pool."""
    return _draw_negatives(index, users, generator, tries)[0]


def sampler_stats(index: PeriodIndex, users: torch.Tensor,
                  generator: torch.Generator, tries: int = 16):
    """Quality of :func:`sample_negatives` over one draw per row:
    ``(fallback_rate, leak_rate)`` as 0-d f32 tensors. ``fallback_rate``:
    rows whose every candidate hit the bloom; ``leak_rate``: returned
    samples that are true positives (exact membership)."""
    picked, all_pos = _draw_negatives(index, users, generator, tries)
    leak = is_positive(index, users, picked)
    return (all_pos.to(torch.float32).mean(),
            leak.to(torch.float32).mean())
