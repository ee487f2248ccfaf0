"""Negative sampling and epoch batching against the JAX package.

* The pair hash, ``build_period_index`` and both membership tests are bit
  for bit ``sml_tpu.ops.sampling``'s, on ids spanning the full uint32
  range (the port emulates uint32 in int64).
* The sampler is held to its contract only (pool items, the first
  candidate the bloom does not flag, the last draw on fallback): the two
  packages' random generators differ by design.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sml_tpu.ops import sampling as JS
from sml_tpu_torch.ops import sampling as S
from sml_tpu_torch.ops.batching import num_batches, shuffle_real_first
from sml_tpu_torch.train.steps import _epoch_triples

U32_EDGES = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1],
                     dtype=np.uint64)


def _ids(rng, n):
    return np.concatenate([U32_EDGES, rng.integers(0, 2**32, n,
                                                   dtype=np.uint64)])


def test_hash_matches_jax_on_full_uint32_range(rng):
    u, i = _ids(rng, 5000), _ids(rng, 5000)[::-1].copy()
    want_np = JS._hash_pair_np(u, i)
    want_jnp = np.asarray(JS._hash_pair_jnp(jnp.asarray(u.astype(np.uint32)),
                                            jnp.asarray(i.astype(np.uint32))))
    np.testing.assert_array_equal(want_np, want_jnp)
    np.testing.assert_array_equal(S._hash_pair_np(u, i), want_np)
    got = S._hash_pair_torch(torch.from_numpy(u.astype(np.int64)),
                             torch.from_numpy(i.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want_np.astype(np.int64))
    h = torch.from_numpy(want_np.astype(np.int64))
    np.testing.assert_array_equal(
        S._bloom_second_hash_torch(h).numpy(),
        JS._bloom_second_hash(want_np).astype(np.int64))


@pytest.mark.parametrize("min_rows", [0, 5000])
def test_period_index_and_membership_match_jax(rng, min_rows):
    n_items = 3000
    users = _ids(rng, 2500)
    inter = np.stack([users, rng.integers(0, n_items, users.shape[0])],
                     axis=1)
    jidx = JS.build_period_index(inter, n_items, min_rows=min_rows)
    tidx = S.build_period_index(inter, n_items, min_rows=min_rows,
                                device="cpu")
    np.testing.assert_array_equal(tidx.item_pool.numpy(),
                                  np.asarray(jidx.item_pool))
    assert tidx.pool_size == int(jidx.pool_size)
    np.testing.assert_array_equal(
        tidx.pos_hashes.numpy(),
        np.asarray(jidx.pos_hashes).astype(np.int64))
    assert np.all(np.diff(tidx.pos_hashes.numpy()) >= 0)   # sorted
    np.testing.assert_array_equal(tidx.bloom.numpy(),
                                  np.asarray(jidx.bloom).astype(np.int64))
    assert tidx.bloom_mask == int(jidx.bloom_mask)
    # queries: every positive plus random pairs
    qu = np.concatenate([inter[:, 0], _ids(rng, 3000)])
    qi = np.concatenate([inter[:, 1], rng.integers(0, n_items, 3006)])
    tu = torch.from_numpy(qu.astype(np.int64))
    ti = torch.from_numpy(qi.astype(np.int64))
    ju = jnp.asarray(qu.astype(np.uint32))
    ji = jnp.asarray(qi.astype(np.int32))
    np.testing.assert_array_equal(S.is_positive(tidx, tu, ti).numpy(),
                                  np.asarray(JS.is_positive(jidx, ju, ji)))
    np.testing.assert_array_equal(S.maybe_positive(tidx, tu, ti).numpy(),
                                  np.asarray(JS.maybe_positive(jidx, ju, ji)))
    assert S.is_positive(tidx, tu, ti)[:inter.shape[0]].all()


def test_sampler_contract(rng):
    n_users, n_items = 40, 30
    inter = np.unique(np.stack([rng.integers(0, n_users, 400),
                                rng.integers(0, n_items, 400)], 1), axis=0)
    idx = S.build_period_index(inter, n_items, device="cpu")
    users = torch.from_numpy(rng.integers(0, n_users, 2000))
    gen = torch.Generator().manual_seed(0)
    picked = S.sample_negatives(idx, users, gen, tries=16)
    pool = set(np.unique(inter[:, 1]).tolist())
    assert set(picked.tolist()) <= pool
    # same generator state -> the same draws, and the pick is the first
    # candidate the bloom does not flag, else the last draw
    gen2 = torch.Generator().manual_seed(0)
    draws = torch.randint(0, idx.pool_size, (2000, 16), generator=gen2)
    cands = idx.item_pool[draws]
    flagged = S.maybe_positive(idx, users[:, None], cands)
    for r in range(2000):
        ok = (~flagged[r]).nonzero()
        want = cands[r, ok[0, 0]] if ok.numel() else cands[r, -1]
        assert picked[r] == want
    fb, leak = S.sampler_stats(idx, users, torch.Generator().manual_seed(1))
    assert 0.0 <= float(fb) <= 1.0 and 0.0 <= float(leak) <= float(fb)
    # a user whose every pool item is positive falls back to the last draw
    full = np.stack([np.zeros(n_items, np.int64), np.arange(n_items)], 1)
    fidx = S.build_period_index(full, n_items, device="cpu")
    z = torch.zeros(64, dtype=torch.int64)
    g3 = torch.Generator().manual_seed(3)
    last = fidx.item_pool[torch.randint(0, fidx.pool_size, (64, 4),
                                        generator=g3)][:, -1]
    got = S.sample_negatives(fidx, z, torch.Generator().manual_seed(3), 4)
    assert torch.equal(got, last)


def test_shuffle_keeps_padding_at_the_tail_and_counts_steps():
    rows = torch.arange(40).reshape(20, 2)
    mask = torch.zeros(20)
    mask[:13] = 1.0
    r, m = shuffle_real_first(torch.Generator().manual_seed(5), rows, mask)
    assert m[:13].all() and not m[13:].any()
    assert sorted(r[:13, 0].tolist()) == list(range(0, 26, 2))
    assert num_batches(13, 4) == 4 and num_batches(16, 4) == 4
    assert num_batches(0, 4) == 0


def test_all_mode_draws_one_negative_column_per_epoch(rng):
    rows = torch.from_numpy(rng.integers(0, 1000, (50, 2 + 9)))
    gen = torch.Generator().manual_seed(2)
    got = _epoch_triples(rows, gen, "all")
    col = torch.randint(0, 9, (1,),
                        generator=torch.Generator().manual_seed(2)).item()
    assert torch.equal(got, rows[:, [0, 1, 2 + col]])
    assert torch.equal(_epoch_triples(rows[:, :3], gen, "replay"),
                       rows[:, :3])
