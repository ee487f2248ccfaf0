"""The port's packed masks and masked rank (K2's plain path) against JAX.

Masks must be word-for-word equal to ``sml_tpu``'s ``build_packed_mask``
(both its ``mxu`` and ``compare`` methods). Ranks must be exactly equal on
integer-valued tables, where every score is exact whatever the summation
order (the construction of ``tests/test_eval_scoring.py``), against both
``masked_rank_xla`` and the Pallas kernel in interpret mode. The port's
``masked_rank`` takes the row-major ``(I_pad, d)`` table, the JAX functions
the transposed ``(d, I_pad)`` one: each comparison hands both the same
values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sml_tpu.ops import eval_kernel as JE
from sml_tpu_torch.ops import eval_kernel as E


def _negs(rng, rows, n_items, c):
    return np.stack([rng.permutation(n_items)[:c]
                     for _ in range(rows)]).astype(np.int32)


def _port_mask(neg, n_items):
    return E.build_packed_mask(torch.from_numpy(neg), n_items).numpy()


@pytest.mark.parametrize("method", ["mxu", "compare"])
@pytest.mark.parametrize("n_items", [50, 300, 5000, 8192])
def test_packed_mask_matches_jax_words(n_items, method):
    rng = np.random.default_rng(5)
    neg = _negs(rng, 64, n_items, min(40, n_items))
    want = np.asarray(jax.jit(
        lambda x: JE.build_packed_mask(x, n_items, method=method))(
        jnp.asarray(neg)))
    got = _port_mask(neg, n_items)
    assert want.dtype == np.uint32 and got.dtype == np.int32
    np.testing.assert_array_equal(got.view(np.uint32), want)


def test_packed_mask_sets_repeated_ids_once():
    rng = np.random.default_rng(6)
    neg = _negs(rng, 32, 5000, 30)
    neg[:, 10:20] = neg[:, :10]          # every row repeats ten ids
    want = np.asarray(JE.build_packed_mask(jnp.asarray(neg), 5000))
    np.testing.assert_array_equal(_port_mask(neg, 5000).view(np.uint32),
                                  want)


def test_packed_mask_chunks_rows():
    rng = np.random.default_rng(7)
    neg = _negs(rng, 100, 4500, 25)
    full = _port_mask(neg, 4500)
    chunked = E.build_packed_mask(torch.from_numpy(neg), 4500,
                                  row_chunk=32).numpy()
    np.testing.assert_array_equal(full, chunked)


@pytest.mark.parametrize("n_items", [1, 4096, 4097, 20000])
def test_padding_matches_jax(n_items):
    assert E.pad_items(n_items) == JE.pad_items(n_items)
    assert E.mask_words(n_items) == JE.mask_words(n_items)


def _int_case(rng, rows, n_items, d, c):
    ipad = E.pad_items(n_items)
    ue = rng.integers(-2, 3, (rows, d)).astype(np.float32)
    it = np.zeros((d, ipad), np.float32)
    it[:, :n_items] = rng.integers(-2, 3, (d, n_items))
    ss = rng.integers(-5, 6, (rows, 1)).astype(np.float32)
    neg = _negs(rng, rows, n_items, c)
    mask = np.asarray(JE.build_packed_mask(jnp.asarray(neg), n_items))
    return ue, it, ss, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_items,d", [(300, 16), (5000, 16), (9000, 8)])
def test_masked_rank_exact_vs_jax(n_items, d, dtype):
    from jax.experimental.pallas import tpu as pltpu

    rng = np.random.default_rng(11)
    ue, it, ss, mask = _int_case(rng, 64, n_items, d, min(60, n_items))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    args = (jnp.asarray(ue, jdt), jnp.asarray(it, jdt), jnp.asarray(ss),
            jnp.asarray(mask))
    want_xla = np.asarray(JE.masked_rank_xla(*args))
    with pltpu.force_tpu_interpret_mode():
        want_pallas = np.asarray(JE.masked_rank_pallas(*args,
                                                       interpret=True))
    got = E.masked_rank(torch.from_numpy(ue).to(tdt),
                        torch.from_numpy(it).to(tdt).T,
                        torch.from_numpy(ss),
                        torch.from_numpy(mask.view(np.int32).copy()))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want_xla)
    np.testing.assert_array_equal(got.numpy(), want_pallas)
    assert want_xla.max() > 0


def _edge_mask(case, rows, n_items):
    """(rows, mask_words) uint32 masks of one shape: no bit set, every item
    below ``n_items`` set, or all 32 bits of one word (items 37 + 128k)."""
    if case == "empty":
        neg = np.zeros((rows, 0), np.int32)
    elif case == "full":
        neg = np.tile(np.arange(n_items, dtype=np.int32), (rows, 1))
    else:
        neg = np.tile(37 + 128 * np.arange(32, dtype=np.int32), (rows, 1))
    if neg.shape[1] == 0:
        return np.zeros((rows, JE.mask_words(n_items)), np.uint32)
    return np.asarray(JE.build_packed_mask(jnp.asarray(neg), n_items))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["empty", "full", "one_word"])
def test_masked_rank_edge_masks_exact_vs_jax(case, dtype):
    from jax.experimental.pallas import tpu as pltpu

    rng = np.random.default_rng(13)
    rows, n_items, d = 24, 5000, 16
    ue, it, ss, _ = _int_case(rng, rows, n_items, d, 1)
    mask = _edge_mask(case, rows, n_items)
    assert int(np.unpackbits(mask.view(np.uint8)).sum()) == rows * {
        "empty": 0, "full": n_items, "one_word": 32}[case]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    args = (jnp.asarray(ue, jdt), jnp.asarray(it, jdt), jnp.asarray(ss),
            jnp.asarray(mask))
    want_xla = np.asarray(JE.masked_rank_xla(*args))
    with pltpu.force_tpu_interpret_mode():
        want_pallas = np.asarray(JE.masked_rank_pallas(*args,
                                                       interpret=True))
    got = E.masked_rank(torch.from_numpy(ue).to(tdt),
                        torch.from_numpy(np.ascontiguousarray(it.T)).to(tdt),
                        torch.from_numpy(ss),
                        torch.from_numpy(mask.view(np.int32).copy()))
    np.testing.assert_array_equal(got.numpy(), want_xla)
    np.testing.assert_array_equal(got.numpy(), want_pallas)
    if case == "empty":
        assert not got.any()
    else:
        assert got.max() > 0


def test_masked_rank_counts_only_masked_strictly_greater():
    """Hand-built case: item scores 0..I-1, target score 10; the mask
    holds items {5, 10, 11, 4200}: only 11 and 4200 beat the target
    strictly."""
    n_items = 5000
    ipad = E.pad_items(n_items)
    it = torch.zeros((1, ipad))
    it[0, :n_items] = torch.arange(n_items, dtype=torch.float32)
    mask = E.build_packed_mask(torch.tensor([[5, 10, 11, 4200]]), n_items)
    rank = E.masked_rank(torch.ones((1, 1)), it.T, torch.tensor([[10.0]]),
                         mask)
    assert rank.tolist() == [2]


def test_cuda_wrapper_refuses_cpu_tensors():
    x = torch.zeros((2, 4))
    with pytest.raises(ValueError, match="CUDA"):
        E.masked_rank_cuda(x, torch.zeros((4096, 4)), torch.zeros((2, 1)),
                           torch.zeros((2, 128), dtype=torch.int32))
