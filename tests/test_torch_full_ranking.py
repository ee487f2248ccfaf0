"""The dense full-catalog top-K with its serving mask
(``eval/full_ranking.py`` ``dense_full_topk``) against
``sml_tpu.eval.full_ranking.dense_full_topk`` on the CPU, on the same numpy
inputs: the additive ``mask_scores`` passed by position (JAX's fourth
parameter) and by keyword, the case where each row's unmasked top-5 is
masked to -inf, and rows with fewer than k finite scores (the port returns
in-range ids there; only the finite entries are compared). Ids equal,
scores within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sml_tpu.eval.full_ranking import dense_full_topk as jax_topk
from sml_tpu_torch.eval.full_ranking import dense_full_topk
from sml_tpu_torch.models.mf import MFParams
from sml_tpu_torch.train.engine import SMLEngine
from sml_tpu_torch.config import SMLConfig, TransferConfig

ATOL = 1e-6


def _tables(rng, b, n_items, d=8):
    return (rng.standard_normal((b, d)).astype(np.float32),
            rng.standard_normal((n_items, d)).astype(np.float32))


def _both(users, items, k, mask, by_keyword):
    tu, ti, tm = map(torch.from_numpy, (users, items, mask))
    if by_keyword:
        got = dense_full_topk(tu, ti, k, mask_scores=tm)
        want = jax_topk(jnp.asarray(users), jnp.asarray(items), k,
                        mask_scores=jnp.asarray(mask))
    else:
        got = dense_full_topk(tu, ti, k, tm)
        want = jax_topk(jnp.asarray(users), jnp.asarray(items), k,
                        jnp.asarray(mask))
    return ([t.numpy() for t in got], [np.asarray(t) for t in want])


@pytest.mark.parametrize("by_keyword", [False, True])
def test_masking_each_rows_top5_matches_jax(rng, by_keyword):
    """2 users, 50 items, k=5: with each row's unmasked top-5 at -inf the
    answer is five other items, JAX's."""
    users, items = _tables(rng, 2, 50)
    top5 = np.argsort(-(users @ items.T), axis=1)[:, :5]
    mask = np.zeros((2, 50), np.float32)
    np.put_along_axis(mask, top5, -np.inf, axis=1)
    (gs, gi), (ws, wi) = _both(users, items, 5, mask, by_keyword)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=ATOL)
    assert not set(gi[0]) & set(top5[0]) and not set(gi[1]) & set(top5[1])
    # without the mask the top-5 comes back
    _, plain = dense_full_topk(torch.from_numpy(users),
                               torch.from_numpy(items), 5)
    assert [set(r) for r in plain.numpy()] == [set(r) for r in top5]


@pytest.mark.parametrize("by_keyword", [False, True])
def test_a_random_additive_mask_matches_jax(rng, by_keyword):
    users, items = _tables(rng, 16, 300)
    mask = np.where(rng.random((16, 300)) < 0.3, -np.inf,
                    0.5 * rng.standard_normal((16, 300))).astype(np.float32)
    (gs, gi), (ws, wi) = _both(users, items, 10, mask, by_keyword)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=ATOL)


def test_rows_with_fewer_than_k_finite_scores(rng):
    """Row 0 keeps 3 finite items, row 1 none, row 2 all: the port's ids
    stay in range; the finite entries equal JAX's."""
    users, items = _tables(rng, 3, 40)
    mask = np.zeros((3, 40), np.float32)
    mask[0] = -np.inf
    mask[0, [4, 17, 33]] = 0.0
    mask[1] = -np.inf
    (gs, gi), (ws, wi) = _both(users, items, 5, mask, False)
    assert ((gi >= 0) & (gi < 40)).all()
    finite = np.isfinite(ws)
    assert finite.sum(axis=1).tolist() == [3, 0, 5]
    np.testing.assert_array_equal(np.isfinite(gs), finite)
    np.testing.assert_array_equal(gi[finite], wi[finite])
    np.testing.assert_allclose(gs[finite], ws[finite], rtol=0, atol=ATOL)
    assert set(gi[0, :3]) == {4, 17, 33}


def test_serve_topk_passes_its_options_by_keyword(rng):
    """``SMLEngine.serve_topk`` rounds the product's inputs to its
    ``compute_dtype``, the dense path's result with that keyword."""
    users, items = _tables(rng, 40, 30)
    cfg = SMLConfig(latent_dim=8, transfer=TransferConfig(latent_dim=8))
    eng = SMLEngine(cfg, 40, 30, device="cpu")
    mf = MFParams(torch.from_numpy(users), torch.from_numpy(items),
                  torch.zeros(40, 1), torch.zeros(30, 1))
    ids = torch.arange(0, 40, 3)
    got = eng.serve_topk(mf, ids, 4, compute_dtype=torch.bfloat16)
    want = dense_full_topk(mf.user_emb[ids], mf.item_emb, 4,
                           compute_dtype=torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    exact = dense_full_topk(mf.user_emb[ids], mf.item_emb, 4)
    assert not torch.equal(got[0], exact[0])
