"""The port's evaluator, metrics and batching against the JAX package.

Every scoring mode of ``make_eval_fn`` runs in both packages on the same
eval rows. On integer-valued tables every candidate score is exact, so hit
sums must be equal and NDCG sums agree to 1e-4 (f32 accumulation order).
On random float tables scores differ by f32 rounding, so hit sums may move
by one rank flip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sml_tpu.eval import evaluator as JEV
from sml_tpu.models.mf import MFParams as JaxMF
from sml_tpu.ops import batching as JB
from sml_tpu.ops import eval_kernel as JE
from sml_tpu.ops import metrics as JM
from sml_tpu_torch.eval import evaluator as EV
from sml_tpu_torch.models.mf import MFParams
from sml_tpu_torch.ops import batching as B
from sml_tpu_torch.ops import eval_kernel as E
from sml_tpu_torch.ops import metrics as M

TOPKS = (5, 10, 20)


def _case(rng, users, items, dim, cands, rows_n, integer):
    if integer:
        ue = rng.integers(-2, 3, (users, dim)).astype(np.float32)
        ie = rng.integers(-2, 3, (items, dim)).astype(np.float32)
    else:
        ue = rng.normal(size=(users, dim)).astype(np.float32)
        ie = rng.normal(size=(items, dim)).astype(np.float32)
    cand = np.stack([rng.permutation(items)[:cands + 1]
                     for _ in range(rows_n)])
    rows = np.concatenate([rng.integers(0, users, (rows_n, 1)), cand],
                          axis=1).astype(np.int32)
    mask = np.ones(rows_n, np.float32)
    mask[-5:] = 0.0
    return ue, ie, rows, mask


def _run_both(mode, ue, ie, rows, mask, with_mask, bs=32):
    n_items = ie.shape[0]
    jmf = JaxMF(jnp.asarray(ue), jnp.asarray(ie),
                jnp.zeros((ue.shape[0], 1)), jnp.zeros((n_items, 1)))
    tmf = MFParams(torch.from_numpy(ue), torch.from_numpy(ie),
                   torch.zeros(ue.shape[0], 1), torch.zeros(n_items, 1))
    jcm = tcm = None
    if with_mask:
        jcm = JE.build_packed_mask(jnp.asarray(rows[:, 2:]), n_items)
        tcm = E.build_packed_mask(torch.from_numpy(rows[:, 2:]), n_items)
    want = jax.jit(JEV.make_eval_fn(TOPKS, bs, scoring=mode))(
        jmf, jnp.asarray(rows), jnp.asarray(mask), jcm)
    got = EV.make_eval_fn(TOPKS, bs, scoring=mode)(
        tmf, torch.from_numpy(rows), torch.from_numpy(mask), tcm)
    return ({k: (float(h), float(n)) for k, (h, n) in want.items()},
            {k: (float(h), float(n)) for k, (h, n) in got.items()})


@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("mode", EV.SCORING_MODES)
def test_modes_equal_jax_on_integer_tables(mode, with_mask):
    rng = np.random.default_rng(11)
    ue, ie, rows, mask = _case(rng, 400, 300, 16, 60, 128, integer=True)
    want, got = _run_both(mode, ue, ie, rows, mask, with_mask)
    for k in TOPKS:
        assert got[k][0] == want[k][0], (mode, k, got[k], want[k])
        assert abs(got[k][1] - want[k][1]) < 1e-4, (mode, k)
    assert want[20][0] > 0


@pytest.mark.parametrize("mode", ["gather", "matmul", "masked",
                                  "masked_bf16", "gather_bf16"])
def test_modes_within_one_flip_on_random_tables(mode):
    rng = np.random.default_rng(12)
    ue, ie, rows, mask = _case(rng, 300, 5000, 16, 99, 256, integer=False)
    want, got = _run_both(mode, ue, ie, rows, mask, with_mask=True, bs=64)
    for k in TOPKS:
        assert abs(got[k][0] - want[k][0]) <= 1, (mode, k, got[k], want[k])
        assert abs(got[k][1] - want[k][1]) <= 1.0, (mode, k)


def test_resolve_mode_matches_jax():
    for mode in EV.SCORING_MODES:
        for has_mask in (True, False):
            assert EV._resolve_mode(mode, 1000, 100, has_mask) == \
                JEV._resolve_mode(mode, 1000, 100, has_mask)
    with pytest.raises(ValueError):
        EV._resolve_mode("nope", 10, 10, has_mask=False)


def test_rank_and_hits_match_jax(rng):
    scores = rng.normal(size=(64, 31)).astype(np.float32)
    scores[:4, 1:] = scores[:4, :1]        # ties go to the target
    r_j = np.asarray(JM.rank_of_target(jnp.asarray(scores)))
    r_t = M.rank_of_target(torch.from_numpy(scores))
    np.testing.assert_array_equal(r_t.numpy(), r_j)
    assert r_t[:4].tolist() == [0, 0, 0, 0]
    mask = (rng.random(64) > 0.2).astype(np.float32)
    hj = JM.hits_and_ndcg_at(jnp.asarray(r_j), jnp.asarray(mask), TOPKS)
    ht = M.hits_and_ndcg_at(r_t, torch.from_numpy(mask), TOPKS)
    for k in TOPKS:
        assert float(ht[k][0]) == float(hj[k][0])
        assert abs(float(ht[k][1]) - float(hj[k][1])) < 1e-5


@pytest.mark.parametrize("drop_last", [True, False])
def test_weighted_period_average_matches_jax(rng, drop_last):
    values = rng.random((9, 3))
    counts = rng.integers(10, 100, 9)
    want = JM.weighted_period_average(values, counts,
                                      drop_last_test=drop_last)
    got = M.weighted_period_average(values, counts, drop_last_test=drop_last)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-12)


def test_ranklist_metrics_match_jax(rng):
    for n_targets in (1, 3, 7):
        ranklist = rng.permutation(20)[:10]
        jr, tr = jnp.asarray(ranklist), torch.from_numpy(ranklist)
        pairs = [
            (JM.hit_count(jr, n_targets), M.hit_count(tr, n_targets)),
            (JM.precision_at(jr, n_targets, 10),
             M.precision_at(tr, n_targets, 10)),
            (JM.recall_at(jr, n_targets), M.recall_at(tr, n_targets)),
            (JM.ndcg(jr, n_targets), M.ndcg(tr, n_targets)),
            (JM.mrr(jr, n_targets), M.mrr(tr, n_targets)),
            (JM.average_precision(jr, n_targets),
             M.average_precision(tr, n_targets)),
            (JM.idcg(n_targets), M.idcg(n_targets)),
        ] + list(zip(JM.rec_ndcg(jr, n_targets), M.rec_ndcg(tr, n_targets)))
        for j, t in pairs:
            assert abs(float(t) - float(j)) < 1e-6, (n_targets, j, t)


def test_bucket_rows_matches_jax():
    for n in [0, 1, 7, 64, 1000, 1025, 5000, 16384, 99_999, 1_000_003]:
        for mult in (32, 256, 1024):
            assert B.bucket_rows(n, mult) == JB.bucket_rows(n, mult), (n,
                                                                      mult)


@pytest.mark.parametrize("n,pad_to", [(100, 0), (1500, 0), (300, 5000)])
def test_pad_rows_matches_jax(rng, n, pad_to):
    arr = rng.integers(0, 70000, (n, 12))
    want = JB.pad_rows(arr, 256, pad_to=pad_to)
    got = B.pad_rows(arr, 256, pad_to=pad_to, device="cpu")
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert got.n_real == want.n_real == n and got.cand_mask is None
    assert got.rows.dtype == torch.int32
