"""The baselines (full retrain, fine-tune, SPMF) and the attributed
evaluator against the JAX package.

Reservoir draws, rank-softmax probabilities, the inverse-CDF draw, one SPMF
step and the attributed evaluator are compared on identical inputs. Whole
``BaselineDriver`` runs are compared by contract only (record kinds, keys
and periods; metrics in [0, 1]): the two packages' random streams differ by
design.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sml_tpu.train.baselines as jbase
import sml_tpu_torch.train.baselines as tbase
from sml_tpu.config import BaselineConfig as JaxBaselineConfig
from sml_tpu.eval.evaluator import make_attributed_eval_fn as jax_attr_fn
from sml_tpu.models.mf import MFParams as JaxMF
from sml_tpu.ops.eval_kernel import build_packed_mask as jax_packed_mask
from sml_tpu.train.optim import torch_adam
from sml_tpu_torch.config import BaselineConfig
from sml_tpu_torch.eval.evaluator import make_attributed_eval_fn
from sml_tpu_torch.models.mf import MFParams
from sml_tpu_torch.ops import adam_kernel, eval_kernel
from sml_tpu_torch.ops.eval_kernel import build_packed_mask
from sml_tpu_torch.train.optim import adam_init

TOL = dict(rtol=1e-5, atol=1e-5)


def _mf(rng, n_users, n_items, d, integer=False):
    def draw(shape):
        if integer:
            return rng.integers(-2, 3, shape).astype(np.float32)
        return rng.standard_normal(shape).astype(np.float32)
    return [draw(s) for s in ((n_users, d), (n_items, d), (n_users, 1),
                              (n_items, 1))]


def _both(tables):
    return (JaxMF(*map(jnp.asarray, tables)),
            MFParams(*(torch.from_numpy(t.copy()) for t in tables)))


def test_reservoir_matches_jax():
    rng = np.random.default_rng(31)
    chunks = [rng.integers(0, 100, (n, 2)) for n in (7, 30, 1, 55, 0, 80)]
    for length, init in ((0, False), (20, False), (20, True), (500, False)):
        j = jbase.Reservoir(length, np.random.default_rng(5))
        t = tbase.Reservoir(length, np.random.default_rng(5))
        if init:
            j.init_pool(chunks[3])
            t.init_pool(chunks[3])
        for c in chunks:
            j.update(c)
            t.update(c)
            np.testing.assert_array_equal(t.pool, j.pool)
            assert (t.pool_have, t.t) == (j.pool_have, j.t)


@pytest.mark.parametrize("padded", [False, True])
def test_rank_sampling_probs_match_jax(padded):
    rng = np.random.default_rng(32)
    n_users, n_items, d, n = 40, 30, 4, 200
    jmf, tmf = _both(_mf(rng, n_users, n_items, d))
    pairs = np.stack([rng.integers(0, n_users, n),
                      rng.integers(0, n_items, n)], axis=1)
    # keep only pairs whose scores are well separated (no near-ties, so
    # both sorts give one order)
    s = (tmf.user_emb[pairs[:, 0]] * tmf.item_emb[pairs[:, 1]]).sum(1).numpy()
    order = np.argsort(s)
    keep = np.ones(n, bool)
    keep[order[1:][np.diff(s[order]) < 1e-3]] = False
    pairs = pairs[keep]
    kw_j, kw_t = {}, {}
    if padded:
        n_real = pairs.shape[0] - 17
        valid = np.arange(pairs.shape[0]) < n_real
        kw_j = dict(valid=jnp.asarray(valid), n_real=jnp.int32(n_real))
        kw_t = dict(valid=torch.from_numpy(valid), n_real=n_real)
    want = np.asarray(jbase.rank_sampling_probs(
        jmf, jnp.asarray(pairs, jnp.int32), **kw_j))
    got = tbase.rank_sampling_probs(tmf, torch.from_numpy(pairs), **kw_t)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert abs(float(got.sum()) - 1.0) < 1e-5


def test_spmf_draw_matches_jax_searchsorted():
    rng = np.random.default_rng(33)
    p = rng.random(50).astype(np.float32)
    cdf = np.cumsum(p / p.sum()).astype(np.float32)
    u01 = np.concatenate([rng.random(200).astype(np.float32), cdf[:5],
                          np.float32([0.0, cdf[-1], 1.0, 0.9999999])])
    n = 40            # pairs beyond the cdf's support clip to n - 1
    want = np.asarray(jnp.clip(jnp.searchsorted(jnp.asarray(cdf),
                                                jnp.asarray(u01)), 0, n - 1))
    got = tbase.spmf_draw(torch.from_numpy(cdf), torch.from_numpy(u01), n)
    np.testing.assert_array_equal(got.numpy(), want)


def test_spmf_step_matches_jax(monkeypatch):
    """One SPMF batch: the JAX epoch (one batch, its negatives pinned to a
    fixed function of the user) against the port's draw on the same
    uniforms and its step on the drawn triples."""
    rng = np.random.default_rng(34)
    n_users, n_items, d, batch, lr = 50, 30, 8, 32, 0.01
    l2 = (1e-3, 2e-3)
    tables = _mf(rng, n_users, n_items, d)
    jmf, tmf = _both(tables)
    pairs = np.stack([rng.integers(0, n_users, 100),
                      rng.integers(0, n_items, 100)], axis=1)
    w = rng.random(100).astype(np.float32)
    cdf = np.cumsum(w / w.sum()).astype(np.float32)

    def fixed_neg(u):
        return (u * 3 + 1) % n_items

    monkeypatch.setattr(jbase, "sample_negatives",
                        lambda index, u, key, tries: fixed_neg(u))
    tx = torch_adam(lr, weight_decay=0.0)
    key = jax.random.PRNGKey(9)
    jepoch = jbase._make_spmf_epoch(batch, *l2, tx, 16)
    jmf, jopt, jl = jepoch(jmf, tx.init(jmf), jnp.asarray(pairs, jnp.int32),
                           jnp.asarray(cdf), 1, key, None)
    # the uniforms the JAX epoch drew for its one batch
    k1, _ = jax.random.split(jax.random.split(key, 1)[0])
    u01 = np.array(jax.random.uniform(k1, (batch,)))

    tepoch = tbase._make_spmf_epoch(batch, *l2, lr, 16)
    idx = tbase.spmf_draw(torch.from_numpy(cdf), torch.from_numpy(u01), 100)
    u = torch.from_numpy(pairs)[idx, 0]
    i = torch.from_numpy(pairs)[idx, 1]
    topt, loss = tepoch.step(tmf, adam_init(tmf._asdict()), u, i,
                             fixed_neg(u))
    np.testing.assert_allclose(float(loss.detach()), float(jl[0]),
                               rtol=1e-5)
    assert topt.count == int(jopt[1].count) == 1
    for f in MFParams._fields:
        np.testing.assert_allclose(getattr(tmf, f).numpy(),
                                   np.asarray(getattr(jmf, f)), err_msg=f,
                                   **TOL)


@pytest.mark.parametrize("scoring", ["gather", "masked"])
def test_attributed_eval_matches_jax(scoring):
    rng = np.random.default_rng(35)
    n_users, n_items, d, n_rows, n_neg, batch = 80, 300, 8, 200, 20, 64
    jmf, tmf = _both(_mf(rng, n_users, n_items, d, integer=True))
    cand = np.argsort(rng.random((n_rows, n_items)), axis=1)[:, :1 + n_neg]
    rows = np.zeros((256, 2 + n_neg), np.int32)
    rows[:n_rows, 0] = rng.integers(0, n_users, n_rows)
    rows[:n_rows, 1:] = cand
    mask = (np.arange(256) < n_rows).astype(np.float32)
    new_u = (rng.random(n_users) < 0.3).astype(np.float32)
    new_i = (rng.random(n_items) < 0.3).astype(np.float32)
    jcm = tcm = None
    if scoring == "masked":
        jcm = jax_packed_mask(jnp.asarray(rows[:, 2:]), n_items)
        tcm = build_packed_mask(torch.from_numpy(rows[:, 2:]), n_items)
    want = jax_attr_fn((5, 10, 20), batch, scoring=scoring)(
        jmf, jnp.asarray(rows), jnp.asarray(mask), jnp.asarray(new_u),
        jnp.asarray(new_i), jcm)
    got = make_attributed_eval_fn((5, 10, 20), batch, scoring=scoring)(
        tmf, torch.from_numpy(rows), torch.from_numpy(mask),
        torch.from_numpy(new_u), torch.from_numpy(new_i), tcm)
    for k in (5, 10, 20):
        for a, b in zip(got["base"][k], want["base"][k]):
            assert float(a) == pytest.approx(float(b), rel=1e-6)
        assert float(got["hit_new_user"][k]) == float(want["hit_new_user"][k])
        assert float(got["hit_new_item"][k]) == float(want["hit_new_item"][k])
    np.testing.assert_array_equal(got["buckets_at_max_k"].numpy(),
                                  np.asarray(want["buckets_at_max_k"]))
    assert float(got["buckets_at_max_k"].sum()) == float(got["base"][20][0])
    assert eval_kernel.masked_rank_cuda.launches == 0


@pytest.mark.parametrize("method", ["full", "fine", "spmf"])
def test_baseline_driver_matches_jax_contract(synthetic_dataset, method):
    from sml_tpu.utils.logging import MetricsLogger as JaxLogger
    from sml_tpu_torch.utils.logging import MetricsLogger

    dspec, _, _ = synthetic_dataset
    kw = dict(method=method, epochs=1, batch_size=128, latent_dim=8,
              pool_size=300, start_period=dspec.online_test_start)
    records = {}
    for name, cfg_cls, driver_cls, logger_cls, extra in (
            ("jax", JaxBaselineConfig, jbase.BaselineDriver, JaxLogger, {}),
            ("port", BaselineConfig, tbase.BaselineDriver, MetricsLogger,
             {"device": "cpu"})):
        logger = logger_cls(None)
        logged = []
        logger.log = lambda **rec: logged.append(rec)
        driver = driver_cls(cfg_cls(**kw), dspec, logger=logger, **extra)
        summary = driver.run(max_periods=2)
        records[name] = (logged, summary, driver)
    (jlog, jsum, jdrv), (tlog, tsum, tdrv) = records["jax"], records["port"]
    assert [r["kind"] for r in tlog] == ["baseline_test"] * 2
    assert [(r["kind"], r["method"], r["period"]) for r in tlog] == \
        [(r["kind"], r["method"], r["period"]) for r in jlog]
    assert [sorted(r) for r in tlog] == [sorted(r) for r in jlog]
    assert sorted(tsum) == sorted(jsum)
    assert tdrv.test_counts == jdrv.test_counts
    assert tdrv._bounds == jdrv._bounds
    for r in tlog:
        assert all(0.0 <= r[k] <= 1.0 for k in r
                   if k.startswith(("recall", "ndcg", "hit_new")))
    assert all(0.0 <= v <= 1.0 for v in tsum.values())
    if method == "spmf":
        np.testing.assert_array_equal(tdrv.reservoir.pool,
                                      jdrv.reservoir.pool)
    assert adam_kernel.decay_adam_cuda.launches == 0
