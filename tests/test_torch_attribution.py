"""Hit attribution by entity freshness (``sml --attributed-eval``) against
the JAX package, on the CPU.

* The engine's attributed records (``evaluate_attributed``) equal JAX's
  ``evaluate_attributed_deferred`` + ``resolve_attributed`` on the same
  integer-valued tables and eval set (scores are exact, so the records
  are equal), in the masked and gather scoring modes.
* The driver with ``attributed_eval`` on the conftest synthetic dataset
  logs the JAX driver's record kinds, in its order, with its keys, and
  meets the checks of ``tests/test_attribution_multipass.py``: the bucket
  shares of all hits sum to 1, the ``_of_test`` buckets to recall@20, and
  the new-entity hit shares stay under recall@K. The ``sml`` CLI with
  ``--attributed-eval`` logs the same record kinds.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sml_tpu.config import SMLConfig as JaxSMLConfig
from sml_tpu.config import TransferConfig as JaxTransferConfig
from sml_tpu.models.mf import MFParams as JaxMF
from sml_tpu.train.driver import SMLDriver as JaxDriver
from sml_tpu.train.engine import SMLEngine as JaxEngine
from sml_tpu_torch import cli
from sml_tpu_torch.config import SMLConfig, TransferConfig
from sml_tpu_torch.models.mf import MFParams
from sml_tpu_torch.train.driver import SMLDriver
from sml_tpu_torch.train.engine import SMLEngine
from sml_tpu_torch.utils.logging import MetricsLogger

BUCKETS = ("old_user_old_item", "old_user_new_item", "new_user_old_item",
           "new_user_new_item")


def _cfgs(**kw):
    base = dict(multi_num=1, mf_batch_size=256, tr_batch_size=128,
                eval_batch_size=256, latent_dim=8, attributed_eval=True)
    base.update(kw)
    return (JaxSMLConfig(transfer=JaxTransferConfig(latent_dim=8,
                                                    fc_hidden=32),
                         fuse_phases=False, fuse_period=False, **base),
            SMLConfig(transfer=TransferConfig(latent_dim=8, fc_hidden=32),
                      **base))


@pytest.mark.parametrize("scoring", ["masked", "gather"])
def test_engine_attributed_records_equal_jax(rng, scoring):
    n_users, n_items, d = 80, 200, 8
    # integer tables: every score is an exact f32 sum, so both packages
    # rank identically
    ue = rng.integers(-3, 4, (n_users, d)).astype(np.float32)
    ie = rng.integers(-3, 4, (n_items, d)).astype(np.float32)
    n, neg = 300, 30
    rows = np.concatenate([
        rng.integers(0, n_users, (n, 1)),
        np.stack([rng.permutation(n_items)[:1 + neg] for _ in range(n)])],
        axis=1).astype(np.int64)
    new_u = np.sort(rng.permutation(n_users)[:20])
    new_i = np.sort(rng.permutation(n_items)[:40])
    jcfg, tcfg = _cfgs(eval_batch_size=64, eval_scoring=scoring)
    jeng = JaxEngine(jcfg, n_users, n_items)
    jmf = JaxMF(jnp.asarray(ue), jnp.asarray(ie), jnp.zeros((n_users, 1)),
                jnp.zeros((n_items, 1)))
    jnu = jnp.zeros(n_users, jnp.float32).at[new_u].set(1.0)
    jni = jnp.zeros(n_items, jnp.float32).at[new_i].set(1.0)
    want = jeng.resolve_attributed([jeng.evaluate_attributed_deferred(
        jmf, jeng.make_eval_set(rows, build_mask=True), jnu, jni)])[0]
    jbase = jeng.evaluate(jmf, rows)

    teng = SMLEngine(tcfg, n_users, n_items, device="cpu")
    tmf = MFParams(torch.from_numpy(ue), torch.from_numpy(ie),
                   torch.zeros(n_users, 1), torch.zeros(n_items, 1))
    tnu, tni = teng.new_entity_masks(new_u, new_i)
    got = teng.evaluate_attributed(
        tmf, teng.make_eval_set(rows, build_mask=True), tnu, tni)
    assert list(got) == list(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-7), k
    # the deferred form's base sums are the plain evaluation's
    out, cnt = teng.evaluate_attributed_deferred(tmf, rows, tnu, tni)
    base = teng.resolve_evals([(out["base"], cnt)])[0]
    for k, m in jbase.items():
        assert base[k]["recall"] == pytest.approx(m["recall"], abs=1e-7)
        assert base[k]["ndcg"] == pytest.approx(m["ndcg"], abs=1e-6)
    assert sum(got[f"{b}_of_test"] for b in BUCKETS) == \
        pytest.approx(base[20]["recall"], abs=1e-6)


def _records(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def _check_attribution(recs):
    """The checks of ``tests/test_attribution_multipass.py:69-109``."""
    attrs = [r for r in recs if r["kind"] == "test_attribution"]
    tests = [r for r in recs if r["kind"] == "test"]
    assert len(attrs) == len(tests) == 3
    for a, t in zip(attrs, tests):
        assert a["period"] == t["period"]
        shares = [a[f"{b}_of_hits"] for b in BUCKETS]
        assert all(0.0 <= v <= 1.0 for v in shares)
        if t["recall@20"] * t["n_test"] > 0:
            np.testing.assert_allclose(sum(shares), 1.0, rtol=1e-6)
            of_test = sum(a[f"{b}_of_test"] for b in BUCKETS)
            np.testing.assert_allclose(of_test, t["recall@20"], rtol=1e-5)
        for k in (5, 10, 20):
            assert 0.0 <= a[f"hit_share_new_user@{k}"] \
                <= t[f"recall@{k}"] + 1e-6
            assert 0.0 <= a[f"hit_share_new_item@{k}"] \
                <= t[f"recall@{k}"] + 1e-6


def _shape(recs):
    return [(r["kind"], sorted(k for k in r if k != "ts")) for r in recs]


def test_driver_attribution_records_match_jax(synthetic_dataset, tmp_path):
    dspec, info, _ = synthetic_dataset
    jcfg, tcfg = _cfgs()
    out = {}
    for name, make in (
            ("jax", lambda lg: JaxDriver(jcfg, dspec, logger=lg)),
            ("torch", lambda lg: SMLDriver(tcfg, dspec, logger=lg,
                                           device="cpu"))):
        path = str(tmp_path / f"{name}.jsonl")
        logger = MetricsLogger(path)
        drv = make(logger)
        report = drv.run()
        logger.close()
        assert len(report.test_counts) == 3
        out[name] = _records(path)
    assert _shape(out["torch"]) == _shape(out["jax"])
    assert [(r["kind"], r.get("period")) for r in out["torch"]] == \
        [(r["kind"], r.get("period")) for r in out["jax"]]
    _check_attribution(out["torch"])
    _check_attribution(out["jax"])

    # the CLI's --attributed-eval logs the same record kinds
    jl = str(tmp_path / "cli.jsonl")
    assert cli.main(["--device", "cpu", "sml", "--data-root", dspec.root,
                     "--data-name", dspec.name, "--num-periods", "8",
                     "--online-train-start", "3", "--online-test-start",
                     "5", "--multi-num", "1", "--latent", "8",
                     "--mf-sample", "alone", "--saddle-retries", "0",
                     "--attributed-eval", "--metrics-jsonl", jl]) == 0
    recs = _records(jl)
    assert [r["kind"] for r in recs] == [r["kind"] for r in out["torch"]]
    _check_attribution(recs)
