"""Training on a mesh against the JAX package's single-device engine, on
gloo worlds of CPU ranks, at the sizes of ``tests/test_multihost.py``
(320 users, 160 items, d=16, H=64, batches 128/64).

* Two replay-mode SML phases (snapshot, inner epoch, snapshot, refresh,
  outer epoch, refresh) from the JAX engine's initial state carried
  across, on meshes (1, 2), (2, 1) and (2, 2), with the row-sparse table
  Adam (K3's path) and, on (2, 2), the dense one; and on (1, 3), where
  neither 320 users nor 160 items divide and both sides stay replicated
  on every rank: tables and Θ within rtol
  2e-4, atol 2e-5 (the tolerance of ``tests/test_multihost.py``), the
  per-batch losses too; each epoch's last batch is partial, so its valid
  rows fall on one data rank only. Recall@K of the test equals the JAX
  engine's and the port's on one rank, and with the row-sparse Adam the
  whole record, and the attributed evaluation's, equals the one-rank
  port's; the weight diagnostics (means over the whole tables) agree
  within rtol 1e-5.
* A sampled ('alone') run on 2 ranks against 1 rank of the port: every
  rank draws the whole batch from the same generator, so the draws are
  the same and the tables agree within 1e-5.
"""

import jax
import numpy as np
import pytest

from sml_tpu.config import SMLConfig as JaxSMLConfig
from sml_tpu.config import TransferConfig as JaxTransferConfig
from sml_tpu.train.engine import SMLEngine as JaxEngine
from sml_tpu_torch.config import SMLConfig, TransferConfig
from sml_tpu_torch.parallel.dryrun import run_world

WORKERS = "torch_parallel_workers"
TIMEOUT_S = 120
N_USERS, N_ITEMS, DIM, H = 320, 160, 16, 64
TOL = dict(rtol=2e-4, atol=2e-5)


def _cfgs(**kw):
    base = dict(latent_dim=DIM, mf_batch_size=128, tr_batch_size=64,
                eval_batch_size=128, multi_num=1, topk=(5, 20))
    base.update(kw)
    return (JaxSMLConfig(transfer=JaxTransferConfig(latent_dim=DIM,
                                                    fc_hidden=H), **base),
            SMLConfig(transfer=TransferConfig(latent_dim=DIM, fc_hidden=H),
                      **base))


def _write_state(path, jstate):
    """The JAX state as flat numpy arrays, under the keys the workers
    read."""
    host = jax.tree.map(np.asarray, jstate)
    out = {f"mf/{f}": getattr(host.mf, f) for f in host.mf._fields}
    for f in ("last_user", "last_item", "hat_user", "hat_item"):
        out[f] = getattr(host, f)
    for side in ("user", "item"):
        tower = getattr(host.theta, side)
        for f in tower._fields:
            out[f"theta/{side}/{f}"] = getattr(tower, f)
    for name in ("mf_opt", "tr_opt"):
        adam = getattr(host, name)[1]
        out[f"{name}/count"] = np.asarray(adam.count)
        for part in ("mu", "nu"):
            tree = getattr(adam, part)
            if name == "mf_opt":
                for f in tree._fields:
                    out[f"{name}/{part}/{f}"] = getattr(tree, f)
            else:
                for side in ("user", "item"):
                    tower = getattr(tree, side)
                    for f in tower._fields:
                        out[f"{name}/{part}/{side}/{f}"] = getattr(tower, f)
    np.savez(path, **out)


def _triples(rng, n):
    return np.stack([rng.integers(0, N_USERS, n), rng.integers(0, N_ITEMS, n),
                     rng.integers(0, N_ITEMS, n)], axis=1).astype(np.int64)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX engine's two replay phases and test, once per table-Adam
    path: its initial state (written for the workers), the rows, and its
    final state, losses and metrics."""
    runs = {}

    def get(fast):
        if fast in runs:
            return runs[fast]
        rng = np.random.default_rng(0)
        jcfg, tcfg = _cfgs(replay_mode=True, fast_table_adam=fast)
        jeng = JaxEngine(jcfg, N_USERS, N_ITEMS)
        jstate = jeng.init_state()
        path = str(tmp_path_factory.mktemp("jax") / "state.npz")
        _write_state(path, jstate)
        # 700 inner rows: 6 batches, the last with 60 valid rows (all on
        # data rank 0 of 2); 300 outer rows: 5 batches, the last with 44
        inner, outer = _triples(rng, 700), _triples(rng, 300)
        test_rows = np.concatenate([rng.integers(0, N_USERS, (200, 1)),
                                    rng.integers(0, N_ITEMS, (200, 100))], 1)
        jlosses = []
        for _ in range(2):
            jstate = jeng.snapshot_last(jstate)
            jstate, jl = jeng.inner_epoch(jstate, *jeng.prep_inner(inner))
            jstate = jeng.refresh(jeng.snapshot_hat(jstate))
            jstate, ol = jeng.outer_epoch(jstate, *jeng.prep_outer(outer))
            jstate = jeng.refresh(jstate)
            jlosses.append((np.asarray(jl), np.asarray(ol)))
        runs[fast] = (tcfg, path, inner, outer, test_rows, jstate, jlosses,
                      jeng.evaluate(jstate.mf, test_rows))
        return runs[fast]
    return get


@pytest.mark.parametrize("mesh_shape,fast", [
    ((1, 2), True), ((2, 1), True), ((2, 2), True), ((2, 2), False),
    ((1, 3), True)])
def test_replay_phases_on_a_mesh_match_jax(jax_runs, mesh_shape, fast):
    (tcfg, path, inner, outer, test_rows, jstate, jlosses,
     jmetrics) = jax_runs(fast)
    n = mesh_shape[0] * mesh_shape[1]
    args = (tcfg, N_USERS, N_ITEMS, path, inner, outer, test_rows)
    got = run_world(f"{WORKERS}:replay_phases", n, device="cpu",
                    args=args + (mesh_shape, 2, True), timeout_s=TIMEOUT_S)[0]
    one = got["one"]
    np.testing.assert_allclose(got["user_emb"],
                               np.asarray(jstate.mf.user_emb), **TOL)
    np.testing.assert_allclose(got["item_emb"],
                               np.asarray(jstate.mf.item_emb), **TOL)
    jtheta = {f"{side}/{f}": np.asarray(getattr(getattr(jstate.theta, side),
                                                f))
              for side in ("user", "item")
              for f in getattr(jstate.theta, side)._fields}
    for k, v in got["theta"].items():
        np.testing.assert_allclose(v, jtheta[k], err_msg=k, **TOL)
    for (gi, go), (wi, wo) in zip(got["losses"], jlosses):
        np.testing.assert_allclose(gi, wi, **TOL)
        np.testing.assert_allclose(go, wo, **TOL)
    assert got["mf_count"] == int(jstate.mf_opt[1].count) == 12
    # the row-sparse path updates in the single-rank order: the same
    # tables, the same test; the dense one sums the data ranks' gradients
    # in another order, so a near tie may swap two ranks of one row
    # (recall stays, NDCG moves by at most one row's step, < 1/200 · 0.37)
    if fast:
        assert got["metrics"] == one["metrics"]
        assert got["attributed"] == one["attributed"]
    for k, v in got["diagnostics"].items():
        # means over the whole tables, summed over 'model' in another order
        np.testing.assert_allclose(v, one["diagnostics"][k], rtol=1e-5,
                                   err_msg=k)
    for k, v in got["attributed"].items():
        assert abs(v - one["attributed"][k]) <= 2 / 200, k
    for k in (5, 20):
        for ref, tol in ((one["metrics"], 0.0 if fast else 2e-3),
                         (jmetrics, 2e-3)):
            assert got["metrics"][k]["recall"] == ref[k]["recall"]
            assert abs(got["metrics"][k]["ndcg"] - ref[k]["ndcg"]) <= tol


def test_sampled_two_ranks_match_one(rng):
    _, tcfg = _cfgs(mf_sample="alone", tr_sample_type="alone",
                    fast_table_adam=True)

    def pairs(n):
        return np.unique(np.stack([rng.integers(0, N_USERS, n),
                                   rng.integers(0, N_ITEMS, n)], 1), axis=0)
    set_t, set_tt = pairs(700), pairs(300)
    args = (tcfg, N_USERS, N_ITEMS, set_t, set_tt)
    two = run_world(f"{WORKERS}:sampled_run", 2, device="cpu",
                    args=args + ((2, 1), True), timeout_s=TIMEOUT_S)[0]
    one = two["one"]
    for f in ("user_emb", "item_emb"):
        np.testing.assert_allclose(two[f], one[f], rtol=1e-5, atol=1e-5)
    for k, v in two["theta"].items():
        np.testing.assert_allclose(v, one["theta"][k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
