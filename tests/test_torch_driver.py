"""The training slice as a whole: the driver, checkpoints and the ``sml``
CLI against the JAX package, on the conftest synthetic dataset.

* Both drivers sweep the dataset (two passes: the warm-up span is replayed
  before the final pass; branches A and C, in-training evals, per-phase
  diagnostics): the same jsonl record kinds in the same order,
  the same summary keys, and test recall@5 above chance (5/(1+neg_num)).
  Random streams differ by design, so the metrics are not compared.
* The saddle rule makes the same decisions as ``sml_tpu``'s on the
  recorded period-0 trajectories of ``tests/test_saddle_autocal.py``, in
  both modes.
* A JAX checkpoint (optimizer states included) loads into the port, and a
  port checkpoint restores in ``sml_tpu``.
* ``python -m sml_tpu_torch --device cpu sml`` runs and resumes from
  ``--checkpoint-dir``.
"""

import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from sml_tpu.config import SMLConfig as JaxSMLConfig
from sml_tpu.config import TransferConfig as JaxTransferConfig
from sml_tpu.train.driver import SMLDriver as JaxDriver
from sml_tpu.train.engine import SMLEngine as JaxEngine
from sml_tpu.utils import checkpoint as jax_ckpt
from sml_tpu_torch import cli
from sml_tpu_torch.config import SMLConfig, TransferConfig
from sml_tpu_torch.models.transfer import theta_leaves
from sml_tpu_torch.train.driver import SMLDriver
from sml_tpu_torch.utils import checkpoint as ckpt
from sml_tpu_torch.utils.logging import MetricsLogger

D, H = 8, 32
SWEEP = dict(latent_dim=D, multi_num=3, mf_sample="alone", mf_batch_size=64,
             tr_batch_size=64, eval_batch_size=64, log_norms=True,
             eval_during_outer=True, saddle_retries=0, pass_num=2)
EVAL_KINDS = ("inner_eval", "outer_eval")


def _cfgs(**kw):
    return (JaxSMLConfig(transfer=JaxTransferConfig(latent_dim=D,
                                                    fc_hidden=H),
                         fuse_phases=False, fuse_period=False, **kw),
            SMLConfig(transfer=TransferConfig(latent_dim=D, fc_hidden=H),
                      **kw))


def _records(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


@pytest.fixture(scope="module")
def sweeps(synthetic_dataset, tmp_path_factory):
    dspec, _, _ = synthetic_dataset
    out = tmp_path_factory.mktemp("sweeps")
    jcfg, tcfg = _cfgs(**SWEEP)
    runs = {}
    for name, make in (
            ("jax", lambda lg: JaxDriver(jcfg, dspec, logger=lg)),
            ("torch", lambda lg: SMLDriver(tcfg, dspec, logger=lg,
                                           device="cpu"))):
        path = str(out / f"{name}.jsonl")
        logger = MetricsLogger(path)
        drv = make(logger)
        report = drv.run()
        logger.close()
        runs[name] = (drv, report, _records(path))
    return runs


def test_driver_records_match_jax(sweeps, synthetic_dataset):
    _, _, spec = synthetic_dataset
    (jdrv, jrep, jrec), (tdrv, trep, trec) = sweeps["jax"], sweeps["torch"]
    assert [r["kind"] for r in trec if r["kind"] not in EVAL_KINDS] == \
        [r["kind"] for r in jrec if r["kind"] not in EVAL_KINDS]
    # in-training evals: the same records in the same order (the JAX
    # driver may log them a period later, when their sums are ready)
    assert [(r["kind"], r["epoch"]) for r in trec if r["kind"] in EVAL_KINDS] \
        == [(r["kind"], r["epoch"]) for r in jrec if r["kind"] in EVAL_KINDS]
    kinds = {r["kind"] for r in trec}
    assert {"phase", "period", "test", "outer_eval", "summary"} <= kinds
    tphase = [r for r in trec if r["kind"] == "phase"]
    jphase = [r for r in jrec if r["kind"] == "phase"]
    assert [sorted(r) for r in tphase] == [sorted(r) for r in jphase]
    assert all(math.isfinite(r["inner_loss"]) and math.isfinite(
        r["outer_loss"]) for r in tphase)
    assert sorted(trep.summary()) == sorted(jrep.summary())
    assert trep.test_counts == jrep.test_counts
    chance = 5 / (1 + spec.neg_num)
    assert trep.summary()["test_recall@5"] > chance
    tests = [r for r in trec if r["kind"] == "test"]
    assert [r["period"] for r in tests] == \
        [r["period"] for r in jrec if r["kind"] == "test"]


@pytest.mark.parametrize("mode", ["auto", "legacy"])
def test_saddle_rule_decisions_match_jax(synthetic_dataset, mode):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "yelp_scale_r3.json")) as fh:
        records = json.load(fh)
    trajs = [v["outer_loss"] for v in records.values()
             if isinstance(v, dict) and "outer_loss" in v]
    trajs.append([1.380, 1.383, 1.378, 1.374, 1.351, 1.327, 1.304])
    trajs.append([1.38, 1.30, 1.18, 1.10, 1.06, 1.04, 1.03])
    assert len(trajs) >= 29
    dspec, _, _ = synthetic_dataset
    for multi in (7, 10):
        kw = dict(latent_dim=D, multi_num=multi, saddle_mode=mode,
                  prefetch_periods=False)
        jcfg, tcfg = _cfgs(**kw)
        jrule = JaxDriver(jcfg, dspec)._saddle_rule()
        trule = SMLDriver(tcfg, dspec, device="cpu")._saddle_rule()
        assert trule[0] == jrule[0]
        flagged = 0
        for traj in trajs:
            for phase, loss in enumerate(traj[:multi]):
                want = jrule[1](phase, loss)
                assert trule[1](phase, loss) == want
                flagged += want
        assert flagged > 0


def test_jax_checkpoint_loads_and_port_checkpoint_restores(tmp_path, rng):
    n_u, n_i = 30, 20
    jcfg, tcfg = _cfgs(latent_dim=D, mf_batch_size=16, tr_batch_size=8,
                       replay_mode=True, snapshot_dtype="bfloat16")
    jeng = JaxEngine(jcfg, n_u, n_i)
    jstate = jeng.snapshot_last(jeng.init_state())
    rows = np.stack([rng.integers(0, n_u, 50), rng.integers(0, n_i, 50),
                     rng.integers(0, n_i, 50)], 1)
    jstate, _ = jeng.inner_epoch(jstate, *jeng.prep_inner(rows))
    jstate = jeng.refresh(jeng.snapshot_hat(jstate))
    jstate, _ = jeng.outer_epoch(jstate, *jeng.prep_outer(rows))
    jax_ckpt.save_checkpoint(str(tmp_path / "j"), 3, jstate,
                             extra={"period": 3})
    host = jax.tree.map(np.asarray, jstate)

    t = ckpt.state_from_checkpoint(str(tmp_path / "j"), device="cpu")
    assert t.hat_user.dtype == torch.bfloat16
    assert t.mf_opt.count == int(host.mf_opt[1].count) == 4
    assert t.tr_opt.count == int(host.tr_opt[1].count) == 7
    np.testing.assert_array_equal(t.mf_opt.nu["item_emb"].numpy(),
                                  host.mf_opt[1].nu.item_emb)
    np.testing.assert_array_equal(t.tr_opt.mu["user/fc1_w"].numpy(),
                                  host.tr_opt[1].mu.user.fc1_w)
    np.testing.assert_array_equal(
        theta_leaves(t.theta)["item/conv2_b"].detach().numpy(),
        host.theta.item.conv2_b)
    # a JAX key seeds the port's generator (a new stream, the same seed)
    again = ckpt.state_from_checkpoint(str(tmp_path / "j"), device="cpu")
    assert torch.equal(t.gen.get_state(), again.gen.get_state())

    # the port writes it back; sml_tpu restores every leaf
    teng_state = t
    ckpt.save_checkpoint(str(tmp_path / "t"), 4, teng_state)
    restored, step, _ = jax_ckpt.restore_checkpoint(str(tmp_path / "t"),
                                                    jeng.init_state())
    assert step == 4
    flat = ckpt.flatten_state(teng_state)
    for path, leaf in jax.tree_util.tree_flatten_with_path(restored)[0]:
        key = "/".join(str(p.name) if hasattr(p, "name") else str(p.idx)
                       for p in path)
        want = flat[key]
        if want.dtype == torch.bfloat16:
            want = want.float()
            leaf = leaf.astype(np.float32)
        np.testing.assert_array_equal(np.asarray(leaf),
                                      want.detach().numpy(), err_msg=key)
    # the port's own checkpoint restores its generator exactly
    back = ckpt.state_from_checkpoint(str(tmp_path / "t"), device="cpu")
    assert torch.equal(back.gen.get_state(), teng_state.gen.get_state())


def test_sml_cli_runs_and_resumes(synthetic_dataset, tmp_path, capsys):
    dspec, _, _ = synthetic_dataset
    args = ["--device", "cpu", "sml", "--data-root", dspec.root,
            "--data-name", dspec.name, "--num-periods",
            str(dspec.num_periods), "--online-train-start",
            str(dspec.online_train_start), "--online-test-start",
            str(dspec.online_test_start), "--multi-num", "2", "--latent",
            str(D), "--mf-sample", "alone", "--checkpoint-dir",
            str(tmp_path / "ck"), "--save-model", str(tmp_path / "m.npz")]
    assert cli.main(args) == 0
    first = capsys.readouterr()
    summary = json.loads(first.out[first.out.index("{"):])
    assert 0.0 <= summary["test_recall@5"] <= 1.0
    with np.load(tmp_path / "m.npz") as m:
        assert m["user_emb"].shape[1] == D
    assert cli.main(args) == 0
    second = capsys.readouterr()
    last = dspec.num_periods - 1 - dspec.online_train_start
    assert f"resumed at pass 0 period {last}" in second.err
    resumed = json.loads(second.out[second.out.index("{"):])
    assert {k: v for k, v in resumed.items() if k != "total_seconds"} == \
        {k: v for k, v in summary.items() if k != "total_seconds"}


def test_unported_options_raise(synthetic_dataset, tmp_path):
    """The two options that raised until they were ported now run:
    attribution masks come from the dataset's new-entity id files (none
    without them), and ``profile_dir`` builds a driver that traces."""
    import dataclasses
    import shutil
    dspec, _, _ = synthetic_dataset
    _, tcfg = _cfgs(latent_dim=D)
    drv = SMLDriver(tcfg.replace(attributed_eval=True), dspec, device="cpu")
    new_u = np.load(os.path.join(dspec.path, "test_new_user.npy"))
    assert int(drv._is_new_user.sum()) == len(np.unique(new_u)) > 0
    drv.close()
    bare = tmp_path / "bare"
    shutil.copytree(dspec.path, bare / dspec.name)
    os.remove(bare / dspec.name / "test_new_user.npy")
    drv = SMLDriver(tcfg.replace(attributed_eval=True),
                    dataclasses.replace(dspec, root=str(bare)),
                    device="cpu")
    assert drv._is_new_user is None and drv._is_new_item is None
    drv.close()
    drv = SMLDriver(tcfg.replace(profile_dir=str(tmp_path / "p")), dspec,
                    device="cpu")
    assert drv.cfg.profile_dir == str(tmp_path / "p")
    drv.close()
