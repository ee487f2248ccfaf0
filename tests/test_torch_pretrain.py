"""The plain-MF epoch, the baselines' feeder and the pretrainer against the
JAX package.

The epoch lockstep pins both packages' random draws: ``shuffle_real_first``
becomes the identity and ``sample_negatives`` one fixed function of the
user, monkeypatched in both ``train.steps`` modules before the JAX epoch is
traced. Tables, Adam moments and losses are then held within rtol 1e-5
(f32 sums in another order, carried through Adam's normalisation), as the
training slice's lockstep is.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sml_tpu.train.pretrain as jpre
import sml_tpu.train.steps as jsteps
import sml_tpu_torch.train.pretrain as tpre
import sml_tpu_torch.train.steps as tsteps
from sml_tpu.data.feeder import StreamingPeriods as JaxStreaming
from sml_tpu.models.mf import MFParams as JaxMF
from sml_tpu.ops.batching import pad_rows as jax_pad_rows
from sml_tpu.train.optim import torch_adam
from sml_tpu_torch.config import PretrainConfig
from sml_tpu_torch.data.feeder import StreamingPeriods
from sml_tpu_torch.models.mf import MFParams
from sml_tpu_torch.ops import adam_kernel
from sml_tpu_torch.ops.batching import pad_rows
from sml_tpu_torch.train.optim import opt_state_from_numpy

N_U, N_I, D, BATCH, LR = 60, 40, 8, 16, 0.01
TOL = dict(rtol=1e-5, atol=1e-5)


def _fixed_negative(u):
    return (u * 7 + 3) % N_I


@pytest.mark.parametrize("fast", [False, True])
def test_plain_mf_epoch_matches_jax(monkeypatch, fast):
    monkeypatch.setattr(jsteps, "shuffle_real_first",
                        lambda key, rows, mask: (rows, mask))
    monkeypatch.setattr(jsteps, "sample_negatives",
                        lambda index, u, key, tries: _fixed_negative(u))
    monkeypatch.setattr(tsteps, "shuffle_real_first",
                        lambda gen, rows, mask: (rows, mask))
    monkeypatch.setattr(tsteps, "sample_negatives",
                        lambda index, u, gen, tries: _fixed_negative(u))
    rng = np.random.default_rng(21)
    tables = [rng.standard_normal(s).astype(np.float32)
              for s in ((N_U, D), (N_I, D), (N_U, 1), (N_I, 1))]
    mu = [1e-2 * rng.standard_normal(t.shape).astype(np.float32)
          for t in tables]
    nu = [1e-4 * rng.random(t.shape).astype(np.float32) for t in tables]
    # 61 rows: 4 steps of 16, the last one padded
    rows = np.stack([rng.integers(0, N_U, 61), rng.integers(0, N_I, 61)],
                    axis=1)
    l2 = (1e-3, 2e-3)

    tx = torch_adam(LR, weight_decay=0.0)
    jmf = JaxMF(*map(jnp.asarray, tables))
    chain = tx.init(jmf)
    jopt = (chain[0], chain[1]._replace(count=jnp.asarray(5, jnp.int32),
                                        mu=JaxMF(*map(jnp.asarray, mu)),
                                        nu=JaxMF(*map(jnp.asarray, nu))),
            chain[2])
    jp = jax_pad_rows(rows, BATCH)
    jepoch = jsteps.make_plain_mf_epoch(BATCH, *l2, tx,
                                        fast_lr=LR if fast else None)
    jmf, jopt, jl = jepoch(jmf, jopt, jp.rows, jp.mask, jnp.int32(jp.n_real),
                           jax.random.PRNGKey(0), None)

    tmf = MFParams(*(torch.from_numpy(t.copy()) for t in tables))
    topt = opt_state_from_numpy(
        {"count": 5, "mu": dict(zip(MFParams._fields, mu)),
         "nu": dict(zip(MFParams._fields, nu))}, device="cpu")
    tp = pad_rows(rows, BATCH, device="cpu")
    tepoch = tsteps.make_plain_mf_epoch(BATCH, *l2, LR,
                                        fast_lr=LR if fast else None)
    tmf, topt, tl = tepoch(tmf, topt, tp.rows, tp.mask, tp.n_real,
                           torch.Generator().manual_seed(0), None)

    assert tl.shape == jl.shape == (4,)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert topt.count == int(jopt[1].count) == 9
    for f in MFParams._fields:
        np.testing.assert_allclose(getattr(tmf, f).numpy(),
                                   np.asarray(getattr(jmf, f)),
                                   err_msg=f, **TOL)
        for part in ("mu", "nu"):
            np.testing.assert_allclose(
                getattr(topt, part)[f].numpy(),
                np.asarray(getattr(getattr(jopt[1], part), f)),
                rtol=1e-5, atol=1e-7, err_msg=f"{part}/{f}")
    assert adam_kernel.decay_adam_cuda.launches == 0


def test_streaming_periods_match_jax(synthetic_dataset):
    dspec, _, _ = synthetic_dataset
    jst, tst = JaxStreaming(dspec), StreamingPeriods(dspec)
    np.testing.assert_array_equal(tst.test_new_user, jst.test_new_user)
    np.testing.assert_array_equal(tst.test_new_item, jst.test_new_item)
    assert tst.test_new_user.size and tst.test_new_item.size
    assert (tst.info.n_interactions, tst.info.n_users, tst.info.n_items) == (
        jst.info.n_interactions, jst.info.n_users, jst.info.n_items)
    for mode in ("not_only_new", "only_new"):
        for p in range(dspec.num_periods + 1):
            want, got = jst.get_next(p, mode), tst.get_next(p, mode)
            for a, b in zip(want, got):
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a, b)


def _data_args(dspec):
    return ["--data-root", dspec.root, "--data-name", dspec.name,
            "--num-periods", str(dspec.num_periods), "--online-train-start",
            str(dspec.online_train_start), "--online-test-start",
            str(dspec.online_test_start)]


def test_pretrain_cli_writes_tables_both_packages_read(synthetic_dataset,
                                                       tmp_path, capsys):
    from sml_tpu.cli import main as jax_main
    from sml_tpu_torch import cli
    from sml_tpu_torch.cli import _load_mf

    dspec, info, _ = synthetic_dataset
    port, ref = tmp_path / "port.npz", tmp_path / "jax.npz"
    common = _data_args(dspec) + ["--epochs", "3", "--latent", "8",
                                  "--batch-size", "256"]
    assert cli.main(["--device", "cpu", "pretrain", "--out", str(port)]
                    + common) == 0
    metrics = json.loads(capsys.readouterr().out)
    assert metrics["best_epoch"] in (0, 2)
    assert all(0.0 <= metrics[f"recall@{k}"] <= 1.0 for k in (5, 10, 20))
    assert jax_main(["--platform", "cpu", "pretrain", "--out", str(ref)]
                    + common) == 0
    capsys.readouterr()
    with np.load(port) as a, np.load(ref) as b:
        assert sorted(a.files) == sorted(b.files) == sorted(MFParams._fields)
        for f in a.files:
            assert a[f].shape == b[f].shape and a[f].dtype == b[f].dtype
    mf = _load_mf(str(ref), torch.device("cpu"))
    assert mf.user_emb.shape == (info.n_users, 8)
    # the port's tables start the port's sweep
    assert cli.main(["--device", "cpu", "sml", "--pre-model", str(port),
                     "--multi-num", "1", "--latent", "8", "--mf-sample",
                     "alone", "--saddle-retries", "0"]
                    + _data_args(dspec)) == 0
    summary = json.loads(capsys.readouterr().out)
    assert 0.0 <= summary["test_recall@5"] <= 1.0


def _inject_recalls(monkeypatch, module, recalls, losses):
    """Make ``module.pretrain_mf`` see ``recalls`` (recall@20 per eval) and
    skip training: the stopping rule alone decides the epochs."""
    seq = iter(recalls)

    def make_eval_fn(topks, batch_size, scoring="gather"):
        def evaluate(mfp, rows, mask):
            r, n = next(seq), float(mask.sum())
            return {k: (r * n, 0.0) for k in topks}
        return evaluate

    def make_epoch(*a, **k):
        return lambda mf, opt, *rest: (mf, opt, losses)

    monkeypatch.setattr(module, "make_eval_fn", make_eval_fn)
    monkeypatch.setattr(module, "make_plain_mf_epoch", make_epoch)


def test_pretrain_early_stop_matches_jax(synthetic_dataset, monkeypatch):
    from sml_tpu.config import PretrainConfig as JaxPretrainConfig

    dspec, _, _ = synthetic_dataset
    recalls = [0.10, 0.20, 0.15, 0.20, 0.30, 0.10, 0.25, 0.29, 0.05, 0.30,
               0.01, 0.02, 0.03, 0.04]
    period = dspec.online_test_start - 1
    kw = dict(max_epochs=40, eval_every=3, patience=3, latent_dim=4)

    class Log:
        def __init__(self):
            self.epochs = []

        def log(self, **rec):
            self.epochs.append(rec["epoch"])

    _inject_recalls(monkeypatch, jpre, recalls, jnp.zeros(1))
    # the JAX pretrainer jits its evaluator; run it eagerly here so each
    # eval reads the next injected recall
    monkeypatch.setattr(jpre, "jax", types.SimpleNamespace(
        jit=lambda f, **k: f, random=jax.random, tree=jax.tree))
    jlog = Log()
    _, jm = jpre.pretrain_mf(JaxPretrainConfig(**kw), dspec, period,
                             logger=jlog)
    _inject_recalls(monkeypatch, tpre, recalls, torch.zeros(1))
    tlog = Log()
    _, tm = tpre.pretrain_mf(PretrainConfig(**kw), dspec, period,
                             logger=tlog, device="cpu")
    # best at the 5th eval (epoch 12); stale for 4 > 3 rounds after it
    assert tlog.epochs == jlog.epochs == list(range(0, 27, 3))
    assert tm["best_epoch"] == jm["best_epoch"] == 12
    assert tm == pytest.approx(jm)
