"""One program per run (``train/graphs.py``, ``SMLEngine._program``,
``train/steps.py`` ``PlainEpochProgram``) on the CPU, where a program runs
eagerly: its plain version.

* On a dataset whose periods differ in set_t, set_tt and test row counts
  and in their item pools, the fused sweep (``fuse_period=True``, and
  ``fuse_phases=True`` with ``fuse_period=False``; evals, norms, the
  saddle retry, 'all'-mode sampling) equals the unfused one bit for bit
  (tables, Θ, snapshots, moments, counts, the generator, metrics and
  every record), with exactly one phase program made for the sweep.
* ``BiasTable`` slot rows against ``bias_corrections`` for ``taken <
  slots``; a step slot table's skipped slots leave tables, moments and
  losses as the JAX package's ``scan_epoch`` leaves them, in replay mode
  (rtol 1e-5, ``tests/test_torch_train.py``'s tolerance).
* The sampler's per-period values are 0-d device tensors equal to JAX's.
* The pretrainer and the full / fine baselines through their epoch program
  against the same epochs called one by one: bit-equal, one program per
  run.
"""

import numpy as np
import pytest
import torch

import sml_tpu_torch.train.baselines as tbase
import sml_tpu_torch.train.pretrain as tpre
from sml_tpu.ops import sampling as JS
from sml_tpu.train.engine import SMLEngine as JaxEngine
from sml_tpu_torch.config import (BaselineConfig, DataSpec, PretrainConfig,
                                  SMLConfig, TransferConfig)
from sml_tpu_torch.data.formats import DatasetInfo, write_dataset
from sml_tpu_torch.ops import sampling as S
from sml_tpu_torch.ops.batching import num_batches
from sml_tpu_torch.train import graphs
from sml_tpu_torch.train.driver import SMLDriver
from sml_tpu_torch.train.engine import SMLEngine
from sml_tpu_torch.train.optim import BiasTable, bias_corrections

from test_torch_fused import STALL, RecordingLogger, _assert_same_run
from test_torch_train import _cfgs, _triples, carry_state

N_USERS, N_ITEMS, NEG = 200, 120, 20
TRAIN_ROWS = (700, 420, 910, 515, 650, 380)
TEST_ROWS = (90, 61, 118, 75, 102, 66)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def ragged(tmp_path_factory):
    """Six periods whose train and test row counts and item pools all
    differ (each period draws its items from its own id range)."""
    rng = np.random.default_rng(11)
    train, test = [], {}
    for p, (n, m) in enumerate(zip(TRAIN_ROWS, TEST_ROWS)):
        lo = 7 * p
        items = rng.integers(lo, lo + 60 + 5 * p, n)
        train.append(np.stack([rng.integers(0, N_USERS, n), items], 1))
        negs = np.stack([rng.choice(N_ITEMS, NEG, replace=False)
                         for _ in range(m)])
        test[p] = np.concatenate([rng.integers(0, N_USERS, (m, 1)),
                                  rng.integers(lo, lo + 60, (m, 1)), negs],
                                 axis=1)
    root = tmp_path_factory.mktemp("ragged")
    write_dataset(str(root / "synth"), train, test,
                  DatasetInfo(sum(TRAIN_ROWS), N_USERS, N_ITEMS))
    return DataSpec(root=str(root), name="synth", num_periods=6,
                    online_train_start=1, online_test_start=3,
                    eval_neg_num=NEG)


def _cfg(**kw):
    base = dict(multi_num=3, mf_epochs=2, tr_epochs=2, mf_batch_size=64,
                tr_batch_size=32, eval_batch_size=64, latent_dim=8,
                mf_sample="alone", topk=(5, 10, 20), prefetch_periods=False,
                fast_table_adam=True)
    base.update(kw)
    return SMLConfig(transfer=TransferConfig(latent_dim=8, fc_hidden=32),
                     **base)


def _run(spec, **kw):
    logger = RecordingLogger()
    drv = SMLDriver(_cfg(**kw), spec, logger=logger, device="cpu")
    report = drv.run()
    return drv, report, logger.records


CASES = {
    "period_evals_norms": dict(fuse_period=True, eval_during_inner=True,
                               eval_during_outer=True, log_norms=True),
    "period_guard": dict(fuse_period=True, log_norms=True,
                         eval_during_outer=True, **STALL),
    "phase_guard": dict(fuse_phases=True, fuse_period=False, log_norms=True,
                        **STALL),
    "period_all_mode": dict(fuse_period=True, mf_sample="all",
                            mf_batch_size=32, eval_batch_size=32),
}


def test_the_ragged_periods_differ_in_their_batch_counts(ragged):
    """The data the sweep tests run on: the periods' real batch counts
    differ in both epochs (inner on train/t at B=64, or on test/t at
    B=32 in 'all' mode; outer on train/t+1 at B=32), and so do their item
    pools."""
    for rows, batch in ((TRAIN_ROWS, 64), (TRAIN_ROWS, 32),
                        (TEST_ROWS, 32)):
        assert len({num_batches(n, batch) for n in rows}) >= 3
    pools = [S.build_period_index(np.load(f"{ragged.path}/train/{p}.npy"),
                                  N_ITEMS, device="cpu").pool_size
             for p in range(6)]
    assert len({int(p) for p in pools}) == 6


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_program_sweep_matches_unfused(ragged, case):
    kw = dict(CASES[case])
    fused = _run(ragged, **kw)
    for k in ("fuse_phases", "fuse_period"):
        kw.pop(k, None)
    unfused = _run(ragged, fuse_phases=False, fuse_period=False, **kw)
    _assert_same_run(fused, unfused)
    stats = fused[0].engine.graph_stats
    assert stats["programs"] == 1, stats
    assert unfused[0].engine.graph_stats["programs"] == 0
    assert not fused[0].engine._programs     # released at the run's end
    if "saddle_retries" in kw:
        assert fused[1].saddle_retries_used == 1


def test_programs_are_kept_across_periods_and_keyed_by_shape(ragged):
    """``run_period`` keeps the program from period to period; inputs of
    another shape (replay mode's per-period shapes) make another."""
    drv = SMLDriver(_cfg(fuse_period=True), ragged, device="cpu")
    eng = drv.engine
    state = eng.init_state()
    drv.feeder.reinit()
    for d_time in range(3):
        state, ok = drv.run_period(state, d_time)
        assert ok and len(eng._programs) == 1
    assert eng.graph_stats["programs"] == 1
    eng.shape_targets = {}           # pad to each period's own bucket
    prep_t = eng.prep_inner(np.load(f"{ragged.path}/train/1.npy"))
    prep_tt = eng.prep_outer(np.load(f"{ragged.path}/train/2.npy")[:50])
    eng.phase_step(state, prep_t, prep_tt)
    assert len(eng._programs) == 2 and eng.graph_stats["programs"] == 2
    drv.close()
    assert not eng._programs


def test_bias_table_slot_rows():
    table = BiasTable(5, "cpu", epochs=3)
    table.fill(7, taken=3)
    buf = table.buf.numpy().reshape(3, 5, 2)
    for e in range(3):
        for b in range(5):
            want = (bias_corrections(7 + 1 + e * 3 + b) if b < 3
                    else (1.0, 1.0))
            assert tuple(buf[e, b]) == pytest.approx(want, abs=0), (e, b)
        # a step of epoch e's slot b reads its row
        bc1, bc2 = table.at(table.epoch_count(e) + 1 + 2, 0.9, 0.999)
        assert (float(bc1), float(bc2)) == tuple(buf[e, 2])
    table.fill(0)
    assert float(table.buf[-1, 0]) == bias_corrections(15)[0]
    with pytest.raises(ValueError, match="not in this table"):
        table.at(16, 0.9, 0.999)


@pytest.mark.parametrize("fast", [True, False])
def test_skipped_slots_match_jax_scan_epoch(rng, fast):
    """An inner epoch with a slot table (3 of its 7 slots taken, as a
    period with fewer rows than the sweep's bound) against the JAX
    package's epoch over the same padded rows: tables, moments, losses
    (skipped slots 0) and the step count."""
    n_u, n_i, batch = 60, 40, 16
    jcfg, tcfg = _cfgs(fast_table_adam=fast)
    jeng, teng = JaxEngine(jcfg, n_u, n_i), SMLEngine(tcfg, n_u, n_i,
                                                      device="cpu")
    jstate = jeng.snapshot_last(jeng.init_state())
    tstate = carry_state(jstate)
    teng.shape_targets = jeng.shape_targets = {"set_t": 7 * batch}
    rows = _triples(rng, 40)
    jprep, tprep = jeng.prep_inner(rows), teng.prep_inner(rows)
    nb_max = tprep[0].rows.shape[0] // batch
    assert nb_max == 7 and num_batches(40, batch) == 3
    jstate, jl = jeng.inner_epoch(jstate, *jprep)

    slots = graphs.SlotTable(nb_max, "cpu")
    slots.fill(3)
    bias = BiasTable(nb_max, "cpu")
    bias.fill(tstate.mf_opt.count, 3)
    losses = torch.full((nb_max,), float("nan"))
    opt = tstate.mf_opt._replace(bias=bias, count=bias.epoch_count(0))
    teng._inner(tstate.mf, opt, tstate.theta, tstate.last_user,
                tstate.last_item, tprep[0].rows, tprep[0].mask, 0,
                tstate.gen, None, losses=losses, slots=slots)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), **TOL)
    assert (losses[3:] == 0).all()
    assert int(jstate.mf_opt[1].count) == tstate.mf_opt.count + 3
    jmu, jnu = jstate.mf_opt[1].mu, jstate.mf_opt[1].nu
    for f in ("user_emb", "item_emb", "user_bias", "item_bias"):
        np.testing.assert_allclose(getattr(tstate.mf, f).numpy(),
                                   np.asarray(getattr(jstate.mf, f)),
                                   err_msg=f, **TOL)
        np.testing.assert_allclose(tstate.mf_opt.mu[f].numpy(),
                                   np.asarray(getattr(jmu, f)),
                                   rtol=1e-5, atol=1e-7, err_msg=f)
        np.testing.assert_allclose(tstate.mf_opt.nu[f].numpy(),
                                   np.asarray(getattr(jnu, f)),
                                   rtol=1e-5, atol=1e-7, err_msg=f)


def test_period_index_values_are_device_scalars(rng):
    inter = np.stack([rng.integers(0, 500, 900), rng.integers(0, 300, 900)],
                     1)
    tidx = S.build_period_index(inter, 300, min_rows=2000, device="cpu")
    jidx = JS.build_period_index(inter, 300, min_rows=2000)
    for name in ("pool_size", "bloom_mask"):
        t, j = getattr(tidx, name), getattr(jidx, name)
        assert isinstance(t, torch.Tensor) and t.shape == ()
        assert t.dtype == torch.int64 and int(t) == int(j)
    users = torch.from_numpy(rng.integers(0, 500, 256))
    picked = S.sample_negatives(tidx, users, torch.Generator().manual_seed(4))
    assert set(picked.tolist()) <= set(np.unique(inter[:, 1]).tolist())


class _Direct:
    """The epochs called one by one, as the loops were before their
    programs: the program's interface over the bare epoch."""

    def __init__(self, epoch, site, mf, opt, padded, index, batch_size):
        self.epoch = epoch

    def run(self, mf, opt, padded, gen, index):
        return self.epoch(mf, opt, padded.rows, padded.mask, padded.n_real,
                          gen, index)


@pytest.mark.parametrize("fast", [False, True])
def test_pretrain_program_matches_the_epoch_loop(synthetic_dataset,
                                                 monkeypatch, fast):
    dspec, _, _ = synthetic_dataset
    period = dspec.online_test_start - 1
    monkeypatch.setattr(tpre, "resolve_fast_table_adam", lambda *a: fast)
    cfg = PretrainConfig(max_epochs=4, eval_every=2, latent_dim=8,
                         batch_size=128)
    site = graphs.GraphSite("cpu")
    got, gm = tpre.pretrain_mf(cfg, dspec, period, device="cpu", site=site)
    assert site.stats["programs"] == 1
    monkeypatch.setattr(tpre, "PlainEpochProgram", _Direct)
    want, wm = tpre.pretrain_mf(cfg, dspec, period, device="cpu")
    assert gm == wm
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("method", ["full", "fine"])
def test_offline_baseline_program_matches_the_epoch_loop(synthetic_dataset,
                                                         monkeypatch,
                                                         method):
    dspec, _, _ = synthetic_dataset
    cfg = BaselineConfig(method=method, epochs=3, batch_size=128,
                         latent_dim=8, start_period=dspec.online_test_start,
                         early_stop=True)
    runs = []
    for direct in (False, True):
        if direct:
            monkeypatch.setattr(tbase, "PlainEpochProgram", _Direct)
        drv = tbase.BaselineDriver(cfg, dspec, device="cpu")
        summary = drv.run(max_periods=3)
        runs.append((drv, summary))
    (prog, ps), (loop, ls) = runs
    assert prog.graph_stats["programs"] == 1
    assert loop.graph_stats["programs"] == 0
    assert ps == ls and prog.recall == loop.recall
    for a, b in zip(prog.mf, loop.mf):
        assert torch.equal(a, b)
    assert prog.opt.count == loop.opt.count
    for part in ("mu", "nu"):
        for k, t in getattr(prog.opt, part).items():
            assert torch.equal(t, getattr(loop.opt, part)[k]), (part, k)
    assert torch.equal(prog.gen.get_state(), loop.gen.get_state())
