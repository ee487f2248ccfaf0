"""The fused phase and period programs (``SMLEngine.phase_step`` /
``period_step``, the driver's fused branches) on the CPU, where a phase
runs eagerly: its plain version.

* The port's fused paths (``fuse_period=True``; ``fuse_phases=True`` with
  ``fuse_period=False``) against its own unfused path over the conftest
  synthetic dataset: tables, Θ, snapshots, Adam moments and counts, the
  generator's state, per-period metrics and every log record (kind,
  epoch or phase, order, values) bit-equal; with in-training evals, with
  ``log_norms``, and with the saddle guard made to stall (the same
  retries, the same kept trajectory).
* The port's fused period against ``sml_tpu``'s on the same numpy inputs in
  replay mode (Θ carried by ``theta_from_numpy``): tables, Θ and losses
  within rtol 1e-5 (``tests/test_torch_train.py``'s tolerance), the eval
  sums within one hit per K (near-ties may rank apart once the tables
  differ in the last bits); and both drivers' fused sweeps log the same
  record kinds in the same order.
* ``resolve_stacked_evals`` with ``keep``; the ``"auto"`` rule (a CPU
  engine runs unfused, under a gloo mesh too, where ``fuse_period=True``
  and ``False`` fuse); resume with fused periods.
"""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from sml_tpu.config import SMLConfig as JaxSMLConfig
from sml_tpu.config import TransferConfig as JaxTransferConfig
from sml_tpu.train.driver import SMLDriver as JaxDriver
from sml_tpu.train.engine import SMLEngine as JaxEngine
from sml_tpu_torch.config import SMLConfig, TransferConfig
from sml_tpu_torch.models.transfer import theta_leaves
from sml_tpu_torch.train.driver import SMLDriver, fusion_route
from sml_tpu_torch.train.engine import SMLEngine
from sml_tpu_torch.utils import checkpoint as ckpt

from test_torch_train import carry_state

D, H = 16, 64
UNFUSED = dict(fuse_phases=False, fuse_period=False)
TOL = dict(rtol=1e-5, atol=1e-5)


class RecordingLogger:
    """Keeps the records in memory, without their wall-clock fields."""

    def __init__(self):
        self.records = []

    def log(self, **record):
        record.pop("ts", None)
        record.pop("seconds", None)
        record.pop("total_seconds", None)
        self.records.append(record)

    def close(self):
        pass


def _cfg(**kw):
    base = dict(multi_num=3, mf_epochs=2, tr_epochs=2, mf_batch_size=256,
                tr_batch_size=128, eval_batch_size=256, latent_dim=D,
                mf_sample="alone", topk=(5, 10, 20), prefetch_periods=False)
    base.update(kw)
    return SMLConfig(transfer=TransferConfig(latent_dim=D, fc_hidden=H),
                     **base)


def _run(dataset, **kw):
    dspec, _, _ = dataset
    logger = RecordingLogger()
    drv = SMLDriver(_cfg(**kw), dspec, logger=logger, device="cpu")
    report = drv.run()
    return drv, report, logger.records


def _state_tensors(state):
    out = {f"mf/{f}": t for f, t in state.mf._asdict().items()}
    out.update({f"theta/{k}": p.detach()
                for k, p in theta_leaves(state.theta).items()})
    for f in ("last_user", "last_item", "hat_user", "hat_item"):
        out[f] = getattr(state, f)
    for opt in ("mf_opt", "tr_opt"):
        for part in ("mu", "nu"):
            for k, t in getattr(getattr(state, opt), part).items():
                out[f"{opt}/{part}/{k}"] = t
    return out


def _assert_same_run(a, b):
    (da, ra, la), (db, rb, lb) = a, b
    sa, sb = da.final_state, db.final_state
    ta, tb = _state_tensors(sa), _state_tensors(sb)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    assert (sa.mf_opt.count, sa.tr_opt.count) == \
        (sb.mf_opt.count, sb.tr_opt.count)
    assert sa.mf_opt.bias is None and sa.tr_opt.bias is None
    assert torch.equal(sa.gen.get_state(), sb.gen.get_state())
    assert ra.per_period == rb.per_period
    assert ra.per_period_ndcg == rb.per_period_ndcg
    assert ra.test_counts == rb.test_counts
    assert ra.saddle_retries_used == rb.saddle_retries_used
    assert la == lb


# the guard made to stall: the legacy rule with a threshold every loss
# passes, so attempt 0 stops at its check phase and the retry runs whole
STALL = dict(saddle_retries=1, saddle_mode="legacy", saddle_frac=0.0,
             saddle_check_phase=1)
CASES = {
    "period_evals": dict(fuse_period=True, eval_during_inner=True,
                         eval_during_outer=True),
    "period_norms": dict(fuse_period=True, log_norms=True),
    "period_guard": dict(fuse_period=True, log_norms=True,
                         eval_during_outer=True, **STALL),
    "phase_norms_guard": dict(fuse_phases=True, fuse_period=False,
                              log_norms=True, **STALL),
    "period_load_w_hat_bf16": dict(fuse_period=True, load_w_hat=True,
                                   snapshot_dtype="bfloat16",
                                   fast_table_adam=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_matches_unfused(synthetic_dataset, case):
    kw = dict(CASES[case])
    fused = _run(synthetic_dataset, **kw)
    for k in ("fuse_phases", "fuse_period"):
        kw.pop(k, None)
    unfused = _run(synthetic_dataset, **UNFUSED, **kw)
    _assert_same_run(fused, unfused)
    kinds = {r["kind"] for r in fused[2]}
    if "eval_during_outer" in kw:
        assert "outer_eval" in kinds
    if kw.get("log_norms"):
        assert "phase" in kinds
    if "saddle_retries" in kw:
        assert fused[1].saddle_retries_used == 1
        assert "saddle_retry" in kinds


def test_fused_routes_are_taken(synthetic_dataset, monkeypatch):
    """The fused runs above really went through the fused programs: count
    the engine's calls on a short sweep of each route."""
    calls = {"period_step": 0, "phase_step": 0}
    for name in calls:
        orig = getattr(SMLEngine, name)

        def counted(self, *a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(self, *a, **k)
        monkeypatch.setattr(SMLEngine, name, counted)
    dspec, _, _ = synthetic_dataset
    for kw in (dict(fuse_period=True), dict(fuse_period=False)):
        drv = SMLDriver(_cfg(**kw), dspec, device="cpu")
        drv.run(max_periods=2)
    # branch A, then branch C after its unfused phase 0
    assert calls["period_step"] == 2
    assert calls["phase_step"] == 3 + 2
    drv = SMLDriver(_cfg(), dspec, device="cpu")
    assert not drv.engine.fused_program_warm()
    assert not fusion_route(drv.cfg, drv.engine)


def _jax_cfgs(**kw):
    base = dict(latent_dim=8, mf_batch_size=16, tr_batch_size=8,
                eval_batch_size=16, replay_mode=True, multi_num=3,
                mf_epochs=2, tr_epochs=2, eval_during_inner=True,
                eval_during_outer=True, eval_scoring="gather")
    base.update(kw)
    return (JaxSMLConfig(transfer=JaxTransferConfig(latent_dim=8,
                                                    fc_hidden=32), **base),
            SMLConfig(transfer=TransferConfig(latent_dim=8, fc_hidden=32),
                      **base))


@pytest.mark.parametrize("fast", [True, False])
def test_fused_period_matches_jax_replay(rng, fast):
    n_u, n_i = 60, 40
    jcfg, tcfg = _jax_cfgs(fast_table_adam=fast)
    jeng = JaxEngine(jcfg, n_u, n_i)
    teng = SMLEngine(tcfg, n_u, n_i, device="cpu")
    jstate = jeng.snapshot_last(jeng.init_state())
    tstate = carry_state(jstate)

    def triples(n):
        return np.stack([rng.integers(0, n_u, n), rng.integers(0, n_i, n),
                         rng.integers(0, n_i, n)], 1).astype(np.int64)
    inner, outer = triples(70), triples(30)
    users = rng.permutation(n_u)[:40]
    cands = np.stack([rng.permutation(n_i)[:10] for _ in users])
    val = np.concatenate([users[:, None], cands], 1).astype(np.int64)
    jval, tval = jeng.make_eval_set(val), teng.make_eval_set(val)
    for n_phases in (3, 2):
        jstate, jev, (jil, jol), _ = jeng.period_step(
            jstate, jeng.prep_inner(inner), jeng.prep_outer(outer),
            n_phases, jval)
        tstate, tev, (til, tol), _ = teng.period_step(
            tstate, teng.prep_inner(inner), teng.prep_outer(outer),
            n_phases, tval)
        np.testing.assert_allclose(til.numpy(),
                                   np.asarray(jil)[:n_phases], **TOL)
        np.testing.assert_allclose(tol.numpy(),
                                   np.asarray(jol)[:n_phases], **TOL)
        assert tstate.mf_opt.count == int(jstate.mf_opt[1].count)
        assert tstate.tr_opt.count == int(jstate.tr_opt[1].count)
        for f in ("user_emb", "item_emb", "user_bias", "item_bias"):
            np.testing.assert_allclose(getattr(tstate.mf, f).numpy(),
                                       np.asarray(getattr(jstate.mf, f)),
                                       err_msg=f, **TOL)
        jl = [np.asarray(x) for x in jax.tree.leaves(jstate.theta)]
        for (name, p), want in zip(theta_leaves(tstate.theta).items(), jl):
            np.testing.assert_allclose(p.detach().numpy(), want,
                                       err_msg=name, **TOL)
        keep = n_phases if n_phases < tcfg.multi_num else None
        jrec = jeng.resolve_stacked_evals([(jev, 40, keep)])[0]
        trec = teng.resolve_stacked_evals([(tev, 40, keep)])[0]
        assert [(k, e) for k, e, _ in trec] == [(k, e) for k, e, _ in jrec]
        assert len(trec) == n_phases * 4
        for (_, _, tm), (_, _, jm) in zip(trec, jrec):
            for k in tcfg.topk:
                assert abs(tm[k]["recall"] - jm[k]["recall"]) * 40 <= 1.0


def test_fused_sweep_records_match_jax(synthetic_dataset):
    """Both drivers' fused sweeps (two passes, evals, diagnostics): the
    same record kinds in the same order (random streams differ by design,
    so values are not compared)."""
    dspec, _, _ = synthetic_dataset
    kw = dict(latent_dim=8, multi_num=3, mf_sample="alone",
              mf_batch_size=64, tr_batch_size=64, eval_batch_size=64,
              log_norms=True, eval_during_outer=True, pass_num=2,
              fuse_period=True)
    jl, tl = RecordingLogger(), RecordingLogger()
    JaxDriver(JaxSMLConfig(transfer=JaxTransferConfig(latent_dim=8,
                                                      fc_hidden=32), **kw),
              dspec, logger=jl).run()
    SMLDriver(SMLConfig(transfer=TransferConfig(latent_dim=8,
                                                fc_hidden=32), **kw),
              dspec, logger=tl, device="cpu").run()

    def shape(records):
        return [(r["kind"], r.get("epoch"), r.get("phase"), r.get("period"))
                for r in records]
    assert shape(tl.records) == shape(jl.records)
    assert {"phase", "outer_eval", "test"} <= {r["kind"]
                                               for r in tl.records}


def test_resolve_stacked_evals_keeps_the_run_phases():
    teng = SMLEngine(_cfg(topk=(5, 10)), 30, 20, device="cpu")
    hits = torch.arange(12, dtype=torch.float32).reshape(3, 2, 2)
    evals = {"inner": {5: (hits[:, :, 0], hits[:, :, 0] / 2),
                       10: (hits[:, :, 1], hits[:, :, 1] / 2)},
             "outer": {5: (hits[:, :1, 0] + 100, hits[:, :1, 0]),
                       10: (hits[:, :1, 1] + 100, hits[:, :1, 1])}}
    full, kept = teng.resolve_stacked_evals([(evals, 4), (evals, 4, 2)])
    assert [(k, e) for k, e, _ in full] == \
        [("inner_eval", 0), ("inner_eval", 1), ("outer_eval", 0)] * 3
    assert kept == full[:6]
    k, e, m = full[7]
    assert (k, e) == ("inner_eval", 1)
    assert m[5] == {"recall": float(hits[2, 1, 0]) / 4,
                    "ndcg": float(hits[2, 1, 0] / 2) / 4}
    assert full[5][2][10]["recall"] == float(hits[1, 0, 1] + 100) / 4
    assert teng.resolve_stacked_evals([]) == []


def test_auto_rule_and_mesh(synthetic_dataset, tmp_path):
    dspec, _, _ = synthetic_dataset
    auto = SMLDriver(_cfg(), dspec, device="cpu")
    assert not auto.engine.fused_program_warm()
    assert not fusion_route(auto.cfg, auto.engine)
    assert not auto._can_fuse(None)
    forced = SMLDriver(_cfg(fuse_period=True), dspec, device="cpu")
    assert fusion_route(forced.cfg, forced.engine)
    assert forced._can_fuse_period(object())
    off = SMLDriver(_cfg(fuse_phases=False, fuse_period=True), dspec,
                    device="cpu")
    assert not fusion_route(off.cfg, off.engine)
    from sml_tpu_torch.parallel.sharding import make_mesh
    state = forced.engine.init_state()
    rows = np.zeros((4, 2), np.int64)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1, 1)
        for drv in (auto, forced):
            drv.engine.set_mesh(mesh)
        # under a gloo mesh on the CPU: "auto" stays unfused, True and
        # False fuse (a program runs eagerly, its plain version)
        assert not auto.engine.fused_program_warm()
        assert not fusion_route(auto.cfg, auto.engine)
        assert forced.engine.capture_refusal() is None
        assert forced._can_fuse_period(object())
        unfused = SMLDriver(_cfg(fuse_period=False), dspec, device="cpu")
        unfused.engine.set_mesh(mesh)
        assert unfused._can_fuse(None) and not unfused._can_fuse_period(
            object())
        eng = forced.engine
        _, il, ol = eng.phase_step(state, eng.prep_inner(rows),
                                   eng.prep_outer(rows))
        assert torch.isfinite(il).all() and torch.isfinite(ol).all()
        assert eng.graph_stats["programs"] == 1
    finally:
        dist.destroy_process_group()


def test_resume_with_fused_periods(synthetic_dataset, tmp_path):
    """A sweep stopped after two fused periods and resumed from its
    checkpoint reproduces the uninterrupted fused sweep's metrics."""
    dspec, _, _ = synthetic_dataset
    cfg = _cfg(multi_num=2, fuse_period=True, eval_during_inner=True,
               eval_during_outer=True)
    full = SMLDriver(cfg, dspec, device="cpu")
    report = full.run()
    assert len(report.test_counts) == 3

    first = SMLDriver(cfg, dspec, device="cpu")
    state = first.engine.init_state()
    first.feeder.reinit()
    for d_time in range(2):
        state, ok = first.run_period(state, d_time)
        assert ok
    ckpt.save_checkpoint(str(tmp_path / "ck"), 1, state)
    first.finalize()

    second = SMLDriver(cfg, dspec, device="cpu")
    state = ckpt.state_from_checkpoint(str(tmp_path / "ck"), device="cpu")
    second.feeder.reinit()
    d_time = 0
    while True:
        if d_time > 1:
            state, ok = second.run_period(state, d_time)
            if not ok:
                break
        else:
            second.feeder.next_train(d_time)
        d_time += 1
    second.finalize()
    for k, vals in report.per_period.items():
        merged = (first.report.per_period.get(k, [])
                  + second.report.per_period.get(k, []))
        assert merged == vals, k
    assert (first.report.test_counts + second.report.test_counts
            == report.test_counts)


def test_every_counted_wrapper_is_registered():
    """A capture takes back and every replay adds the launches of the
    wrappers in ``_build.COUNTED``: every function of ``ops/`` that counts
    its launches is there, once (a wrapper missing from the list would
    keep its capture-time count and gain nothing at replays)."""
    import importlib
    import inspect
    import pkgutil

    from sml_tpu_torch import _build, ops
    found = []
    for info in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"sml_tpu_torch.ops.{info.name}")
        found += [f for _, f in inspect.getmembers(mod, inspect.isfunction)
                  if f.__module__ == mod.__name__ and hasattr(f, "launches")]
    assert len(found) == 6
    assert sorted(map(id, found)) == sorted(map(id, _build.COUNTED))
