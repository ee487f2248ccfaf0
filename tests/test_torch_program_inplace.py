"""The fused programs on the state's own buffers (``SMLEngine.adopt``), as
the JAX package's programs run on their donated state, on the CPU:

* a period runs on the caller's tables, snapshots, Θ and moments
  (``data_ptr``), copies nothing into them, and a second period (its
  ``snapshot_last``, the period, the final refresh) makes no tensor of a
  table's shape by a copy or an allocation;
* two program keys (in-training evals on, then off) run their bodies on
  one set of state buffers; releasing the programs leaves the state as it
  was; a state handed in with new tables is copied into the slot and the
  program runs on the slot;
* two fused periods with branch C's eager phase 0 between them against
  ``sml_tpu``'s donated ``period_step`` in replay mode, with dense and
  with row-sparse (K3) table Adam: tables, Θ and losses within rtol 1e-5
  (``tests/test_torch_fused.py``'s tolerance);
* ``scripts/scale_sweep.py`` on two gloo ranks at a tiny shape: every
  rank's fused digests equal its eager ones, exit 0; its launch
  derivation (``sweep_launches``) against the K3 and K1 entry points'
  calls in a sweep with saddle retries, eager and fused.
"""

import json

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from sml_tpu.config import SMLConfig as JaxSMLConfig
from sml_tpu.config import TransferConfig as JaxTransferConfig
from sml_tpu.train.engine import SMLEngine as JaxEngine
from sml_tpu_torch.config import SMLConfig, TransferConfig
from sml_tpu_torch.models.mf import with_tables
from sml_tpu_torch.models.transfer import theta_leaves
from sml_tpu_torch.scripts import scale_sweep
from sml_tpu_torch.scripts.program_stress import state_tensors
from sml_tpu_torch.train import engine as engine_mod
from sml_tpu_torch.train.engine import SMLEngine

from test_torch_train import carry_state

N_U, N_I, D, H = 60, 40, 8, 32
TOL = dict(rtol=1e-5, atol=1e-5)
STATE_GROUPS = ("tables", "snapshots", "theta", "moments")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _base(**kw):
    base = dict(latent_dim=D, mf_batch_size=16, tr_batch_size=8,
                eval_batch_size=16, replay_mode=True, multi_num=2,
                mf_epochs=1, tr_epochs=1, fast_table_adam=True,
                eval_scoring="gather")
    base.update(kw)
    return base


def _engine(**kw):
    return SMLEngine(SMLConfig(transfer=TransferConfig(latent_dim=D,
                                                       fc_hidden=H),
                               **_base(**kw)), N_U, N_I, device="cpu")


def _triples(rng, n):
    return np.stack([rng.integers(0, N_U, n), rng.integers(0, N_I, n),
                     rng.integers(0, N_I, n)], 1).astype(np.int64)


def _inputs(eng, seed=0):
    rng = np.random.default_rng(seed)
    inner, outer = _triples(rng, 70), _triples(rng, 30)
    users = rng.permutation(N_U)[:40]
    cands = np.stack([rng.permutation(N_I)[:10] for _ in users])
    val = np.concatenate([users[:, None], cands], 1).astype(np.int64)
    return eng.prep_inner(inner), eng.prep_outer(outer), \
        eng.make_eval_set(val)


def _leaves(state) -> dict:
    """The state's tensors by name, without the generator's state (a new
    tensor at each read)."""
    return {k: t for k, t in state_tensors(state).items() if k != "gen"}


def _ptrs(state) -> dict:
    return {k: t.data_ptr() for k, t in _leaves(state).items()}


class TableShapedCopies(TorchDispatchMode):
    """Records every op that copies a tensor or makes a new buffer for one
    (``clone``, ``_to_copy``, ``empty``...) whose output has one of
    ``shapes``: a snapshot or a refresh into new tables, a state copy.
    The plain versions' arithmetic temporaries are not such ops."""

    OPS = {"clone", "_to_copy", "empty", "empty_like", "empty_strided",
           "new_empty", "new_empty_strided"}

    def __init__(self, shapes):
        super().__init__()
        self.shapes = set(shapes)
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if (name in self.OPS and isinstance(out, torch.Tensor)
                and tuple(out.shape) in self.shapes):
            self.seen.append((name, tuple(out.shape)))
        return out


def test_a_period_runs_on_the_callers_buffers():
    eng = _engine()
    prep_t, prep_tt, _ = _inputs(eng)
    state = eng.snapshot_last(eng.init_state())
    ptrs = _ptrs(state)
    state = eng.period_step(state, prep_t, prep_tt, 2)[0]
    assert _ptrs(state) == ptrs
    assert all(eng.slot_copies[g] == 0 for g in STATE_GROUPS)
    tables = {tuple(t.shape) for t in state.mf if t.shape[-1] == D}
    with TableShapedCopies(tables) as log:
        state = eng.snapshot_last(state)
        state = eng.period_step(state, prep_t, prep_tt, 2)[0]
        state = eng.refresh(state)
    assert log.seen == []
    assert _ptrs(state) == ptrs
    assert all(eng.slot_copies[g] == 0 for g in STATE_GROUPS)
    assert eng.slot_copies["inputs"] > 0


def test_two_program_keys_run_on_one_slot(monkeypatch):
    eng = _engine(eval_during_inner=True, eval_during_outer=True)
    prep_t, prep_tt, val = _inputs(eng)
    state = eng.snapshot_last(eng.init_state())
    ptrs = list(_ptrs(state).values())
    seen = []
    body = engine_mod._PhaseProgram.body

    def recorded(self, gen):
        seen.append([t.data_ptr()
                     for t in engine_mod._state_tensors(self.eng._slot)])
        return body(self, gen)
    monkeypatch.setattr(engine_mod._PhaseProgram, "body", recorded)
    state = eng.period_step(state, prep_t, prep_tt, 2, val)[0]
    state = eng.period_step(state, prep_t, prep_tt, 2)[0]
    assert len(eng._programs) == 2 and eng.graph_stats["programs"] == 2
    assert len(seen) == 4 and all(sorted(s) == sorted(ptrs) for s in seen)
    assert all(eng.slot_copies[g] == 0 for g in STATE_GROUPS)
    # releasing the programs leaves the state's buffers and values alone
    values = {k: t.detach().clone() for k, t in _leaves(state).items()}
    eng.release_programs()
    assert eng._slot is None and not eng._programs
    assert all(torch.equal(t, values[k]) for k, t in _leaves(state).items())
    assert sorted(_ptrs(state).values()) == sorted(ptrs)


def test_new_tables_are_copied_into_the_slot():
    """A state handed in with tables of its own (a refresh into new
    buffers): they are copied into the slot, the program runs on the slot,
    and the result equals the same period from a copy on another engine
    (the stale-storage fault would leave the new tables untrained)."""
    eng, ref_eng = _engine(), _engine()
    prep_t, prep_tt, _ = _inputs(eng)
    state = eng.snapshot_last(eng.init_state())
    ptrs = _ptrs(state)
    state = eng.period_step(state, prep_t, prep_tt, 1)[0]
    moved = state._replace(mf=with_tables(
        state.mf, state.mf.user_emb.clone(), state.mf.item_emb.clone()))
    ref = engine_mod.copy_state(moved)
    got = eng.period_step(moved, prep_t, prep_tt, 2)[0]
    want = ref_eng.period_step(ref, prep_t, prep_tt, 2)[0]
    assert _ptrs(got) == ptrs
    assert eng.slot_copies["tables"] == sum(
        t.numel() * t.element_size()
        for t in (state.mf.user_emb, state.mf.item_emb))
    assert not torch.equal(got.mf.user_emb, moved.mf.user_emb)
    for k, t in _leaves(got).items():
        assert torch.equal(t, _leaves(want)[k]), k


def _jax_cfgs(fast: bool):
    base = _base(fast_table_adam=fast)
    return (JaxSMLConfig(transfer=JaxTransferConfig(latent_dim=D,
                                                    fc_hidden=H), **base),
            SMLConfig(transfer=TransferConfig(latent_dim=D, fc_hidden=H),
                      **base))


def test_two_fused_periods_with_an_eager_phase_match_jax():
    """Dense table Adam (the autograd path)."""
    _two_periods_against_jax(fast=False)


def test_two_fused_periods_on_the_fast_adam_path_match_jax():
    """Row-sparse table Adam, the scale sweeps' route: K3 decays the
    tables and moments in place on the slot in the programs and in the
    eager phase between them (its plain version here), against the JAX
    package's row-sparse path (its Pallas kernel in interpret mode)."""
    _two_periods_against_jax(fast=True)


def _two_periods_against_jax(fast: bool):
    """Period 1: the fused period; period 2: branch C's phase 0 eagerly
    (inner epoch, hat snapshot, refresh, outer epoch, refresh), then the
    rest fused; a final refresh after each. The port's eager calls write
    into the programs' slot and its programs run on it; ``sml_tpu``'s
    donate their state."""
    jcfg, tcfg = _jax_cfgs(fast)
    jeng, teng = JaxEngine(jcfg, N_U, N_I), SMLEngine(tcfg, N_U, N_I,
                                                      device="cpu")
    # one compile of the whole init rather than one per op (the same
    # values, in a few seconds less)
    jstate = jax.jit(jeng.init_state)()
    # the driver's run adopts its state before the period's first snapshot
    tstate = teng.adopt(carry_state(jstate))
    ptrs = _ptrs(tstate)
    rng = np.random.default_rng(3)
    losses = []

    def both(fn):
        nonlocal jstate, tstate
        jstate, jl = fn(jeng, jstate)
        tstate, tl = fn(teng, tstate)
        for j, t in zip(jl, tl):
            losses.append((np.asarray(j), t.numpy()))

    def fused(n):
        def run(eng, st):
            st, _, (il, ol), _ = eng.period_step(st, p_t[eng], p_tt[eng], n)
            return st, (il[:n], ol[:n])
        return run

    def eager_phase(eng, st):
        st, il = eng.inner_epoch(st, *p_t[eng])
        st = eng.refresh(eng.snapshot_hat(st))
        st, ol = eng.outer_epoch(st, *p_tt[eng])
        return eng.refresh(st), (il, ol)

    def plain(op):
        return lambda eng, st: (getattr(eng, op)(st), ())
    for period in range(2):
        inner, outer = _triples(rng, 70), _triples(rng, 30)
        p_t = {jeng: jeng.prep_inner(inner), teng: teng.prep_inner(inner)}
        p_tt = {jeng: jeng.prep_outer(outer), teng: teng.prep_outer(outer)}
        both(plain("snapshot_last"))
        if period == 0:
            both(fused(tcfg.multi_num))
        else:
            both(eager_phase)
            both(fused(tcfg.multi_num - 1))
        both(plain("refresh"))
    assert _ptrs(tstate) == ptrs
    assert all(teng.slot_copies[g] == 0 for g in STATE_GROUPS)
    assert len(losses) == 6
    for j, t in losses:
        np.testing.assert_allclose(t, j, **TOL)
    assert tstate.mf_opt.count == int(jstate.mf_opt[1].count)
    assert tstate.tr_opt.count == int(jstate.tr_opt[1].count)
    for f in ("user_emb", "item_emb", "user_bias", "item_bias"):
        np.testing.assert_allclose(getattr(tstate.mf, f).numpy(),
                                   np.asarray(getattr(jstate.mf, f)),
                                   err_msg=f, **TOL)
    jl = [np.asarray(x) for x in jax.tree.leaves(jstate.theta)]
    for (name, p), want in zip(theta_leaves(tstate.theta).items(), jl):
        np.testing.assert_allclose(p.detach().numpy(), want, err_msg=name,
                                   **TOL)


def test_scale_sweep_on_two_gloo_ranks(capsys):
    rc = scale_sweep.main(["--device", "cpu", "--devices", "2",
                           "--users", "400", "--items", "200",
                           "--periods", "3", "--inter", "800", "--neg", "49",
                           "--latent", "16", "--multi-num", "2",
                           "--saddle-retries", "1"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0 and doc["failed"] == []
    assert len(doc["ranks"]) == 2
    for rank in doc["ranks"]:
        checks = rank["checks"]
        assert checks["digests_equal"] and checks["digest_blocks"] > 0
        assert checks["hits_equal"] and checks["losses_equal"]
        assert rank["eager"]["digest"] == rank["fused"]["digest"]
        assert rank["fused"]["route"] == "fused"
        # the phase program and the test period's phase-0 epoch programs
        assert rank["fused"]["graphs"]["programs"] == 3
        assert len(rank["fused"]["recall@20"]) == 1


@pytest.mark.parametrize("run", scale_sweep.RUNS)
def test_sweep_launches_count_the_kernel_calls(tmp_path, monkeypatch, run):
    """``scale_sweep.sweep_launches`` (which ``chip_smoke.py`` also derives
    its sweeps' launches with), from the configuration, the data and the
    guard's reported retries, against the K3 and K1 entry points' calls in
    a sweep on the CPU (their plain versions) with saddle retries."""
    from sml_tpu_torch.data.formats import row_count
    from sml_tpu_torch.ops import transfer_kernel
    from sml_tpu_torch.train import optim
    from sml_tpu_torch.train.driver import SMLDriver
    from sml_tpu_torch.utils.logging import MetricsLogger
    calls = dict.fromkeys(("decay_adam_kernel", "transfer_rows_kernel"), 0)

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(optim, "fused_decay_adam_multi", counted(
        "decay_adam_kernel", optim.fused_decay_adam_multi))
    monkeypatch.setattr(transfer_kernel, "fused_table_transfer", counted(
        "transfer_rows_kernel", transfer_kernel.fused_table_transfer))
    args = scale_sweep.build_parser().parse_args(
        ["--device", "cpu", "--users", "300", "--items", "150",
         "--periods", "3", "--inter", "600", "--neg", "49", "--latent", "8",
         "--multi-num", "3", "--saddle-retries", "2"])
    spec, _ = scale_sweep.write_data(args, str(tmp_path))
    fuse = (dict(fuse_phases=False, fuse_period=False) if run == "eager"
            else dict(fuse_period=True))
    cfg = scale_sweep.sweep_config(args).replace(
        fast_table_adam=True, transfer=TransferConfig(latent_dim=8,
                                                      fc_hidden=16), **fuse)
    drv = SMLDriver(cfg, spec, logger=MetricsLogger(None), device="cpu")
    report = drv.run(drv.engine.init_state())
    drv.close()
    assert report.saddle_retries_used > 0
    wants = [scale_sweep.sweep_launches(
        spec, drv.engine.cfg, lambda kind, t: row_count(spec.path, kind, t),
        True, stalled_phases=n)
        for n in scale_sweep.stalled_phase_counts(
            cfg, report.saddle_retries_used, run == "fused")]
    if run == "fused":
        assert len(wants) == 1
    assert any(calls == {k: w[k] for k in calls} for w in wants), \
        (calls, wants)
