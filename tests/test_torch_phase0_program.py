"""Branch C's phase 0 through its epoch programs (``SMLEngine.inner_epoch``
/ ``outer_epoch`` with ``program=True``, ``train/engine.py``
``_EpochProgram``) on the CPU, where a program runs eagerly: its plain
version.

* A branch-C period through ``run_period`` with ``fuse_period=True`` (phase
  0's epochs through their programs, the other phases through the phase
  program) equals the same period with ``fuse_period=False`` bit for bit:
  tables, snapshots, Θ, moments, counts, the generator and each phase-0
  epoch's losses, at one and two inner and outer epochs.
* The losses an epoch program returned stay as they were when the next
  period runs it again.
* One program per (kind, shape key), kept from period to period and freed
  by ``release_programs``; the phase program and the epoch programs run on
  one set of input buffers per epoch kind, into which a period's inputs
  are copied once.
* Phase 0's epochs go through their programs only where the period fuses
  (``fuse_period=True``), and eagerly under ``"auto"`` on the CPU, with
  ``fuse_period=False`` and with ``fuse_phases=False``;
  ``graph_stats["program_phase0_epochs"]`` counts those through programs.
* The outer epoch differentiates no parameter of the state's Θ itself, so
  no graph into Θ that a caller holds reaches a captured step (fault 15),
  and its updates land in Θ's storage.
"""

import numpy as np
import pytest
import torch

from sml_tpu_torch.config import DataSpec, SMLConfig, TransferConfig
from sml_tpu_torch.data.formats import DatasetInfo, write_dataset
from sml_tpu_torch.train.driver import SMLDriver
from sml_tpu_torch.train.engine import _state_tensors

N_USERS, N_ITEMS, NEG = 120, 80, 12
TRAIN_ROWS = (260, 200, 300, 230, 270)
TEST_ROWS = (40, 31, 52, 37, 45)
PERIODS = 3                       # branch A, then two branch C periods


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    """Five periods whose train and test row counts differ; the sweep's
    period 0 (train period 1) warms up, its periods 1 and 2 test."""
    rng = np.random.default_rng(5)
    train, test = [], {}
    for p, (n, m) in enumerate(zip(TRAIN_ROWS, TEST_ROWS)):
        train.append(np.stack([rng.integers(0, N_USERS, n),
                               rng.integers(0, N_ITEMS, n)], 1))
        negs = np.stack([rng.choice(N_ITEMS, NEG, replace=False)
                         for _ in range(m)])
        test[p] = np.concatenate([rng.integers(0, N_USERS, (m, 1)),
                                  rng.integers(0, N_ITEMS, (m, 1)), negs],
                                 axis=1)
    root = tmp_path_factory.mktemp("phase0")
    write_dataset(str(root / "synth"), train, test,
                  DatasetInfo(sum(TRAIN_ROWS), N_USERS, N_ITEMS))
    return DataSpec(root=str(root), name="synth", num_periods=5,
                    online_train_start=1, online_test_start=3,
                    eval_neg_num=NEG)


def _driver(spec, **kw):
    base = dict(multi_num=2, mf_epochs=1, tr_epochs=1, mf_batch_size=64,
                tr_batch_size=32, eval_batch_size=64, latent_dim=8,
                mf_sample="alone", topk=(5, 10), prefetch_periods=False,
                fast_table_adam=True, saddle_retries=0)
    base.update(kw)
    cfg = SMLConfig(transfer=TransferConfig(latent_dim=8, fc_hidden=16),
                    **base)
    return SMLDriver(cfg, spec, device="cpu")


def _sweep(drv, periods=PERIODS):
    """``periods`` periods through ``run_period``; returns the state after
    each (copied) and each period's epoch calls ``(kind, program, losses,
    a copy of the losses when they were returned)`` in order."""
    eng, calls = drv.engine, []
    for kind in ("inner", "outer"):
        orig = getattr(eng, f"{kind}_epoch")

        def recorded(*a, _orig=orig, _kind=kind, **k):
            st, losses = _orig(*a, **k)
            calls[-1].append((_kind, k.get("program", False), losses,
                              losses.clone()))
            return st, losses
        setattr(eng, f"{kind}_epoch", recorded)
    state = eng.init_state()
    drv.feeder.reinit()
    states = []
    for d in range(periods):
        calls.append([])
        state, ok = drv.run_period(state, d)
        assert ok
        states.append(_copied(state))
    drv.finalize()
    return state, states, calls


def _copied(state):
    return ([t.detach().clone() for t in _state_tensors(state)],
            (state.mf_opt.count, state.tr_opt.count), state.gen.get_state())


@pytest.mark.parametrize("mf_epochs,tr_epochs", [(1, 1), (1, 2), (2, 1),
                                                 (2, 2)])
def test_phase0_programs_match_the_eager_phase0(spec, mf_epochs, tr_epochs):
    runs = {}
    for name, fuse in (("program", dict(fuse_period=True)),
                       ("eager", dict(fuse_period=False))):
        drv = _driver(spec, mf_epochs=mf_epochs, tr_epochs=tr_epochs,
                      **fuse)
        runs[name] = _sweep(drv) + (drv.report,)
        drv.close()
    (_, got, got_calls, got_rep), (_, want, want_calls, want_rep) = \
        runs["program"], runs["eager"]
    n0 = mf_epochs + tr_epochs
    for d in range(PERIODS):
        (gt, gc, gg), (wt, wc, wg) = got[d], want[d]
        assert len(gt) == len(wt)
        for i, (a, b) in enumerate(zip(gt, wt)):
            assert torch.equal(a, b), (d, i)
        assert gc == wc and torch.equal(gg, wg), d
        if d == 0:
            # branch A: one fused period, no epoch call
            assert got_calls[d] == []
            continue
        # branch C: phase 0's epochs, each through its program, against
        # the eager phase 0 (the first of the eager period's phases)
        kinds = ["inner"] * mf_epochs + ["outer"] * tr_epochs
        assert [c[:2] for c in got_calls[d]] == [(k, True) for k in kinds]
        assert [c[:2] for c in want_calls[d][:n0]] == \
            [(k, False) for k in kinds]
        for a, b in zip(got_calls[d], want_calls[d]):
            assert torch.equal(a[2], b[2]), d
    assert got_rep.per_period == want_rep.per_period
    assert got_rep.test_counts == want_rep.test_counts == [37, 45]


def test_returned_losses_survive_the_next_period(spec):
    drv = _driver(spec, fuse_period=True)
    _, _, calls = _sweep(drv)
    bufs = [p.buf.losses for k, p in drv.engine._programs.items()
            if k[0] in ("inner", "outer")]
    assert len(bufs) == 2
    # period 1's losses, read after period 2 ran the same programs
    for _, program, losses, at_return in calls[1]:
        assert program and torch.equal(losses, at_return)
        assert all(losses.data_ptr() != b.data_ptr() for b in bufs)
    assert any(not torch.equal(a[2], b[2])
               for a, b in zip(calls[1], calls[2]))
    drv.close()


def test_epoch_programs_are_kept_across_periods_and_released(spec):
    drv = _driver(spec, fuse_period=True, mf_epochs=2, tr_epochs=2)
    eng = drv.engine
    state = eng.init_state()
    drv.feeder.reinit()
    seen = []
    for d in range(PERIODS):
        state, ok = drv.run_period(state, d)
        assert ok
        seen.append(dict(eng._programs))
    kinds = sorted(str(k[0]) for k in eng._programs)
    assert kinds == ["False", "inner", "outer"]
    # the same program objects in both branch-C periods
    assert seen[1] == seen[2] and len(seen[2]) == 3
    assert eng.graph_stats["programs"] == 3
    for (kind, _), prog in ((k, p) for k, p in eng._programs.items()
                            if k[0] in ("inner", "outer")):
        assert prog.span == "epoch_launch"
        assert prog.buf.slots.host.shape[0] == prog.buf.losses.shape[0]
    eng.release_programs()
    assert not eng._programs and not eng._buffers and eng._slot is None
    drv.close()


def test_a_periods_inputs_have_one_copy(spec):
    drv = _driver(spec, fuse_period=True, mf_epochs=2, tr_epochs=2)
    eng = drv.engine
    state = eng.init_state()
    drv.feeder.reinit()
    copied = []
    for d in range(PERIODS):
        before = eng.slot_copies["inputs"]
        state, ok = drv.run_period(state, d)
        assert ok
        copied.append(eng.slot_copies["inputs"] - before)
    (phase,) = (p for k, p in eng._programs.items() if k[0] is False)
    epoch = {k[0]: p for k, p in eng._programs.items() if k[0] is not False}
    assert epoch["inner"].buf is phase.t and epoch["outer"].buf is phase.tt
    assert sorted(k[0] for k in eng._buffers) == ["inner", "outer"]
    # each period copies its set_t and set_tt pools in once (the val set
    # in fused periods too), whether or not phase 0's epochs loaded them
    per_copy = sum(x.numel() * x.element_size()
                   for buf in (phase.t, phase.tt)
                   for x in (buf.prep[0].rows, buf.prep[0].mask, *(
                       buf.prep[1] if buf.prep[1] is not None else ())))
    val = sum(x.numel() * x.element_size() for x in phase.ev or ()
              if x is not None)
    assert copied == [per_copy + val] * PERIODS
    drv.close()


ROUTES = {
    "fused": (dict(fuse_period=True), True),
    "auto_on_the_cpu": (dict(), False),
    "phases_only": (dict(fuse_phases=True, fuse_period=False), False),
    "unfused": (dict(fuse_phases=False, fuse_period=False), False),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_phase0_epochs_counted_by_route(spec, route):
    kw, program = ROUTES[route]
    drv = _driver(spec, mf_epochs=2, tr_epochs=1, **kw)
    _, _, calls = _sweep(drv)
    stats = drv.engine.graph_stats
    epochs = 2 * (2 + 1)             # two branch C periods
    # phase 0's epochs, the first three epoch calls of a branch-C period
    assert [c[1] for d in (1, 2) for c in calls[d][:3]] == \
        [program] * epochs
    assert stats["program_phase0_epochs"] == (epochs if program else 0)
    assert stats["programs"] == (3 if program else
                                 1 if route == "phases_only" else 0)
    drv.close()



@pytest.mark.parametrize("program", [False, True])
def test_outer_epoch_reaches_no_graph_a_caller_holds(monkeypatch, program):
    from sml_tpu_torch.models.transfer import theta_leaves
    from sml_tpu_torch.train.engine import SMLEngine
    cfg = SMLConfig(transfer=TransferConfig(latent_dim=8, fc_hidden=16),
                    latent_dim=8, tr_batch_size=32, mf_sample="alone")
    eng = SMLEngine(cfg, N_USERS, N_ITEMS, device="cpu")
    state = eng.snapshot_hat(eng.snapshot_last(eng.init_state()))
    rng = np.random.default_rng(3)
    prep = eng.prep_outer(np.stack([rng.integers(0, N_USERS, 100),
                                    rng.integers(0, N_ITEMS, 100)], 1))
    theta = theta_leaves(state.theta)
    held = [p.clone() for p in theta.values()]      # tracks gradients
    assert all(h.grad_fn is not None for h in held)
    before = [p.detach().clone() for p in theta.values()]
    differentiated = []
    grad = torch.autograd.grad

    def recorded(outputs, inputs, *a, **k):
        differentiated.extend(inputs)
        return grad(outputs, inputs, *a, **k)
    monkeypatch.setattr(torch.autograd, "grad", recorded)
    state, _ = eng.outer_epoch(state, *prep, program=program)
    assert len(differentiated) == 4 * len(theta)     # four steps
    assert not any(x is p for x in differentiated for p in theta.values())
    # the steps wrote Θ's own storage
    after = theta_leaves(state.theta)
    assert all(a is p for a, p in zip(after.values(), theta.values()))
    assert all(not torch.equal(p, b) for p, b in zip(theta.values(), before))
    eng.release_programs()
