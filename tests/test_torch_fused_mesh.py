"""The fused phase and period programs under a mesh, on gloo worlds of CPU
ranks, at the sizes of ``tests/test_torch_multihost.py`` (320 users, 160
items, d=16, H=64). On the CPU a program runs eagerly (its plain version)
on the rank's row blocks and the whole padded batch, its collectives
inside it.

* On meshes (1, 2), (2, 1) and (2, 2), in one spawned world per mesh: the
  driver's sweep fused by period (in-program evals, ``log_norms``, the
  saddle guard made to stall) and fused phase by phase (``fuse_phases``,
  ``fuse_period=False``; ``log_norms``, the stalled guard) against the
  unfused sharded path in the same world: tables, snapshots, Θ, Adam
  moments, counts, the generator and every log record bit-equal.
* ``period_step`` on those meshes against ``sml_tpu``'s in replay mode on
  the same numpy inputs: tables, Θ, losses and norms within rtol 2e-4,
  atol 2e-5 (``test_torch_multihost.py``'s tolerance), the evals' recall
  within one hit of 64 rows.
* The split step slots: on those meshes, three phases whose epochs skip
  step slots (half the padded rows real), with the row-sparse and the
  dense table Adam, fused (``phase_step``, then ``period_step``) against
  unfused: the whole states bit-equal. In the fused phase every rank opens
  three bodies per step slot (``graphs.step_if`` replaced by a recorder)
  and makes ``nb_max`` x (collectives per step) collectives per epoch,
  skipped slots included, none of them inside an open body; a collective
  called inside a segment raises, naming it.
* Ranks whose inputs take different step slots raise before the program
  runs, on every rank, rather than train apart.
* The rule on the card, asked of stand-ins: only gloo across ranks (ranks
  sharing a card) refuses capture; NCCL across ranks and a group of one
  rank do not; where capture is refused, ``fuse_period=True`` raises and
  ``False`` / ``"auto"`` run unfused.
"""

import jax
import numpy as np
import pytest
import torch

from sml_tpu.train.engine import SMLEngine as JaxEngine
from sml_tpu_torch.config import DataSpec, SMLConfig, TransferConfig
from sml_tpu_torch.data.synthetic import (SyntheticSpec,
                                          generate_synthetic_dataset)
from sml_tpu_torch.parallel.dryrun import run_world

from test_torch_multihost import (N_ITEMS, N_USERS, TIMEOUT_S, TOL,
                                  WORKERS, _cfgs, _triples, _write_state)

D, H = 16, 64
MESHES = [(1, 2), (2, 1), (2, 2)]
UNFUSED = dict(fuse_phases=False, fuse_period=False)
# the guard made to stall (as in test_torch_fused.py): attempt 0 stops at
# its check phase, the retry runs whole
STALL = dict(saddle_retries=1, saddle_mode="legacy", saddle_frac=0.0,
             saddle_check_phase=1)
CASES = {
    "period": dict(fuse_period=True, eval_during_inner=True,
                   eval_during_outer=True, log_norms=True, **STALL),
    "phase": dict(fuse_phases=True, fuse_period=False, log_norms=True,
                  **STALL),
}


def _cfg(**kw):
    base = dict(multi_num=2, mf_epochs=2, tr_epochs=1, mf_batch_size=128,
                tr_batch_size=64, eval_batch_size=64, latent_dim=D,
                mf_sample="alone", topk=(5, 20), prefetch_periods=False,
                fast_table_adam=True)
    base.update(kw)
    return SMLConfig(transfer=TransferConfig(latent_dim=D, fc_hidden=H),
                     **base)


@pytest.fixture(scope="module")
def mesh_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_data")
    generate_synthetic_dataset(
        str(root / "synth"),
        SyntheticSpec(n_users=N_USERS, n_items=N_ITEMS, n_periods=5,
                      interactions_per_period=500, first_test_period=3,
                      neg_num=49, seed=5, latent_dim=4))
    return DataSpec(root=str(root), name="synth", num_periods=5,
                    online_train_start=1, online_test_start=3,
                    eval_neg_num=49)


@pytest.fixture(scope="module")
def jax_periods(tmp_path_factory):
    """The JAX engine's ``period_step`` in replay mode (3 phases, then 2)
    from its initial state, with in-program evals and diagnostics; the
    state written for the workers and the inputs."""
    rng = np.random.default_rng(1)
    jcfg, tcfg = _cfgs(replay_mode=True, fast_table_adam=True, multi_num=3,
                       eval_during_inner=True, eval_during_outer=True,
                       eval_batch_size=32)
    jeng = JaxEngine(jcfg, N_USERS, N_ITEMS)
    jstate = jeng.snapshot_last(jeng.init_state())
    path = str(tmp_path_factory.mktemp("jax_period") / "state.npz")
    _write_state(path, jstate)
    inner, outer = _triples(rng, 500), _triples(rng, 200)
    users = rng.permutation(N_USERS)[:64]
    cands = np.stack([rng.permutation(N_ITEMS)[:20] for _ in users])
    val = np.concatenate([users[:, None], cands], 1).astype(np.int64)
    jval = jeng.make_eval_set(val)
    # copies (np.array): the next period_step donates the state's buffers
    out = []
    for n_phases in (3, 2):
        jstate, ev, (il, ol), diags = jeng.period_step(
            jstate, jeng.prep_inner(inner), jeng.prep_outer(outer),
            n_phases, jval, want_diag=True)
        keep = n_phases if n_phases < jcfg.multi_num else None
        out.append({"mf": {f: np.array(getattr(jstate.mf, f))
                           for f in jstate.mf._fields},
                    "theta": [np.array(x)
                              for x in jax.tree.leaves(jstate.theta)],
                    "il": np.array(il)[:n_phases],
                    "ol": np.array(ol)[:n_phases],
                    "diags": [np.array(d)[:n_phases] for d in diags],
                    "records": jeng.resolve_stacked_evals(
                        [(ev, val.shape[0], keep)])[0],
                    "counts": (int(jstate.mf_opt[1].count),
                               int(jstate.tr_opt[1].count))})
    return tcfg, path, inner, outer, val, out


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_fused_on_a_mesh_matches_unfused_and_jax(mesh_dataset, jax_periods,
                                                 mesh_shape):
    n = mesh_shape[0] * mesh_shape[1]
    cases = [(name, _cfg(**UNFUSED, **{k: v for k, v in kw.items()
                                       if not k.startswith("fuse")}),
              _cfg(**kw)) for name, kw in CASES.items()]
    got = run_world(f"{WORKERS}:fused_drivers", n, device="cpu",
                    args=(cases, mesh_dataset, N_USERS, N_ITEMS, mesh_shape),
                    timeout_s=TIMEOUT_S)[0]
    for name, res in got.items():
        worst = {k: v for k, v in res["diff"].items() if v != 0.0}
        assert not worst, f"{name}: fused differs from unfused: {worst}"
        assert res["records_equal"] and res["metrics_equal"], name
        assert res["retries"] == (1, 1), name
        assert {"phase", "saddle_retry", "test"} <= set(res["kinds"]), name
        assert res["unfused_calls"] == {"period_step": 0, "phase_step": 0}
    assert got["period"]["fused_calls"]["period_step"] > 0
    assert {"inner_eval", "outer_eval"} <= set(got["period"]["kinds"])
    assert got["phase"]["fused_calls"] == {
        "period_step": 0, "phase_step": got["phase"]["fused_calls"][
            "phase_step"]} and got["phase"]["fused_calls"]["phase_step"] > 0

    tcfg, path, inner, outer, val, want = jax_periods
    runs = run_world(f"{WORKERS}:period_on_mesh", n, device="cpu",
                     args=(tcfg, N_USERS, N_ITEMS, path, inner, outer, val,
                           mesh_shape, (3, 2)),
                     timeout_s=TIMEOUT_S)[0]
    for n_run, (run, ref) in enumerate(zip(runs, want)):
        st = run["state"]
        for f, v in ref["mf"].items():
            np.testing.assert_allclose(st[f"mf/{f}"], v, err_msg=f, **TOL)
        theta = {k: v for k, v in st.items() if k.startswith("theta/")}
        for (k, a), b in zip(theta.items(), ref["theta"]):
            np.testing.assert_allclose(a, b, err_msg=f"{n_run} {k}", **TOL)
        np.testing.assert_allclose(run["il"], ref["il"], **TOL)
        np.testing.assert_allclose(run["ol"], ref["ol"], **TOL)
        for a, b in zip(run["diags"], ref["diags"]):
            np.testing.assert_allclose(a, b, rtol=TOL["rtol"])
        assert tuple(st["counts"]) == ref["counts"]
        assert [(k, e) for k, e, _ in run["records"]] == \
            [(k, e) for k, e, _ in ref["records"]]
        for (_, _, tm), (_, _, jm) in zip(run["records"], ref["records"]):
            for k in tcfg.topk:
                assert abs(tm[k]["recall"] - jm[k]["recall"]) * 64 <= 1.0


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_split_step_slots_skip_alike_on_a_mesh(mesh_shape):
    cfgs = [_cfg(fast_table_adam=fast) for fast in (True, False)]
    n = mesh_shape[0] * mesh_shape[1]
    ranks = run_world(f"{WORKERS}:split_slots", n, device="cpu",
                      args=(cfgs, N_USERS, N_ITEMS, mesh_shape, (300, 200)),
                      timeout_s=TIMEOUT_S)
    for k, cfg in enumerate(cfgs):
        # the row-sparse step gathers its row gradients and sums its loss
        # over 'data' at its second cut; the dense one sums both in one
        calls_in = 3 if cfg.fast_table_adam else 2
        for rank, got in enumerate(r[k] for r in ranks):
            worst = {p: v for p, v in got["diff"].items() if v != 0.0}
            assert not worst, f"rank {rank}: fused differs: {worst}"
            (t_in, t_out), (nb_in, nb_out) = got["taken"], got["slots"]
            assert 0 < t_in < nb_in and 0 < t_out < nb_out, got
            assert got["opens"] == 3 * (cfg.mf_epochs * nb_in
                                        + cfg.tr_epochs * nb_out)
            assert got["collectives"] == (cfg.mf_epochs * nb_in * calls_in
                                          + cfg.tr_epochs * nb_out * 2)
            assert got["inside"] == 0


def test_a_collective_inside_a_segment_raises():
    from sml_tpu_torch.parallel import collective
    from sml_tpu_torch.train import graphs, steps
    t = torch.ones(3)
    with collective.segment("step slot 2, before its cut 'rows'"):
        with pytest.raises(RuntimeError, match="all_gather called inside "
                           "step slot 2, before its cut 'rows'"):
            collective.all_gather(t, None)
    assert collective.all_gather(t, None) is t

    cut = steps.Cut("sum", (torch.zeros(3),), lambda buf: buf)

    def step(b):
        cut.bufs[0].fill_(b)
        got = yield cut
        collective.all_reduce(got, None)
    slots = graphs.SlotTable(2, "cpu")
    slots.fill(1)
    with pytest.raises(RuntimeError, match="all_reduce called inside step "
                       "slot 0, after its last cut"):
        steps.run_slots(2, 1, torch.Generator(), slots, step, cuts=(cut,))


def test_unequal_step_slots_raise_on_every_rank():
    cfg = _cfg()
    got = run_world(f"{WORKERS}:unequal_slots", 2, device="cpu",
                    args=(cfg, N_USERS, N_ITEMS, (512, 300)),
                    timeout_s=TIMEOUT_S)
    assert all(msg is not None and "disagree" in msg and "step slots" in msg
               for msg in got), got


def test_fusion_route_where_the_programs_cannot_be_captured():
    """The driver's rule on an engine that refuses capture (a card under a
    mesh of ranks sharing it): ``fuse_period=True`` raises with the reason
    and the way out, False and ``"auto"`` run unfused."""
    from sml_tpu_torch.train.driver import fusion_route

    class Refusing:
        def capture_refusal(self):
            return "a gloo collective cannot be captured in a CUDA graph"

        def fused_program_warm(self):
            return False
    with pytest.raises(ValueError, match="gloo.*fuse_period=False"):
        fusion_route(_cfg(fuse_period=True), Refusing())
    assert fusion_route(_cfg(fuse_period=False), Refusing()) is False
    assert fusion_route(_cfg(fuse_period="auto"), Refusing()) is False
    assert fusion_route(_cfg(fuse_phases=False, fuse_period=True),
                        Refusing()) is False


def test_capture_refusal_names_collectives_across_ranks(monkeypatch):
    """The rule on the card: a group of one rank makes no collective, and
    an NCCL collective across ranks is captured between the IF nodes of a
    split step slot, so neither is refused; a gloo collective across ranks
    (ranks sharing a card) is refused, whatever the other groups; on the
    CPU nothing is captured, so nothing is refused. Groups stand in as
    ``(size, backend)``."""
    from sml_tpu_torch.parallel import collective
    monkeypatch.setattr(collective, "group_size", lambda g: g[0])
    monkeypatch.setattr(collective.dist, "get_backend", lambda g: g[1])
    refusal = collective.capture_refusal
    assert refusal([(1, "nccl"), (1, "gloo")], "cuda") is None
    assert refusal([(1, "nccl"), (2, "nccl")], "cuda") is None
    assert refusal([(2, "nccl"), (4, "nccl")], "cuda") is None
    assert "gloo" in refusal([(2, "gloo")], "cuda")
    assert "gloo" in refusal([(2, "nccl"), (4, "gloo")], "cuda")
    assert refusal([(2, "nccl"), (4, "gloo")], "cpu") is None


def test_nccl_capture_probe_needs_cards():
    """The probe behind the NCCL refusal runs only on cards: on the CPU it
    says so and exits 1."""
    from sml_tpu_torch.scripts import nccl_capture_probe
    assert nccl_capture_probe.main([]) == 1
