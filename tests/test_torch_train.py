"""Training epochs and the engine's training half against the JAX package.

Replay mode (rows in their given order, no random draws) makes both
packages run the same steps on the same data. The JAX state (tables, Θ,
snapshots, both Adam states) is carried into the port with
``theta_from_numpy`` / ``opt_state_from_numpy``; then both run the
``scripts/lockstep_parity.py`` event pattern — snapshot ``last``, inner
epoch, snapshot ``hat``, refresh, outer epoch, refresh — twice, and the
tables, Θ and per-batch losses are compared after every step at rtol 1e-5
and atol 1e-5 (f32 sums over Θ's hidden units in another order, carried
through Adam steps).
"""

import jax
import numpy as np
import pytest
import torch

from sml_tpu.config import SMLConfig as JaxSMLConfig
from sml_tpu.config import TransferConfig as JaxTransferConfig
from sml_tpu.data.feeder import PeriodFeeder as JaxFeeder
from sml_tpu.train.engine import SMLEngine as JaxEngine
from sml_tpu_torch.config import SMLConfig, TransferConfig
from sml_tpu_torch.data.feeder import PeriodFeeder
from sml_tpu_torch.data.prefetch import PrefetchingFeeder
from sml_tpu_torch.models.mf import MFParams
from sml_tpu_torch.models.transfer import theta_from_numpy, theta_leaves
from sml_tpu_torch.ops import adam_kernel, eval_kernel, transfer_kernel
from sml_tpu_torch.train.engine import SMLEngine, SMLState
from sml_tpu_torch.train.optim import opt_state_from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)
N_U, N_I, D, H = 60, 40, 8, 32
SNAPS = ("last_user", "last_item", "hat_user", "hat_item")


def _cfgs(**kw):
    base = dict(latent_dim=D, mf_batch_size=16, tr_batch_size=8,
                replay_mode=True)
    base.update(kw)
    return (JaxSMLConfig(transfer=JaxTransferConfig(latent_dim=D,
                                                    fc_hidden=H), **base),
            SMLConfig(transfer=TransferConfig(latent_dim=D, fc_hidden=H),
                      **base))


def carry_state(jstate) -> SMLState:
    """The port's state holding a copy of a JAX engine's state."""
    host = jax.tree.map(np.array, jstate)
    return SMLState(
        mf=MFParams(*(torch.from_numpy(x) for x in host.mf)),
        theta=theta_from_numpy(host.theta, device="cpu"),
        **{f: torch.from_numpy(getattr(host, f)) for f in SNAPS},
        mf_opt=opt_state_from_numpy(host.mf_opt, device="cpu"),
        tr_opt=opt_state_from_numpy(host.tr_opt, device="cpu"),
        gen=torch.Generator().manual_seed(0))


def _triples(rng, n):
    return np.stack([rng.integers(0, N_U, n), rng.integers(0, N_I, n),
                     rng.integers(0, N_I, n)], axis=1).astype(np.int64)


def _compare(tag, jstate, tstate):
    for f in ("user_emb", "item_emb", "user_bias", "item_bias"):
        np.testing.assert_allclose(getattr(tstate.mf, f).numpy(),
                                   np.asarray(getattr(jstate.mf, f)),
                                   err_msg=f"{tag} mf/{f}", **TOL)
    jl = dict(zip(theta_leaves(tstate.theta),
                  [np.asarray(x) for x in jax.tree.leaves(jstate.theta)]))
    for name, p in theta_leaves(tstate.theta).items():
        np.testing.assert_allclose(p.detach().numpy(), jl[name],
                                   err_msg=f"{tag} theta/{name}", **TOL)


@pytest.mark.parametrize("fast", [True, False])
def test_replay_phases_match_jax(rng, fast):
    jcfg, tcfg = _cfgs(fast_table_adam=fast)
    jeng = JaxEngine(jcfg, N_U, N_I)
    teng = SMLEngine(tcfg, N_U, N_I, device="cpu")
    assert teng.cfg.fast_table_adam is fast
    jstate = jeng.init_state()
    tstate = carry_state(jstate)
    # 261 rows: 17 real batches of 16, bucketed to 18 (one skipped)
    inner_rows, outer_rows = _triples(rng, 261), _triples(rng, 70)
    k3 = adam_kernel.decay_adam_cuda.launches
    for phase in range(2):
        jstate, tstate = jeng.snapshot_last(jstate), \
            teng.snapshot_last(tstate)
        jp, tp = jeng.prep_inner(inner_rows), teng.prep_inner(inner_rows)
        jstate, jl = jeng.inner_epoch(jstate, *jp)
        tstate, tl = teng.inner_epoch(tstate, *tp)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        assert tl.shape == (18,) and tl[17] == 0.0
        assert tstate.mf_opt.count == int(jstate.mf_opt[1].count) \
            == 17 * (phase + 1)
        _compare(f"phase {phase} inner", jstate, tstate)
        jstate = jeng.refresh(jeng.snapshot_hat(jstate))
        tstate = teng.refresh(teng.snapshot_hat(tstate))
        _compare(f"phase {phase} refresh 1", jstate, tstate)
        jstate, jl = jeng.outer_epoch(jstate, *jeng.prep_outer(outer_rows))
        tstate, tl = teng.outer_epoch(tstate, *teng.prep_outer(outer_rows))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        assert tstate.tr_opt.count == int(jstate.tr_opt[1].count)
        jstate, tstate = jeng.refresh(jstate), teng.refresh(tstate)
        _compare(f"phase {phase} refresh 2", jstate, tstate)
        for part in ("mu", "nu"):
            for name, t in getattr(tstate.mf_opt, part).items():
                np.testing.assert_allclose(
                    t.numpy(),
                    np.asarray(getattr(getattr(jstate.mf_opt[1], part),
                                       name)), rtol=1e-5, atol=1e-7)
    # CPU tensors never launch a kernel
    assert adam_kernel.decay_adam_cuda.launches == k3 == 0
    assert transfer_kernel.transfer_rows_cuda.launches == 0
    assert eval_kernel.masked_rank_cuda.launches == 0


def test_sampled_epochs_train_and_count_steps(rng):
    """'alone' sampling and the 'all' column draw on the port alone: the
    step count is ceil(N/B), losses are finite and training lowers them."""
    _, tcfg = _cfgs(replay_mode=False, mf_sample="alone",
                    fast_table_adam=True)
    teng = SMLEngine(tcfg, N_U, N_I, device="cpu")
    state = teng.snapshot_last(teng.init_state())
    pairs = np.unique(np.stack([rng.integers(0, N_U, 300),
                                rng.integers(0, N_I, 300)], 1), axis=0)
    prep = teng.prep_inner(pairs)
    assert prep[1] is not None
    first = None
    for _ in range(6):
        state, losses = teng.inner_epoch(state, *prep)
        nb = -(-pairs.shape[0] // 16)
        assert torch.isfinite(losses).all() and (losses[nb:] == 0).all()
        first = losses[:nb].mean() if first is None else first
    assert state.mf_opt.count == 6 * nb
    assert losses[:nb].mean() < first
    state, ol = teng.outer_epoch(teng.snapshot_hat(state),
                                 *teng.prep_outer(pairs))
    assert torch.isfinite(ol).all()


def test_theta_warmstart_and_reinit():
    _, tcfg = _cfgs(theta_warmstart_steps=4, theta_warmstart_rows=32)
    teng = SMLEngine(tcfg, N_U, N_I, device="cpu")
    cold = SMLEngine(tcfg.replace(theta_warmstart_steps=0), N_U, N_I,
                     device="cpu").init_state()
    warm = teng.init_state()
    assert "theta_warmstart_final_loss" in teng.sampler_stats
    assert not torch.equal(theta_leaves(warm.theta)["user/fc1_w"],
                           theta_leaves(cold.theta)["user/fc1_w"])
    skipped = teng.init_state(skip_theta_warmstart=True)
    assert torch.equal(theta_leaves(skipped.theta)["user/fc1_w"],
                       theta_leaves(cold.theta)["user/fc1_w"])
    a = teng.reinit_theta(cold, salt=1)
    b = teng.reinit_theta(cold, salt=1)
    c = teng.reinit_theta(cold, salt=2)
    wa, wb, wc = (theta_leaves(s.theta)["item/fc2_w"] for s in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    assert a.tr_opt.count == 0


def test_feeder_matches_jax(synthetic_dataset):
    dspec, _, _ = synthetic_dataset
    for kw in (dict(), dict(mf_sample="alone", tr_stop=True)):
        jf, tf = JaxFeeder(dspec, **kw), PeriodFeeder(dspec, **kw)
        pf = PrefetchingFeeder(PeriodFeeder(dspec, **kw))
        assert tf.shape_bounds() == jf.shape_bounds() == pf.shape_bounds()
        for d in range(6):
            want, got, pre = jf.next_train(d), tf.next_train(d), \
                pf.next_train(d)
            for a, b, c in zip(want, got, pre):
                assert (a is None) == (b is None) == (c is None)
                if a is not None:
                    np.testing.assert_array_equal(a, b)
                    np.testing.assert_array_equal(a, c)
        pf.close()
    # a prefetched period must be consumed next
    pf = PrefetchingFeeder(PeriodFeeder(dspec))
    pf.next_train(0)
    with pytest.raises(RuntimeError, match="prefetched"):
        pf.next_train(2)
    pf.close()


def test_upload_cache_takes_concurrent_inserts():
    """The prefetch worker and the main thread insert into one upload
    cache: inserts and evictions from many threads keep it at its cap."""
    import sys
    import threading
    _, tcfg = _cfgs()
    teng = SMLEngine(tcfg, N_U, N_I, device="cpu")
    padded = teng.make_eval_set(np.zeros((4, 3), np.int64))
    errors = []

    def insert(base):
        try:
            for k in range(300):
                teng._cache_upload((base, k), padded)
        except Exception as exc:          # a lost race surfaces here
            errors.append(exc)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=insert, args=(b,))
                   for b in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert len(teng._upload_cache) == teng._upload_cache_cap


def test_all_mode_pool_shares_the_eval_upload(synthetic_dataset):
    from sml_tpu_torch.data.formats import load_test
    dspec, info, _ = synthetic_dataset
    _, tcfg = _cfgs(replay_mode=False, mf_batch_size=64, eval_batch_size=64)
    teng = SMLEngine(tcfg, info.n_users, info.n_items, device="cpu")
    rows = load_test(dspec.path, dspec.online_test_start)
    teng.shape_targets = {"set_t": 1024, "set_tt": 0, "eval": 1024}
    padded, index = teng.prep_inner(rows)
    assert index is None and teng.make_eval_set(rows) is padded
    assert padded.rows.shape[0] == 1024
