"""The six other transfer kinds (``conv2ch``, ``conv_com_root``,
``mlp_delta``, ``linear``, ``gru``, ``gated``) against the JAX package.

For each kind, Θ from ``sml_tpu``'s ``init_transfer`` is carried across
with ``theta_from_numpy`` and both packages run on the same numpy inputs
on the CPU:

* the port's own init has the JAX shapes and the reference's bounds;
* ``apply_rows`` forward, both sides, within 3e-5;
* gradients of one scalar loss with respect to Θ, x_t and x_hat (the
  detached norm of ``conv2ch``, the detached channel of ``conv_com_root``)
  from ``jax.grad`` and from autograd, within rtol 1e-5 / atol 1e-6;
* ``apply_tables`` against JAX's row-blocked path, f32 and bf16 snapshots;
* one replay-mode inner step and one outer step in lockstep, tables, Θ and
  losses within rtol 1e-5 (atol 1e-5 as ``tests/test_torch_train.py``);
* the identity warm-start of Θ;
* a JAX checkpoint loads in the port, and a port checkpoint restores in
  ``sml_tpu``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sml_tpu.config import SMLConfig as JaxSMLConfig
from sml_tpu.config import TransferConfig as JaxTransferConfig
from sml_tpu.models import transfer as JT
from sml_tpu.train.engine import SMLEngine as JaxEngine
from sml_tpu.utils import checkpoint as jax_ckpt
from sml_tpu_torch.config import SMLConfig, TransferConfig
from sml_tpu_torch.models import transfer as T
from sml_tpu_torch.models.mf import MFParams
from sml_tpu_torch.train.engine import SMLEngine, SMLState
from sml_tpu_torch.train.optim import opt_state_from_numpy
from sml_tpu_torch.utils import checkpoint as ckpt

KINDS = ("conv2ch", "conv_com_root", "mlp_delta", "linear", "gru", "gated")
D, H = 8, 32
FWD = dict(rtol=3e-5, atol=3e-5)
GRAD = dict(rtol=1e-5, atol=1e-6)
STEP = dict(rtol=1e-5, atol=1e-5)
N_U, N_I = 30, 20

# the JAX side runs jitted: one compile per function and kind, where op by
# op it compiles every primitive of the forward and backward passes
_jinit = jax.jit(JT.init_transfer, static_argnums=(1,))
_japply_rows = jax.jit(JT.apply_rows, static_argnums=(1, 2))
_japply_tables = jax.jit(JT.apply_tables, static_argnums=(1,),
                         static_argnames=("block_rows", "use_pallas"))


def _tcfgs(kind):
    return (JaxTransferConfig(latent_dim=D, fc_hidden=H, kind=kind),
            TransferConfig(latent_dim=D, fc_hidden=H, kind=kind))


def _theta(kind, seed=3):
    jc, tc = _tcfgs(kind)
    jt = _jinit(jax.random.PRNGKey(seed), jc)
    return jt, T.theta_from_numpy(jax.tree.map(np.asarray, jt),
                                  device="cpu")


def _rows(rng, n):
    return rng.normal(size=(n, D)).astype(np.float32)


@pytest.mark.parametrize("kind", KINDS)
def test_init_carry_and_apply_rows_match_jax(rng, kind):
    jc, tc = _tcfgs(kind)
    jt, tt = _theta(kind)
    own = T.init_transfer(torch.Generator().manual_seed(0), tc, device="cpu")
    for side in ("user", "item"):
        jtw = getattr(jt, side)
        assert getattr(tt, side).FIELDS == type(jtw)._fields
        for f in type(jtw)._fields:
            j = np.asarray(getattr(jtw, f))
            np.testing.assert_array_equal(
                getattr(getattr(tt, side), f).detach().numpy(), j)
            mine = getattr(getattr(own, side), f).detach()
            assert tuple(mine.shape) == j.shape, (side, f)
            # both draw U(-b, b) with the reference's fan-in
            assert mine.abs().max() <= np.abs(j).max() * 1.5
    # the kind may also come from an explicit config
    tree = {s: {f: np.asarray(getattr(getattr(jt, s), f))
                for f in type(getattr(jt, s))._fields}
            for s in ("user", "item")}
    by_cfg = T.theta_from_numpy(tree, device="cpu", cfg=tc)
    for a, b in zip(tt.parameters(), by_cfg.parameters()):
        assert torch.equal(a, b)
    last, hat = _rows(rng, 64), _rows(rng, 64)
    last[::7] = 0.0    # zero rows: the guarded norms
    for side in ("user", "item"):
        want = _japply_rows(jt, jc, side, jnp.asarray(last),
                            jnp.asarray(hat))
        got = T.apply_rows(tt, tc, side, torch.from_numpy(last),
                           torch.from_numpy(hat))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **FWD)


@pytest.mark.parametrize("kind", KINDS)
def test_gradients_match_jax(rng, kind):
    jc, tc = _tcfgs(kind)
    jt, tt = _theta(kind)
    xt, xh = _rows(rng, 48), _rows(rng, 48)
    wu, wi = _rows(rng, 48), _rows(rng, 48)

    def jloss(theta, x_t, x_hat):
        return (jnp.sum(JT.apply_rows(theta, jc, "user", x_t, x_hat) * wu)
                + jnp.sum(JT.apply_rows(theta, jc, "item", x_t, x_hat)
                          * wi))

    gth, gxt, gxh = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jt, jnp.asarray(xt), jnp.asarray(xh))
    txt = torch.from_numpy(xt).requires_grad_()
    txh = torch.from_numpy(xh).requires_grad_()
    loss = (torch.sum(T.apply_rows(tt, tc, "user", txt, txh)
                      * torch.from_numpy(wu))
            + torch.sum(T.apply_rows(tt, tc, "item", txt, txh)
                        * torch.from_numpy(wi)))
    leaves = T.theta_leaves(tt)
    grads = torch.autograd.grad(loss, [txt, txh, *leaves.values()])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gxt), **GRAD)
    np.testing.assert_allclose(grads[1].numpy(), np.asarray(gxh), **GRAD)
    for name, g in zip(leaves, grads[2:]):
        side, f = name.split("/")
        np.testing.assert_allclose(
            g.numpy(), np.asarray(getattr(getattr(gth, side), f)),
            err_msg=name, **GRAD)


@pytest.mark.parametrize("snap", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_apply_tables_matches_jax_blocked(rng, kind, snap):
    jc, tc = _tcfgs(kind)
    jt, tt = _theta(kind)
    lu, hu, li, hi = _rows(rng, 300), _rows(rng, 300), _rows(rng, 130), \
        _rows(rng, 130)
    jdt = jnp.bfloat16 if snap == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if snap == "bfloat16" else torch.float32
    wu, wi = _japply_tables(jt, jc, *(jnp.asarray(a, jdt)
                                      for a in (lu, hu, li, hi)),
                            block_rows=128, use_pallas="never")
    # a block size that divides neither table: ragged last blocks
    gu, gi = T.apply_tables(tt, tc, *(torch.from_numpy(a).to(tdt)
                                      for a in (lu, hu, li, hi)),
                            block_rows=100)
    assert gu.dtype == gi.dtype == torch.float32
    np.testing.assert_allclose(gu.numpy(), np.asarray(wu), **FWD)
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), **FWD)


def _cfgs(kind, **kw):
    base = dict(latent_dim=D, mf_batch_size=16, tr_batch_size=8,
                replay_mode=True)
    base.update(kw)
    jc, tc = _tcfgs(kind)
    return (JaxSMLConfig(transfer=jc, **base),
            SMLConfig(transfer=tc, **base))


def _carry(jstate, tcfg) -> SMLState:
    host = jax.tree.map(np.array, jstate)
    return SMLState(
        mf=MFParams(*(torch.from_numpy(x) for x in host.mf)),
        theta=T.theta_from_numpy(host.theta, device="cpu"),
        **{f: torch.from_numpy(getattr(host, f))
           for f in ("last_user", "last_item", "hat_user", "hat_item")},
        mf_opt=opt_state_from_numpy(host.mf_opt, device="cpu"),
        tr_opt=opt_state_from_numpy(host.tr_opt, device="cpu"),
        gen=torch.Generator().manual_seed(0))


def _triples(rng, n):
    return np.stack([rng.integers(0, N_U, n), rng.integers(0, N_I, n),
                     rng.integers(0, N_I, n)], axis=1).astype(np.int64)


def _compare(tag, jstate, tstate):
    for f in ("user_emb", "item_emb"):
        np.testing.assert_allclose(getattr(tstate.mf, f).numpy(),
                                   np.asarray(getattr(jstate.mf, f)),
                                   err_msg=f"{tag} mf/{f}", **STEP)
    for name, p in T.theta_leaves(tstate.theta).items():
        side, f = name.split("/")
        np.testing.assert_allclose(
            p.detach().numpy(),
            np.asarray(getattr(getattr(jstate.theta, side), f)),
            err_msg=f"{tag} theta/{name}", **STEP)


_JAX_RUNS = {}


def _jax_run(kind):
    """The JAX engine of ``kind`` and host copies of its states before
    and after one replay-mode inner step and a refresh, and after one
    outer step (run once per kind: its programs are compiled once; the
    epochs donate their inputs, so each state is copied out first)."""
    if kind not in _JAX_RUNS:
        rng = np.random.default_rng(11)
        jcfg, _ = _cfgs(kind)
        jeng = JaxEngine(jcfg, N_U, N_I)
        inner, outer = _triples(rng, 16), _triples(rng, 8)  # one step each
        s = jeng.snapshot_last(jeng.init_state())
        states = [jax.tree.map(np.array, s)]
        s, il = jeng.inner_epoch(s, *jeng.prep_inner(inner))
        s = jeng.refresh(jeng.snapshot_hat(s))
        states.append(jax.tree.map(np.array, s))
        s, ol = jeng.outer_epoch(s, *jeng.prep_outer(outer))
        states.append(jax.tree.map(np.array, s))
        _JAX_RUNS[kind] = (jeng, inner, outer, states, np.asarray(il),
                           np.asarray(ol))
    return _JAX_RUNS[kind]


@pytest.mark.parametrize("kind", KINDS)
def test_replay_inner_and_outer_step_match_jax(kind):
    jeng, inner, outer, states, jil, jol = _jax_run(kind)
    _, tcfg = _cfgs(kind)
    teng = SMLEngine(tcfg, N_U, N_I, device="cpu")
    tstate = _carry(states[0], tcfg)
    tstate, tl = teng.inner_epoch(tstate, *teng.prep_inner(inner))
    np.testing.assert_allclose(tl.numpy(), jil, **STEP)
    tstate = teng.refresh(teng.snapshot_hat(tstate))
    _compare("inner, refresh", states[1], tstate)
    tstate, tl = teng.outer_epoch(tstate, *teng.prep_outer(outer))
    assert tstate.tr_opt.count == int(states[2].tr_opt[1].count) == 1
    np.testing.assert_allclose(tl.numpy(), jol, **STEP)
    _compare("outer", states[2], tstate)


@pytest.mark.parametrize("kind", KINDS)
def test_theta_warmstart_and_reinit_every_kind(kind):
    _, tcfg = _cfgs(kind, theta_warmstart_steps=3, theta_warmstart_rows=16)
    teng = SMLEngine(tcfg, N_U, N_I, device="cpu")
    warm = teng.init_state()
    cold = teng.init_state(skip_theta_warmstart=True)
    assert np.isfinite(teng.sampler_stats["theta_warmstart_final_loss"])
    wl, cl = T.theta_leaves(warm.theta), T.theta_leaves(cold.theta)
    assert any(not torch.equal(wl[k], cl[k]) for k in wl)
    again = teng.reinit_theta(cold, salt=1, warmstart=True)
    assert again.tr_opt.count == 0
    assert set(again.tr_opt.mu) == set(wl)


@pytest.mark.parametrize("kind", KINDS)
def test_checkpoints_cross_both_ways(tmp_path, kind):
    jeng, _, _, states, _, _ = _jax_run(kind)
    jstate = states[2]
    jax_ckpt.save_checkpoint(str(tmp_path / "j"), 1, jstate)
    host = jax.tree.map(np.asarray, jstate)

    t = ckpt.state_from_checkpoint(str(tmp_path / "j"), device="cpu")
    assert t.theta.user.FIELDS == type(host.theta.user)._fields
    for name, p in T.theta_leaves(t.theta).items():
        side, f = name.split("/")
        np.testing.assert_array_equal(
            p.detach().numpy(), getattr(getattr(host.theta, side), f))
        np.testing.assert_array_equal(
            t.tr_opt.mu[name].numpy(),
            getattr(getattr(host.tr_opt[1].mu, side), f))
    assert t.tr_opt.count == int(host.tr_opt[1].count) == 1

    ckpt.save_checkpoint(str(tmp_path / "t"), 2, t)
    restored, step, _ = jax_ckpt.restore_checkpoint(str(tmp_path / "t"),
                                                    jeng.init_state())
    assert step == 2
    flat = ckpt.flatten_state(t)
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            restored.theta)[0]:
        key = "theta/" + "/".join(p.name for p in path)
        np.testing.assert_array_equal(np.asarray(leaf),
                                      flat[key].detach().numpy(),
                                      err_msg=key)

