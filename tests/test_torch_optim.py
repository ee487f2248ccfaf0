"""Losses, K3's plain version and the optimizers against the JAX package.

Same numpy inputs go through ``sml_tpu`` and ``sml_tpu_torch`` on the CPU.
Tolerances:

* losses: rtol 1e-6 (f32 sigmoid/log in two libraries);
* K3's plain version against the Pallas kernel in interpret mode: ``mu``
  and ``nu`` bit-equal (one f32 multiply each), ``p`` within rtol 1e-6 and
  atol 1e-8 (the JAX package's own bound, ``tests/test_adam_kernel.py``:
  XLA may fuse the final multiply-add); ``fused_decay_adam_multi`` over
  the four MF leaves bit-equal to the plain version leaf by leaf;
* the functional Adam against the optax ``torch_adam`` chain over 12
  steps: rtol 1e-6 (the same f32 op order);
* ``sparse_dense_adam_update`` against the JAX one over 7 steps with
  duplicate and untouched rows: rtol 1e-6, atol 1e-7 (duplicates are
  summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sml_tpu.models.mf import MFParams as JaxMF
from sml_tpu.ops import losses as JL
from sml_tpu.ops.adam_kernel import fused_decay_adam as jax_decay
from sml_tpu.train import optim as JO
from sml_tpu_torch.models.mf import MFParams
from sml_tpu_torch.ops import adam_kernel as AK
from sml_tpu_torch.ops import losses as L
from sml_tpu_torch.train import optim as O


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_losses_match_jax(rng):
    pos = (rng.normal(size=64) * 8).astype(np.float32)
    neg = (rng.normal(size=64) * 8).astype(np.float32)
    pos[:3] = [40.0, -40.0, 17.5]     # saturated: sigmoid(-x) keeps it finite
    neg[:3] = [40.0, -40.0, 17.5]
    mask = (rng.random(64) > 0.2).astype(np.float32)
    emb = rng.normal(size=(64, 8)).astype(np.float32)
    norm = (rng.random(64) + 0.5).astype(np.float32)
    pairs = [
        (L.bce_pair_loss(_t(pos), _t(neg), _t(mask)),
         JL.bce_pair_loss(jnp.asarray(pos), jnp.asarray(neg),
                          jnp.asarray(mask))),
        (L.bpr_loss(_t(pos), _t(neg), _t(mask)),
         JL.bpr_loss(jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(mask))),
        (L.bpr_loss(_t(pos), _t(neg), _t(mask), _t(norm)),
         JL.bpr_loss(jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(mask),
                     jnp.asarray(norm))),
        (L.l2_embedding_penalty(_t(mask), _t(emb), _t(emb * 2)),
         JL.l2_embedding_penalty(jnp.asarray(mask), jnp.asarray(emb),
                                 jnp.asarray(emb * 2))),
    ]
    for got, want in pairs:
        assert torch.isfinite(got)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    # an all-padding batch is 0, not NaN
    zero = L.bce_pair_loss(_t(pos), _t(neg), torch.zeros(64))
    assert zero.item() == 0.0


@pytest.mark.parametrize("shape", [
    (2048, 64), (1000 * 128,), (4096, 96), (1250, 64), (677 * 128,),
    (1237, 1),   # a bias column: not a multiple of the TPU's 128 lanes
])
def test_decay_adam_plain_matches_pallas(rng, shape):
    from jax.experimental.pallas import tpu as pltpu

    p = rng.normal(size=shape).astype(np.float32)
    mu = (rng.normal(size=shape) * 1e-2).astype(np.float32)
    nu = (rng.random(shape) * 1e-4).astype(np.float32)
    bc1, bc2 = O.bias_corrections(7)
    lr = 0.01
    kw = dict(lr=lr, b1=O.ADAM_B1, b2=O.ADAM_B2, eps=O.ADAM_EPS)
    if shape[-1] == 1:
        # the TPU kernel views tables as (-1, 128): pad the column to a
        # lane multiple for it (the padding is discarded)
        n = -(-p.size // 128) * 128
        jin = [np.pad(a.ravel(), (0, n - a.size)) for a in (p, mu, nu)]
    else:
        jin = [p, mu, nu]
    with pltpu.force_tpu_interpret_mode():
        jp, jmu, jnu = jax_decay(*map(jnp.asarray, jin), jnp.float32(bc1),
                                 jnp.float32(bc2), block_rows=512, **kw)
    jp, jmu, jnu = (np.asarray(a).ravel()[:p.size].reshape(shape)
                    for a in (jp, jmu, jnu))
    tp, tmu, tnu = _t(p.copy()), _t(mu.copy()), _t(nu.copy())
    before = AK.decay_adam_cuda.launches
    AK.fused_decay_adam(tp, tmu, tnu, bc1, bc2, **kw)
    assert AK.decay_adam_cuda.launches == before == 0
    np.testing.assert_array_equal(tmu.numpy(), jmu)
    np.testing.assert_array_equal(tnu.numpy(), jnu)
    np.testing.assert_allclose(tp.numpy(), jp, rtol=1e-6, atol=1e-8)


def _mf_leaves(rng, n_u=300, n_i=200, d=16):
    """(p, mu, nu) numpy triples at the four MF leaf shapes."""
    out = []
    for shape in ((n_u, d), (n_i, d), (n_u, 1), (n_i, 1)):
        out.append((rng.normal(size=shape).astype(np.float32),
                    (rng.normal(size=shape) * 1e-2).astype(np.float32),
                    (rng.random(shape) * 1e-4).astype(np.float32)))
    return out


@pytest.mark.parametrize("count", [1, 7, 1000])
def test_fused_decay_adam_multi_equals_plain_leaf_by_leaf(rng, count):
    bc1, bc2 = O.bias_corrections(count)
    kw = dict(lr=0.01, b1=O.ADAM_B1, b2=O.ADAM_B2, eps=O.ADAM_EPS)
    leaves = _mf_leaves(rng)
    multi = [tuple(_t(a.copy()) for a in leaf) for leaf in leaves]
    AK.fused_decay_adam_multi(multi, bc1, bc2, **kw)
    for got, leaf in zip(multi, leaves):
        want = tuple(_t(a.copy()) for a in leaf)
        AK.decay_adam_plain(*want, bc1, bc2, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert AK.decay_adam_cuda.launches == 0


def test_fused_decay_adam_multi_matches_pallas(rng):
    """One call over a leaf the TPU kernel takes (a multiple of 128 lanes)
    and a bias column beside it. Against the Pallas kernel in interpret
    mode: ``mu``/``nu`` bit for bit, ``p`` within the JAX package's own
    bound (XLA fuses its final multiply-add, so ~1% of ``p`` differ in the
    last bit); the bias column bit for bit against the plain version."""
    from jax.experimental.pallas import tpu as pltpu

    bc1, bc2 = O.bias_corrections(7)
    kw = dict(lr=0.01, b1=O.ADAM_B1, b2=O.ADAM_B2, eps=O.ADAM_EPS)
    table, bias = _mf_leaves(rng, n_u=2048, d=64)[0::2]
    with pltpu.force_tpu_interpret_mode():
        want = jax_decay(*map(jnp.asarray, table), jnp.float32(bc1),
                         jnp.float32(bc2), block_rows=512, **kw)
    leaves = [tuple(_t(a.copy()) for a in leaf) for leaf in (table, bias)]
    AK.fused_decay_adam_multi(leaves, bc1, bc2, **kw)
    (tp, tmu, tnu), (jp, jmu, jnu) = leaves[0], want
    np.testing.assert_array_equal(tmu.numpy(), np.asarray(jmu))
    np.testing.assert_array_equal(tnu.numpy(), np.asarray(jnu))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-8)
    plain = tuple(_t(a.copy()) for a in bias)
    AK.decay_adam_plain(*plain, bc1, bc2, **kw)
    assert all(torch.equal(g, w) for g, w in zip(leaves[1], plain))
    assert AK.decay_adam_cuda.launches == 0


def test_fused_decay_adam_multi_refuses_mixed_devices():
    leaf = tuple(torch.zeros(4, device="meta") for _ in range(3))
    cpu = tuple(torch.zeros(4) for _ in range(3))
    with pytest.raises(ValueError, match="device"):
        AK.fused_decay_adam_multi([cpu, leaf], 0.1, 0.01, lr=0.01, b1=0.9,
                                  b2=0.999, eps=1e-8)


def test_sparse_dense_adam_decays_every_leaf_in_one_call(rng, monkeypatch):
    """One K3 call per step over all four leaves, with every fix-up row
    gathered before the decay; the result equals the dense-gradient Adam
    step (two duplicates sum exactly, and both paths round alike)."""
    n_u, n_i, d, b = 30, 20, 8, 12
    tabs = [rng.normal(size=s).astype(np.float32)
            for s in ((n_u, d), (n_i, d), (n_u, 1), (n_i, 1))]
    sparse_mf = MFParams(*(_t(a.copy()) for a in tabs))
    dense_mf = {n: _t(a.copy()) for n, a in zip(MFParams._fields, tabs)}
    s_state = O.adam_init(sparse_mf._asdict())
    d_state = O.adam_init(dense_mf)
    calls = []
    real = O.fused_decay_adam_multi

    def spy(leaves, *a, **kw):
        leaves = list(leaves)
        calls.append(len(leaves))
        return real(leaves, *a, **kw)

    monkeypatch.setattr(O, "fused_decay_adam_multi", spy)
    for _ in range(5):
        u = rng.integers(0, n_u, b)
        i = rng.integers(0, n_i, b)
        i[1] = i[0]                                # one duplicate pair
        gu, gi = (rng.normal(size=(b, d)).astype(np.float32)
                  for _ in range(2))
        s_state = O.sparse_dense_adam_update(
            sparse_mf, s_state, {"user_emb": O.TableGrad(_t(u), _t(gu)),
                                 "item_emb": O.TableGrad(_t(i), _t(gi))},
            lr=0.01)
        grads = {"user_emb": torch.zeros(n_u, d).index_add_(0, _t(u), _t(gu)),
                 "item_emb": torch.zeros(n_i, d).index_add_(0, _t(i), _t(gi))}
        d_state = O.adam_update(dense_mf, grads, d_state, lr=0.01)
    assert calls == [4] * 5
    for name in MFParams._fields:
        assert torch.equal(getattr(sparse_mf, name), dense_mf[name]), name
        assert torch.equal(s_state.mu[name], d_state.mu[name]), name
        assert torch.equal(s_state.nu[name], d_state.nu[name]), name


def test_bias_corrections_are_f32_values():
    for count in (1, 7, 1000):
        bc1, bc2 = O.bias_corrections(count)
        want1 = np.float32(1) - np.float32(0.9) ** np.float32(count)
        assert bc1 == float(want1) and np.float32(bc1) == want1
        assert 0 < bc2 < 1


@pytest.mark.parametrize("wd", [0.0, 1e-2])
def test_functional_adam_matches_torch_adam_chain(rng, wd):
    w0 = {"a": rng.normal(size=(5, 3)).astype(np.float32),
          "b": rng.normal(size=(4,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in w0.items()} for _ in range(12)]
    tx = JO.torch_adam(0.01, weight_decay=wd)
    jw = {k: jnp.asarray(v) for k, v in w0.items()}
    jstate = tx.init(jw)
    for g in grads:
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                jstate, jw)
        jw = optax.apply_updates(jw, upd)
    tw = {k: _t(v.copy()) for k, v in w0.items()}
    state = O.adam_init(tw)
    for g in grads:
        state = O.adam_update(tw, {k: _t(v) for k, v in g.items()}, state,
                              lr=0.01, weight_decay=wd)
    assert state.count == 12 == int(jstate[1].count)
    for k in w0:
        np.testing.assert_allclose(tw[k].numpy(), np.asarray(jw[k]),
                                   rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(state.mu[k].numpy(),
                                   np.asarray(jstate[1].mu[k]), rtol=1e-6,
                                   atol=1e-10)
    # carried across, the JAX state continues identically in the port
    carried = O.opt_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                     device="cpu")
    assert carried.count == 12
    np.testing.assert_array_equal(carried.nu["a"].numpy(),
                                  np.asarray(jstate[1].nu["a"]))


def test_sparse_dense_adam_matches_jax(rng):
    from sml_tpu.models.mf import init_mf as jax_init_mf

    n_u, n_i, d, b = 23, 17, 8, 12
    lr = 0.01
    jmf = jax_init_mf(jax.random.PRNGKey(0), n_u, n_i, d)
    jstate = JO.torch_adam(lr).init(jmf)
    tmf = MFParams(*(_t(np.array(x)) for x in jmf))
    tstate = O.opt_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                    device="cpu")
    for _ in range(7):
        u = rng.integers(0, n_u - 4, b)          # rows n_u-4.. never touched
        i = rng.integers(0, n_i, b)
        j = i[::-1].copy()                       # duplicates
        gu, gi, gj = (rng.normal(size=(b, d)).astype(np.float32)
                      for _ in range(3))
        jmf, jstate = JO.sparse_dense_adam_update(
            jmf, jstate,
            {"user_emb": JO.TableGrad(jnp.asarray(u, jnp.int32),
                                      jnp.asarray(gu)),
             "item_emb": JO.TableGrad(jnp.asarray(np.concatenate([i, j]),
                                                  jnp.int32),
                                      jnp.asarray(np.concatenate([gi, gj])))},
            lr=lr)
        tstate = O.sparse_dense_adam_update(
            tmf, tstate,
            {"user_emb": O.TableGrad(_t(u), _t(gu)),
             "item_emb": O.TableGrad(_t(np.concatenate([i, j])),
                                     _t(np.concatenate([gi, gj])))},
            lr=lr)
    assert tstate.count == int(jstate[1].count) == 7
    for name in JaxMF._fields:
        np.testing.assert_allclose(getattr(tmf, name).numpy(),
                                   np.asarray(getattr(jmf, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
        for part in ("mu", "nu"):
            np.testing.assert_allclose(
                getattr(tstate, part)[name].numpy(),
                np.asarray(getattr(getattr(jstate[1], part), name)),
                rtol=1e-6, atol=1e-7, err_msg=f"{part} {name}")


def test_collapse_duplicates_sums_every_occurrence():
    idx = torch.tensor([5, 2, 5, 9, 2, 5])
    rows = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    got = O._collapse_duplicates(idx, rows)
    want = torch.stack([rows[idx == v].sum(0) for v in idx.tolist()])
    assert torch.equal(got, want)
