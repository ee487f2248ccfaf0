"""The port's transfer refresh (K1's plain path) against the JAX package.

Same numpy inputs and the same Θ (carried across with
``theta_from_numpy``) go through ``sml_tpu`` and ``sml_tpu_torch`` on the
CPU. The JAX Pallas kernel runs in interpret mode, as its own tests run it.
Tolerance 3e-5 (``tests/test_transfer_kernel.py``): both sides are f32,
summing over C2*d (320 at the Yelp shape, up to 896) and H terms in
different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sml_tpu.config import TransferConfig as JaxTransferConfig
from sml_tpu.models import transfer as JT
from sml_tpu.ops.transfer_kernel import fused_table_transfer as jax_fused
from sml_tpu_torch.config import TransferConfig
from sml_tpu_torch.models import transfer as T
from sml_tpu_torch.ops import transfer_kernel as TK

TOL = dict(rtol=3e-5, atol=3e-5)


def _theta(d, seed=1, c2=5, h=512):
    jt = JT.init_transfer(jax.random.PRNGKey(seed),
                          JaxTransferConfig(latent_dim=d, conv2_channels=c2,
                                            fc_hidden=h))
    return jt, T.theta_from_numpy(jax.tree.map(np.asarray, jt), device="cpu")


def _rows(rng, n, d):
    return rng.normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("side", ["user", "item"])
@pytest.mark.parametrize("d,n", [(64, 300), (16, 500)])
def test_apply_rows_matches_jax(rng, d, n, side):
    jt, tt = _theta(d)
    last, hat = _rows(rng, n, d), _rows(rng, n, d)
    want = JT.apply_rows(jt, JaxTransferConfig(latent_dim=d), side,
                         jnp.asarray(last), jnp.asarray(hat))
    got = T.apply_rows(tt, TransferConfig(latent_dim=d), side,
                       torch.from_numpy(last), torch.from_numpy(hat))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("d,n", [(64, 300), (16, 500)])
def test_apply_tables_matches_jax_blocked(rng, d, n):
    jt, tt = _theta(d)
    lu, hu, li, hi = (_rows(rng, n, d), _rows(rng, n, d),
                      _rows(rng, n // 2, d), _rows(rng, n // 2, d))
    wu, wi = JT.apply_tables(jt, JaxTransferConfig(latent_dim=d),
                             *map(jnp.asarray, (lu, hu, li, hi)),
                             block_rows=128, use_pallas="never")
    # a block size that does not divide n exercises the ragged last block
    gu, gi = T.apply_tables(tt, TransferConfig(latent_dim=d),
                            *map(torch.from_numpy, (lu, hu, li, hi)),
                            block_rows=128)
    np.testing.assert_allclose(gu.numpy(), np.asarray(wu), **TOL)
    np.testing.assert_allclose(gi.numpy(), np.asarray(wi), **TOL)
    assert gu.dtype == torch.float32 and gu.shape == (n, d)


# the Yelp tower, and widths / channel counts / hidden sizes that the card's
# kernel holds against this plain version (beyond 64 rows of d = 64)
@pytest.mark.parametrize("d,c2,h", [(64, 5, 512), (80, 5, 512), (128, 7, 256),
                                    (10, 5, 64)])
@pytest.mark.parametrize("n", [256, 700])
def test_plain_matches_jax_pallas_interpret(rng, n, d, c2, h):
    from jax.experimental.pallas import tpu as pltpu

    jt, tt = _theta(d, seed=3, c2=c2, h=h)
    last, hat = _rows(rng, n, d), _rows(rng, n, d)
    with pltpu.force_tpu_interpret_mode():
        want = jax_fused(jt.user, jnp.asarray(last), jnp.asarray(hat),
                         block_rows=256)
    got = TK.fused_table_transfer(tt.user, torch.from_numpy(last),
                                  torch.from_numpy(hat))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bf16_snapshots_match_jax(rng):
    """bf16 snapshots: both packages round the same f32 values to the same
    bf16 bits and upcast before the f32 math, so they agree to 3e-5; the
    result stays within 2e-2 of the unrounded f32 refresh (bf16 keeps 8
    mantissa bits, ~4e-3 relative per input, through the tower)."""
    d, n = 64, 300
    jt, tt = _theta(d)
    last, hat = _rows(rng, n, d), _rows(rng, n, d)
    jl, jh = (jnp.asarray(x, jnp.bfloat16) for x in (last, hat))
    tl, th = (torch.from_numpy(x).to(torch.bfloat16) for x in (last, hat))
    np.testing.assert_array_equal(
        np.asarray(jl).view(np.uint16),
        tl.view(torch.int16).numpy().view(np.uint16))
    cfg = JaxTransferConfig(latent_dim=d)
    wu, _ = JT.apply_tables(jt, cfg, jl, jh, jl, jh, block_rows=128,
                            use_pallas="never")
    gu, _ = T.apply_tables(tt, TransferConfig(latent_dim=d), tl, th, tl, th)
    np.testing.assert_allclose(gu.numpy(), np.asarray(wu), **TOL)
    f32 = JT.apply_rows(jt, cfg, "user", jnp.asarray(last), jnp.asarray(hat))
    np.testing.assert_allclose(gu.numpy(), np.asarray(f32), rtol=0,
                               atol=2e-2)


def test_zero_last_rows_give_finite_output(rng):
    d, n = 64, 128
    jt, tt = _theta(d)
    last = np.zeros((n, d), np.float32)
    last[::3] = _rows(rng, len(range(0, n, 3)), d)
    hat = _rows(rng, n, d)
    got = TK.fused_table_transfer(tt.user, torch.from_numpy(last),
                                  torch.from_numpy(hat))
    assert torch.isfinite(got).all()
    want = JT.apply_rows(jt, JaxTransferConfig(latent_dim=d), "user",
                         jnp.asarray(last), jnp.asarray(hat))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_theta_keeps_jax_layout():
    jt, tt = _theta(16)
    for side in ("user", "item"):
        for f in T.ConvTower.FIELDS:
            j = np.asarray(getattr(getattr(jt, side), f))
            t = getattr(getattr(tt, side), f).detach().numpy()
            assert t.shape == j.shape, (side, f)
            np.testing.assert_array_equal(t, j)
    # mappings carry across the same way
    tree = {s: {f: np.asarray(getattr(getattr(jt, s), f))
                for f in T.ConvTower.FIELDS} for s in ("user", "item")}
    tt2 = T.theta_from_numpy(tree, device="cpu")
    for a, b in zip(tt.parameters(), tt2.parameters()):
        assert torch.equal(a, b)


def test_init_transfer_uses_torch_default_bounds():
    cfg = TransferConfig(latent_dim=16)
    th = T.init_transfer(torch.Generator().manual_seed(0), cfg, device="cpu")
    jt = JT.init_transfer(jax.random.PRNGKey(0),
                          JaxTransferConfig(latent_dim=16))
    fan_in = {"conv1_w": 3, "conv1_b": 3, "conv2_w": 10, "conv2_b": 10,
              "fc1_w": 80, "fc1_b": 80, "fc2_w": 512, "fc2_b": 512}
    for f, fi in fan_in.items():
        t = getattr(th.user, f).detach()
        assert tuple(t.shape) == np.asarray(getattr(jt.user, f)).shape
        assert t.abs().max() <= 1.0 / np.sqrt(fi)
    again = T.init_transfer(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    for a, b in zip(th.parameters(), again.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["conv2ch", "conv_com_root", "mlp_delta",
                                  "linear", "gru", "gated"])
def test_unported_kinds_raise(kind):
    """The six kinds that raised before they were ported now initialise
    and refresh on the CPU; an unknown kind still raises."""
    cfg = TransferConfig(latent_dim=8, fc_hidden=16, kind=kind)
    th = T.init_transfer(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(1))
    u, i = T.apply_tables(th, cfg, x, x, x[:3], x[:3])
    assert u.shape == (4, 8) and i.shape == (3, 8)
    assert torch.isfinite(u).all() and torch.isfinite(i).all()
    bad = TransferConfig(latent_dim=8, kind=kind + "_x")
    with pytest.raises(ValueError, match="unknown transfer kind"):
        T.init_transfer(torch.Generator().manual_seed(0), bad, device="cpu")
    with pytest.raises(ValueError, match="unknown transfer kind"):
        T.apply_tables(th, bad, x, x, x, x)
