"""Row-sharded state and the sharded refresh against the JAX package, on
gloo worlds of CPU ranks, at the JAX tests' sizes (320 users, 160 items,
d=16, H=64).

* ``init_state_sharded`` equals ``init_state`` followed by ``shard_state``
  leaf for leaf, fresh and from pretrained tables, and keeps only row
  blocks; over 3 model ranks the 320 user rows do not divide and the user
  side stays replicated, as the JAX rule has it (``sharding.py:50-51``);
* ``apply_tables_sharded`` on 2 and 4 ranks against the JAX
  ``apply_tables_sharded`` on the 8-device CPU mesh, Θ carried by
  ``theta_from_numpy``: rtol 1e-6, with an absolute floor of 1e-7 for
  elements near 0 (the towers' f32 sums run in another order, a few ulp
  of values ~0.1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from sml_tpu.config import TransferConfig as JaxTransferConfig
from sml_tpu.models.transfer import apply_tables_sharded, init_transfer
from sml_tpu_torch.config import SMLConfig, TransferConfig
from sml_tpu_torch.parallel.dryrun import run_world

WORKERS = "torch_parallel_workers"
TIMEOUT_S = 120
N_USERS, N_ITEMS, DIM, H = 320, 160, 16, 64


def _cfg(**kw):
    return SMLConfig(latent_dim=DIM, mf_batch_size=128, tr_batch_size=64,
                     transfer=TransferConfig(latent_dim=DIM, fc_hidden=H),
                     **kw)


@pytest.mark.parametrize("mesh_shape,pretrained", [
    ((1, 2), False), ((2, 2), True), ((1, 3), False)])
def test_state_born_sharded_equals_shard_state(rng, mesh_shape, pretrained):
    pre = None
    if pretrained:
        pre = tuple(rng.normal(size=s).astype(np.float32)
                    for s in ((N_USERS, DIM), (N_ITEMS, DIM),
                              (N_USERS, 1), (N_ITEMS, 1)))
    n = mesh_shape[0] * mesh_shape[1]
    ranks = run_world(f"{WORKERS}:born_sharded", n, device="cpu",
                      args=(_cfg(emb_init_scale=0.5), N_USERS, N_ITEMS,
                            mesh_shape, pre), timeout_s=TIMEOUT_S)
    m = mesh_shape[1]
    for rank, (leaves, plan) in enumerate(ranks):
        assert all(eq for eq, _ in leaves.values()), leaves
        for path, (_, rows) in leaves.items():
            if path in ("theta", "gen"):
                continue
            n_side = N_USERS if "user" in path.rsplit("/", 1)[-1] \
                else N_ITEMS
            # the 3-rank model axis: 320 users stay whole, 160 items too
            # (neither divides by 3)
            want = n_side if n_side % m else n_side // m
            assert rows == want, (path, rows)
            block = plan[path]
            if n_side % m:
                assert block is None
            else:
                assert block == (n_side, (rank % m) * want, want)


def test_sharded_refresh_matches_jax(rng):
    jcfg = JaxTransferConfig(latent_dim=DIM, fc_hidden=H)
    theta = init_transfer(jax.random.PRNGKey(3), jcfg)
    tables = [rng.normal(size=(n, DIM)).astype(np.float32)
              for n in (N_USERS, N_USERS, N_ITEMS, N_ITEMS)]
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(1, 8),
                ("data", "model"))
    want = apply_tables_sharded(theta, jcfg, *map(jnp.asarray, tables),
                                mesh=mesh)
    tree = jax.tree.map(np.asarray, theta)
    tcfg = TransferConfig(latent_dim=DIM, fc_hidden=H)
    for n_model in (2, 4):
        got = run_world(f"{WORKERS}:sharded_refresh", n_model,
                        device="cpu", args=(tree, tcfg, tables, n_model),
                        timeout_s=TIMEOUT_S)[0]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6,
                                       atol=1e-7)
