"""Full-catalog top-K over a row-sharded item table against the JAX
package: the port's ``make_sharded_full_topk`` on 2 and 4 gloo ranks and
the JAX one on the 8-device CPU mesh, for ``exact``, ``exact_sort`` and
``exact_bucket``, give equal ids on tie-free scores (N(0,1) tables: no two
f32 scores of a row are equal) and scores within rtol 1e-6; the port's
``recommend(mesh=...)`` gives the dense answer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sml_tpu.eval.full_ranking import dense_full_topk, make_sharded_full_topk
from sml_tpu_torch.parallel.dryrun import run_world

METHODS = ("exact", "exact_sort", "exact_bucket")


@pytest.mark.parametrize("n_model", [2, 4])
def test_sharded_topk_matches_jax(rng, n_model):
    users = rng.normal(size=(32, 16)).astype(np.float32)
    items = rng.normal(size=(160, 16)).astype(np.float32)
    k = 8
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(1, 8),
                ("data", "model"))
    sharded_items = jax.device_put(jnp.asarray(items),
                                   NamedSharding(mesh, P("model")))
    got = run_world("torch_parallel_workers:sharded_topk", n_model,
                    device="cpu", args=(users, items, k, METHODS, n_model),
                    timeout_s=120)
    dense_s, dense_i = map(np.asarray, dense_full_topk(
        jnp.asarray(users), jnp.asarray(items), k, topk_method="exact_sort"))
    for method in METHODS:
        ws, wi = map(np.asarray, make_sharded_full_topk(
            mesh, k, None, method)(jnp.asarray(users), sharded_items))
        for rank in got:
            s, i = rank[method]
            np.testing.assert_array_equal(i, wi)
            np.testing.assert_allclose(s, ws, rtol=1e-6)
    s, i = got[0]["recommend"]
    np.testing.assert_array_equal(i, dense_i)
    np.testing.assert_allclose(s, dense_s, rtol=1e-6)
