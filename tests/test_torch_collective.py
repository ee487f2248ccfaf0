"""The port's collectives and explicit lookup over row shards against the
JAX package's, on gloo worlds of CPU ranks.

* ``collective_gather`` on 2 and 4 ranks against the JAX
  ``collective_gather`` on the 8-device CPU mesh (rtol 1e-6), with
  duplicate and boundary ids; its gradient is the scatter-add of the
  incoming rows, with no second reduction (a double reduction would scale
  it by the rank count);
* the lookup taken apart as a split step takes it (the layout's owned
  rows into a buffer, the all-reduce, the rows from the summed buffer)
  equals ``collective_gather`` bit for bit, rows and gradient, on 2 ranks;
* ``make_sharded_mf_train_step`` against the JAX one (rtol 2e-5, atol
  1e-6, the JAX test's tolerance against dense math);
* all-reduce, all-gather and broadcast over each axis of a (2, 2) mesh,
  ``replicate``, ``global_batch`` and ``process_slice``, and the mesh's
  row-major coordinates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sml_tpu.parallel.collective import collective_gather as jax_gather
from sml_tpu.parallel.collective import make_sharded_mf_train_step
from sml_tpu_torch.parallel.dryrun import run_world

WORKERS = "torch_parallel_workers"
TIMEOUT_S = 120


def _jax_mesh():
    return Mesh(np.asarray(jax.devices()[:8]).reshape(1, 8),
                ("data", "model"))


@pytest.mark.parametrize("n_model", [2, 4])
def test_collective_gather_and_grad_match_jax(rng, n_model):
    table = rng.normal(size=(64, 16)).astype(np.float32)
    # duplicates, both ends of the table and every shard boundary
    idx = np.concatenate([rng.integers(0, 64, 32), [0, 0, 63, 63, 7, 8, 15,
                                                   16, 31, 32, 47, 48]])
    idx = idx.astype(np.int64)
    w = rng.normal(size=(idx.shape[0], 16)).astype(np.float32)
    ranks = run_world(f"{WORKERS}:gather_and_grad", n_model, device="cpu",
                      args=(table, idx, w, n_model), timeout_s=TIMEOUT_S)

    mesh = _jax_mesh()
    fn = jax.shard_map(lambda t, i: jax_gather(t, i), mesh=mesh,
                       in_specs=(P("model"), P()), out_specs=P(),
                       check_vma=False)
    want = np.asarray(jax.jit(fn)(jnp.asarray(table),
                                  jnp.asarray(idx, jnp.int32)))
    for rows, _ in ranks:
        np.testing.assert_allclose(rows, want, rtol=1e-6)
    np.testing.assert_array_equal(ranks[0][0], table[idx])

    grad = np.concatenate([g for _, g in ranks])
    scatter = np.zeros_like(table)
    np.add.at(scatter, idx, w)
    np.testing.assert_allclose(grad, scatter, rtol=1e-6, atol=1e-6)


def test_split_lookup_equals_collective_gather(rng):
    table = rng.normal(size=(64, 16)).astype(np.float32)
    idx = np.concatenate([rng.integers(0, 64, 40), [0, 31, 32, 63, 63]])
    w = rng.normal(size=(idx.shape[0], 16)).astype(np.float32)
    ranks = run_world(f"{WORKERS}:split_lookup", 2, device="cpu",
                      args=(table, idx.astype(np.int64), w, 2),
                      timeout_s=TIMEOUT_S)
    for (rows, grad), (split_rows, split_grad) in ranks:
        np.testing.assert_array_equal(split_rows, rows)
        np.testing.assert_array_equal(split_grad, grad)
        np.testing.assert_array_equal(rows, table[idx])


def test_sharded_mf_step_matches_jax(rng):
    n_u, n_i, d, b = 64, 32, 8, 16
    ut = rng.normal(size=(n_u, d)).astype(np.float32)
    it = rng.normal(size=(n_i, d)).astype(np.float32)
    u, i, j = (rng.integers(0, n, b).astype(np.int64)
               for n in (n_u, n_i, n_i))
    mesh = _jax_mesh()
    row = NamedSharding(mesh, P("model"))
    step = make_sharded_mf_train_step(mesh, lr=0.01, l2=1e-5)
    wu, wi, wl = step(jax.device_put(jnp.asarray(ut), row),
                      jax.device_put(jnp.asarray(it), row),
                      *(jnp.asarray(x, jnp.int32) for x in (u, i, j)))
    ranks = run_world(f"{WORKERS}:mf_step", 4, device="cpu",
                      args=(ut, it, u, i, j, 4), timeout_s=TIMEOUT_S)
    got_u = np.concatenate([r[0] for r in ranks])
    got_i = np.concatenate([r[1] for r in ranks])
    np.testing.assert_allclose(got_u, np.asarray(wu), rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got_i, np.asarray(wi), rtol=2e-5, atol=1e-6)
    for r in ranks:
        np.testing.assert_allclose(r[2], float(wl), rtol=2e-5)


def test_transport_over_each_axis():
    ranks = run_world(f"{WORKERS}:transport", 4, device="cpu",
                      timeout_s=TIMEOUT_S)
    for rank, out in enumerate(ranks):
        d, m = divmod(rank, 2)
        assert out["coords"] == (d, m) and out["local_rank"] == m
        assert out["transport"] == "gloo"
        # data group: ranks m and 2 + m; model group: 2d and 2d + 1
        data_ranks, model_ranks = (m, 2 + m), (2 * d, 2 * d + 1)
        for axis, members in (("data", data_ranks),
                              ("model", model_ranks)):
            np.testing.assert_array_equal(out[f"sum_{axis}"],
                                          np.full(3, float(sum(members))))
            np.testing.assert_array_equal(
                out[f"gather_{axis}"],
                np.repeat(np.asarray(members, np.float32), 2)[:, None])
            np.testing.assert_array_equal(out[f"bcast_{axis}"],
                                          np.full(2, float(members[1])))
        np.testing.assert_array_equal(out["replicated"], np.zeros(2))
        # 5 rows padded to 8: data rank d keeps rows [4d, 4d + 4); n_real
        # stays the whole set's
        rows, mask, n_real = out["batch"]
        want = np.zeros((8, 2), np.int32)
        want[:5] = np.arange(10).reshape(5, 2)
        np.testing.assert_array_equal(rows, want[4 * d:4 * d + 4])
        np.testing.assert_array_equal(mask, (np.arange(8) < 5)[4 * d:4 * d
                                                               + 4])
        assert n_real == 5
        assert out["process_slice"] == slice(2 * rank, 2 * rank + 2)
