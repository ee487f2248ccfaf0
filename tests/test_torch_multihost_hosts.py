"""The multi-host layout on simulated hosts: two hosts of two gloo CPU
ranks each (``run_world(..., hosts=2)``), at the sizes of
``tests/test_multihost.py`` (320 users, 160 items, d=16, H=64, batches
128/64), as the JAX package lays out its processes
(``sml_tpu/parallel/multihost.py``): ``model`` inside a host, ``data``
across hosts.

* ``make_global_mesh()`` is ``(2, 2)``: its 'data' groups ``{0, 2}`` and
  ``{1, 3}`` each span both hosts, its 'model' groups are the hosts, and
  each rank's local rank counts within its own host. Hosts made uneven or
  interleaved raise on every rank, naming them.
* Two replay-mode SML phases from the JAX engine's initial state carried
  across, on that mesh, against ``sml_tpu``'s single-process trajectory:
  tables, Θ and the per-batch losses within rtol 2e-4, atol 2e-5 (the
  tolerance of ``tests/test_multihost.py``).
* A sampled ('alone') run on that mesh against one rank of the port:
  every rank draws the whole batch from the same generator, so the
  tables and Θ agree within 1e-5.
* The transport rule (``multihost.place_ranks``, then
  ``collective.backend_for``) on made-up hosts and card identities: NCCL
  only where no two ranks hold the same card, whatever each process
  sees.

One world serves every case (one intra-op thread a rank).
"""

import numpy as np
import pytest

from sml_tpu_torch.parallel.collective import backend_for
from sml_tpu_torch.parallel.dryrun import run_world
from sml_tpu_torch.parallel.multihost import host_layout, place_ranks
from test_torch_multihost import (N_ITEMS, N_USERS, TIMEOUT_S, TOL, _cfgs,
                                  jax_runs)

WORKERS = "torch_parallel_workers"


@pytest.fixture(scope="module")
def world(jax_runs):
    """One world of two simulated hosts of two CPU ranks: rank 0's layout,
    replay phases and sampled run (every rank's layout), and the JAX
    run they are held to."""
    (tcfg, path, inner, outer, test_rows, jstate, jlosses,
     _) = jax_runs(True)
    rng = np.random.default_rng(5)

    def pairs(n):
        return np.unique(np.stack([rng.integers(0, N_USERS, n),
                                   rng.integers(0, N_ITEMS, n)], 1), axis=0)
    _, scfg = _cfgs(mf_sample="alone", tr_sample_type="alone",
                    fast_table_adam=True)
    ranks = run_world(
        f"{WORKERS}:two_hosts", 4, device="cpu",
        args=((tcfg, N_USERS, N_ITEMS, path, inner, outer, test_rows),
              (scfg, N_USERS, N_ITEMS, pairs(700), pairs(300))),
        timeout_s=TIMEOUT_S, hosts=2)
    return ranks, jstate, jlosses


def test_two_hosts_make_a_2x2_mesh_whose_data_axis_spans_them(world):
    ranks = world[0]
    hosts = ranks[0]["layout"]["hosts"]
    assert hosts[0] == hosts[1] != hosts[2] == hosts[3]
    for r, res in enumerate(ranks):
        lay = res["layout"]
        assert lay["hosts"] == hosts
        assert lay["shape"] == (2, 2)
        assert lay["coords"] == (r // 2, r % 2)
        assert lay["ranks_data"] == [r % 2, r % 2 + 2]
        assert lay["ranks_model"] == [r - r % 2, r - r % 2 + 1]
        assert (lay["local_rank"], lay["local_world"]) == (r % 2, 2)
        assert lay["sum_data"] == 2.0 * (r % 2) + 2.0
        assert lay["sum_model"] == 2.0 * (r - r % 2) + 1.0
        assert lay["cards"] == [None] * 4
        assert lay["backend"] == "gloo"
        assert lay["transport_data"] == lay["transport_model"] == "gloo"
        errors = res["errors"]
        assert "ranks by host" in errors["uneven"]
        assert "contiguous" in errors["interleaved"]


def test_replay_phases_on_two_hosts_match_jax(world):
    ranks, jstate, jlosses = world
    got = ranks[0]["replay"]
    np.testing.assert_allclose(got["user_emb"],
                               np.asarray(jstate.mf.user_emb), **TOL)
    np.testing.assert_allclose(got["item_emb"],
                               np.asarray(jstate.mf.item_emb), **TOL)
    for k, v in got["theta"].items():
        side, f = k.split("/")
        np.testing.assert_allclose(
            v, np.asarray(getattr(getattr(jstate.theta, side), f)),
            err_msg=k, **TOL)
    assert len(got["losses"]) == len(jlosses) == 2
    for (gi, go), (wi, wo) in zip(got["losses"], jlosses):
        np.testing.assert_allclose(gi, wi, **TOL)
        np.testing.assert_allclose(go, wo, **TOL)
    assert got["mf_count"] == int(jstate.mf_opt[1].count)


def test_sampled_run_on_two_hosts_matches_one_rank(world):
    got = world[0][0]["sampled"]
    one = got["one"]
    for f in ("user_emb", "item_emb"):
        np.testing.assert_allclose(got[f], one[f], rtol=1e-5, atol=1e-5)
    for k, v in got["theta"].items():
        np.testing.assert_allclose(v, one["theta"][k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("hosts,error", [
    (["a", "a", "b"], "ranks by host {'a': 2, 'b': 1}"),
    (["a", "b", "b", "b"], "ranks by host {'a': 1, 'b': 3}"),
    (["a", "b", "a", "b"], "contiguous"),
    (["a", "b", "b", "a"], "contiguous")])
def test_a_bad_host_layout_raises(hosts, error):
    with pytest.raises(ValueError, match=error.replace("{", r"\{")):
        host_layout(hosts)


def test_host_layout_shapes():
    assert host_layout(["a", "a", "b", "b"]) == (2, 2)
    assert host_layout(["a", "b", "c", "d"]) == (4, 1)
    assert host_layout(["a"] * 4) == (1, 4)
    assert host_layout(["a"] * 4 + ["b"] * 4, n_model=2) == (4, 2)
    with pytest.raises(ValueError, match="model groups of 3"):
        host_layout(["a"] * 4, n_model=3)


@pytest.mark.parametrize("world,want", [
    # one card per rank, each process shown only its own card (one
    # CUDA_VISIBLE_DEVICES a rank; the count rule took this for sharing)
    ([("h0", ["A"]), ("h0", ["B"]), ("h0", ["C"]), ("h0", ["D"])], "nccl"),
    ([("h0", ["A"]), ("h1", ["B"])], "nccl"),
    # one host of four ranks seeing its four cards
    ([("h0", ["A", "B", "C", "D"])] * 4, "nccl"),
    # two hosts of two ranks, each host seeing its own two cards
    ([("h0", ["A", "B"])] * 2 + [("h1", ["C", "D"])] * 2, "nccl"),
    # one rank alone on a card
    ([("h0", ["A"])], "nccl"),
    # two ranks of one host on one card
    ([("h0", ["A"])] * 2, "gloo"),
    # two hosts that see the same card (the count rule took NCCL)
    ([("h0", ["A"]), ("h1", ["A"])], "gloo"),
    ([("h0", ["A", "B"])] * 2 + [("h1", ["A", "B"])] * 2, "gloo"),
    # ranks on the CPU
    ([("h0", [])] * 2, "gloo"),
    ([("h0", ["A"]), ("h1", [])], "gloo")])
def test_the_transport_follows_the_cards_the_ranks_hold(world, want):
    local_ranks, cards = place_ranks(world)
    hosts = [h for h, _ in world]
    assert local_ranks == [hosts[:r].count(h) for r, h in enumerate(hosts)]
    on_cpu = all(not seen for _, seen in world)
    assert backend_for("cpu" if on_cpu else "cuda", cards) == want
    # a CPU rank sees no card: gloo, whatever the others hold
    assert backend_for("cpu", [None] * len(world)) == "gloo"
