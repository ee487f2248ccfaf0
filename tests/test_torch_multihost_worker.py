"""``sml_tpu_torch.scripts.multihost_worker`` on two simulated hosts of one
gloo CPU rank each, at ``tests/test_multihost.py``'s width: every check
met (fused against unfused digests and hits, launches as derived, the
world against rank 0 alone), and rank 0's ``.npz`` in the JAX worker's
format: ``user_emb``, ``item_emb``, ``losses`` (each phase's mean inner
and outer loss) and ``theta_<i>`` in the order of the JAX engine's Θ
leaves, at their shapes.
"""

import json

import jax
import numpy as np

from sml_tpu.train.engine import SMLEngine as JaxEngine
from sml_tpu_torch.scripts import multihost_worker
from test_multihost import N_ITEMS, N_USERS, mk_cfg


def test_the_worker_on_two_hosts_writes_the_jax_workers_npz(tmp_path,
                                                            capsys):
    out = tmp_path / "mh.npz"
    rc = multihost_worker.main(["--hosts", "2", "--ranks-per-host", "1",
                                "--device", "cpu", "--width", "tiny",
                                "--out", str(out)])
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and doc["failed"] == [], doc["failed"]
    assert doc["mesh"] == [2, 1]
    assert doc["transport"] == {"data": "gloo", "model": "local"}
    assert [r["host"] for r in doc["ranks"]][0] != doc["ranks"][1]["host"]
    assert doc["sweep_fused_vs_unfused"] == {"user": 0.0, "item": 0.0,
                                             "theta": 0.0}
    got = np.load(out)
    jax_theta = jax.tree.leaves(
        JaxEngine(mk_cfg(), N_USERS, N_ITEMS).init_state().theta)
    assert sorted(got.files) == sorted(
        ["user_emb", "item_emb", "losses"]
        + [f"theta_{i}" for i in range(len(jax_theta))])
    assert got["user_emb"].shape == (N_USERS, 16)
    assert got["item_emb"].shape == (N_ITEMS, 16)
    assert got["losses"].shape == (2, 2)
    assert np.isfinite(got["losses"]).all()
    for i, leaf in enumerate(jax_theta):
        assert got[f"theta_{i}"].shape == leaf.shape, i
