"""``python -m sml_tpu_torch.scripts.scale_engine_run`` against the JAX
package's ``scripts/scale_engine_run.py``, its sharded form against one
process, ``utils/results.record`` against ``sml_tpu/utils/results.py``,
and the lazy ``.npz`` read that ``rank`` serves from (``cli.npz_arrays``).

* both scripts, run at one tiny shape on the CPU, print one JSON line with
  the same keys, and the same ``users``, ``items``,
  ``interactions_per_epoch`` and ``eval_rows`` (the same numpy draws);
* ``--devices 2`` (a gloo world of two spawned CPU ranks, the state born
  row-sharded on a (1, 2) mesh) against one process: the saved tables
  within 1e-4, every phase's per-batch losses within rtol 1e-5 (the limits
  of the parallel layer's tests); users and items rounded down to a
  multiple of the rank count, as the JAX script rounds them;
* the script raises on a host without a GPU unless given ``--device cpu``;
* ``record``: four processes each add a key and all four are kept; for
  the same calls its file equals the JAX package's byte for byte;
* ``npz_arrays``: stored members memory-mapped (only the rows taken are
  read), compressed ones read whole, each equal to ``np.load``; ``rank``'s
  loader cuts the item block from the map.
"""

import json
import multiprocessing as mp
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sml_tpu.utils import results as jax_results
from sml_tpu_torch.cli import _load_mf, npz_arrays
from sml_tpu_torch.scripts import scale_engine_run
from sml_tpu_torch.utils import results

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--users", "3000", "--items", "700", "--inter", "4000",
        "--eval-rows", "64", "--neg", "99", "--phases", "1"]
# tables and losses of a two-rank world against one process (the parallel
# layer's limits: the CPU's products round the last bit differently on
# half-size blocks)
TABLE_ATOL, LOSS_RTOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def jax_line():
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "scale_engine_run.py"),
         "--platform", "cpu"] + TINY,
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


def _port_line(capsys, argv):
    assert scale_engine_run.main(["--device", "cpu"] + argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


def test_one_line_with_the_jax_scripts_keys_and_data(jax_line, capsys,
                                                     tmp_path):
    out = str(tmp_path / "res.json")
    got = _port_line(capsys, TINY + ["--out", out, "--key", "tiny"])
    assert list(got) == list(jax_line)
    assert list(got["phase_seconds_all"]) == list(
        jax_line["phase_seconds_all"])
    for key in ("users", "items", "interactions_per_epoch", "eval_rows",
                "latent", "snapshot_dtype", "devices"):
        assert got[key] == jax_line[key], key
    assert got["backend"] == "cpu"
    assert 0.0 <= got["recall@20_synthetic_probe"] <= 1.0
    with open(out) as fh:
        assert json.load(fh) == {"tiny": got}


def test_bf16_snapshots_refresh_through_the_plain_transfer():
    from sml_tpu_torch.ops.transfer_kernel import transfer_rows_plain
    args = scale_engine_run.build_parser().parse_args(
        TINY + ["--device", "cpu", "--snapshot-dtype", "bfloat16",
                "--phases", "2"])
    run = scale_engine_run.run_scale(args, "cpu")
    st = run.state
    assert st.hat_user.dtype == torch.bfloat16
    assert st.last_item.dtype == torch.bfloat16
    # the final tables are the last refresh of the final snapshots
    for table, last, hat, tower in (
            (st.mf.user_emb, st.last_user, st.hat_user, st.theta.user),
            (st.mf.item_emb, st.last_item, st.hat_item, st.theta.item)):
        torch.testing.assert_close(table, transfer_rows_plain(tower, last,
                                                              hat))
    assert run.info["inner_steps"] == -(-run.result[
        "interactions_per_epoch"] // args.batch)
    assert len(run.info["losses"]["inner"]) == 2
    assert not run.info["fast_table_adam"]      # 3,700 rows: dense


def test_two_ranks_match_one_process(tmp_path):
    base = TINY + ["--device", "cpu", "--phases", "2", "--users", "3001",
                   "--items", "701"]
    parser = scale_engine_run.build_parser()
    one_path, two_path = str(tmp_path / "one.npz"), str(tmp_path / "two.npz")
    res2, info2 = scale_engine_run.run(parser.parse_args(
        base + ["--devices", "2", "--save-model", two_path]))
    # one process at the rounded shape
    res1, info1 = scale_engine_run.run(parser.parse_args(
        base[:-4] + ["--users", "3000", "--items", "700",
                     "--save-model", one_path]))
    assert (res2["users"], res2["items"], res2["devices"]) == (3000, 700, 2)
    assert res2["interactions_per_epoch"] == res1["interactions_per_epoch"]
    assert len(info2["ranks"]) == 2
    one, two = np.load(one_path), np.load(two_path)
    assert sorted(one.files) == sorted(two.files) == sorted(
        ["user_emb", "item_emb", "user_bias", "item_bias"])
    for f in one.files:
        assert one[f].shape == two[f].shape
        np.testing.assert_allclose(two[f], one[f], rtol=0, atol=TABLE_ATOL)
    for part in ("inner", "outer"):
        for rank in info2["ranks"]:
            np.testing.assert_allclose(rank["losses"][part],
                                       info1["losses"][part],
                                       rtol=LOSS_RTOL)


def test_no_gpu_raises_unless_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        scale_engine_run.main(TINY)
    with pytest.raises(RuntimeError, match="cuda"):
        scale_engine_run.main(TINY + ["--devices", "2"])
    assert capsys.readouterr().out == ""


def _record_four(path, module, key):
    import importlib
    importlib.import_module(module).record(path, key, {"key": key, "n": 1})


@pytest.mark.parametrize("module", ["sml_tpu_torch.utils.results",
                                    "sml_tpu.utils.results"])
def test_record_keeps_every_processs_key(tmp_path, module):
    path = str(tmp_path / "sub" / "res.json")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_record_four, args=(path, module, f"k{r}"))
             for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(60)
        assert p.exitcode == 0
    with open(path) as fh:
        data = json.load(fh)
    assert data == {f"k{r}": {"key": f"k{r}", "n": 1} for r in range(4)}


def test_record_writes_the_jax_packages_file(tmp_path):
    calls = [("a", {"x": 1.5, "y": [1, 2]}), ("b", 3), ("a", "again"),
             ("c", {"nested": {"z": None}})]
    mine, theirs = str(tmp_path / "mine.json"), str(tmp_path / "theirs.json")
    for key, value in calls:
        results.record(mine, key, value)
        jax_results.record(theirs, key, value)
        with open(mine, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read()


def test_npz_arrays_map_stored_members_and_read_compressed(tmp_path, rng):
    arrays = {"user_emb": rng.normal(size=(37, 5)).astype(np.float32),
              "item_emb": rng.normal(size=(23, 5)).astype(np.float32),
              "user_bias": np.zeros((37, 1), np.float32),
              "empty": np.zeros((0, 4), np.float32),
              "fortran": np.asfortranarray(
                  rng.normal(size=(6, 7)).astype(np.float32)),
              "ints": np.arange(12, dtype=np.int64).reshape(3, 4)}
    for save, mapped in ((np.savez, True), (np.savez_compressed, False)):
        path = str(tmp_path / f"m_{save.__name__}.npz")
        save(path, **arrays)
        got = npz_arrays(path)
        with np.load(path) as want:
            assert sorted(got) == sorted(want.files)
            for name in want.files:
                np.testing.assert_array_equal(got[name], want[name])
                assert got[name].dtype == want[name].dtype
        assert isinstance(got["user_emb"], np.memmap) == mapped
        assert not isinstance(got["empty"], np.memmap)
        # rows taken from the map are the file's rows
        np.testing.assert_array_equal(got["user_emb"][[30, 2, 2]],
                                      arrays["user_emb"][[30, 2, 2]])


def test_load_mf_cuts_the_item_block_from_the_map(tmp_path, rng):
    path = str(tmp_path / "m.npz")
    tables = {"user_emb": rng.normal(size=(9, 4)).astype(np.float32),
              "item_emb": rng.normal(size=(12, 4)).astype(np.float32),
              "user_bias": rng.normal(size=(9, 1)).astype(np.float32),
              "item_bias": rng.normal(size=(12, 1)).astype(np.float32)}
    np.savez(path, **tables)
    mf = _load_mf(path, torch.device("cpu"), slice(4, 8))
    np.testing.assert_array_equal(mf.item_emb.numpy(),
                                  tables["item_emb"][4:8])
    np.testing.assert_array_equal(mf.user_emb.numpy(), tables["user_emb"])
    # a loaded table is the process's own memory: training writes to it
    mf.user_emb.add_(1.0)
    np.testing.assert_array_equal(np.load(path)["user_emb"],
                                  tables["user_emb"])
