"""``python -m sml_tpu_torch --coordinator ...`` with 2 CPU processes
against 1 process, on the ``synthetic_dataset`` fixture (300 users, 150
items).

* ``sml``: the same records (wall times and time stamps aside, within
  two hits of a test), written by process 0 alone; whole-table
  checkpoints and ``--save-model`` within 2e-5 of the 1-process run, and
  ``sml_tpu`` and a 1-process port run restore the checkpoint;
* a resume from the run's own checkpoint on both processes reports its
  summary; a resume where the processes see different checkpoint
  directories raises on every process, within the test's timeout;
* ``rank --shard`` prints the 1-process output;
* with a coordinator, ``cli.main`` frees every CUDA graph
  (``graphs.release_all``) before the world's barrier and
  ``destroy_process_group``, whether the command returns or raises (spies
  on the three, in a one-process world in the test's own process).

Every process runs one thread, with a finite timeout; on timeout every
process of the run is killed.
"""

import json

import numpy as np
import pytest

from sml_tpu_torch.parallel.dryrun import run_cli_world

TIMEOUT_S = 120
# two hits of a 600-row test
METRIC_ATOL = 2 / 600


def _run(argv, n=1):
    """The CLI on the CPU as ``n`` processes of one world (one process
    alone for ``n == 1``), one thread each; (returncode, stdout, stderr)
    of each."""
    return run_cli_world(argv, n, "cpu", TIMEOUT_S,
                         env={"OMP_NUM_THREADS": "1"})


def _records(path):
    with open(path) as fh:
        recs = [json.loads(line) for line in fh]
    for r in recs:
        for key in ("seconds", "total_seconds", "ts"):
            r.pop(key, None)
    return recs


@pytest.fixture(scope="module")
def runs(synthetic_dataset, tmp_path_factory):
    dspec, _, _ = synthetic_dataset
    tmp = tmp_path_factory.mktemp("mp_cli")
    data = ["--data-root", dspec.root, "--data-name", dspec.name,
            "--num-periods", "8", "--online-train-start", "3",
            "--online-test-start", "5", "--multi-num", "2", "--latent", "8",
            "--mf-sample", "alone", "--saddle-retries", "0"]

    def sml(tag):
        d = tmp / tag
        d.mkdir()
        return d, ["sml"] + data + [
            "--metrics-jsonl", str(d / "m.jsonl"), "--checkpoint-dir",
            str(d / "ck"), "--save-model", str(d / "final.npz")]
    one_dir, one_args = sml("one")
    two_dir, two_args = sml("two")
    one = _run(one_args)
    two = _run(two_args, 2)
    return {"one": (one_dir, one), "two": (two_dir, two), "data": data,
            "tmp": tmp}


def test_sml_two_processes_match_one(runs):
    (one_dir, one), (two_dir, two) = runs["one"], runs["two"]
    for rc, _, err in one + two:
        assert rc == 0, err[-3000:]
    got, want = _records(two_dir / "m.jsonl"), _records(one_dir / "m.jsonl")
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    for g, w in zip(got, want):
        for key, v in w.items():
            if isinstance(v, float):
                # the refresh's CPU products run on 150-row blocks instead
                # of 300 rows, which may round the last bit differently;
                # a near tie in a test then moves one hit of 600
                assert abs(g[key] - v) <= METRIC_ATOL, (g, w)
            else:
                assert g[key] == v, (g, w)
    # process 0 alone logs and prints the summary
    assert two[0][1].strip() and not two[1][1].strip()
    assert "multi-process: 2 processes" in two[0][2]
    for name in ("final.npz",):
        a, b = np.load(one_dir / name), np.load(two_dir / name)
        for f in ("user_emb", "item_emb", "user_bias", "item_bias"):
            np.testing.assert_allclose(b[f], a[f], rtol=2e-5, atol=2e-5)
    ck1 = np.load(sorted((one_dir / "ck").glob("ckpt_*.npz"))[-1])
    ck2 = np.load(sorted((two_dir / "ck").glob("ckpt_*.npz"))[-1])
    assert sorted(ck1.files) == sorted(ck2.files)
    for k in ck1.files:
        if ck1[k].dtype.kind == "f":
            np.testing.assert_allclose(ck2[k], ck1[k], rtol=2e-5, atol=2e-5,
                                       err_msg=k)


def test_sharded_checkpoint_restores_in_sml_tpu(runs, synthetic_dataset):
    from sml_tpu.config import SMLConfig, TransferConfig
    from sml_tpu.train.engine import SMLEngine
    from sml_tpu.utils.checkpoint import restore_checkpoint
    _, info, _ = synthetic_dataset
    two_dir = runs["two"][0]
    cfg = SMLConfig(latent_dim=8, transfer=TransferConfig(latent_dim=8))
    eng = SMLEngine(cfg, info.n_users, info.n_items)
    state, step, extra = restore_checkpoint(str(two_dir / "ck"),
                                            eng.init_state())
    final = np.load(two_dir / "final.npz")
    # the last checkpoint is the last period's: the saved final tables
    assert extra["period"] == step and step >= 3
    np.testing.assert_array_equal(np.asarray(state.mf.user_emb),
                                  final["user_emb"])
    # and a one-process port run loads it whole
    from sml_tpu_torch.utils.checkpoint import state_from_checkpoint
    port = state_from_checkpoint(str(two_dir / "ck"), device="cpu")
    np.testing.assert_array_equal(port.mf.item_emb.numpy(),
                                  final["item_emb"])
    assert port.mf_opt.mu["user_emb"].shape == final["user_emb"].shape


def test_two_processes_resume_from_a_shared_checkpoint(runs):
    """Both processes find the finished run's checkpoint: they agree,
    load it whole, shard it and report the run's summary."""
    two_dir, two = runs["two"]
    again = _run(["sml"] + runs["data"] + [
        "--checkpoint-dir", str(two_dir / "ck")], 2)
    assert [rc for rc, _, _ in again] == [0, 0], again[0][2][-2000:]
    assert "resumed at pass 0 period" in again[0][2]
    assert again[0][1] == two[0][1] and again[1][1] == ""


def test_resume_disagreement_raises_on_every_process(runs):
    ck = str(runs["two"][0] / "ck")       # holds a checkpoint
    empty = str(runs["tmp"] / "empty_ck")
    out = _run(lambda r: ["sml"] + runs["data"]
               + ["--checkpoint-dir", ck if r == 0 else empty], 2)
    for rc, _, err in out:
        assert rc != 0
        assert "checkpoint resume disagrees across processes" in err


def test_rank_shard_matches_one_process(runs):
    model = str(runs["one"][0] / "final.npz")
    args = ["rank", "--model", model, "--users", "0,5,17,299", "-k", "10",
            "--shard"]
    (rc1, one, e1), = _run(args)
    two = _run(args, 2)
    assert rc1 == 0, e1
    assert [rc for rc, _, _ in two] == [0, 0], two[0][2][-2000:]
    assert two[0][1] == one and len(one.splitlines()) == 4
    assert two[1][1] == ""


@pytest.mark.parametrize("fails", [False, True])
def test_cli_releases_graphs_before_the_world_ends(monkeypatch, tmp_path,
                                                   fails):
    import socket

    import torch
    import torch.distributed as dist

    from sml_tpu_torch import cli
    from sml_tpu_torch.parallel import collective
    from sml_tpu_torch.train import graphs
    calls = []

    def spy(name, fn):
        def call(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return call
    monkeypatch.setattr(graphs, "release_all",
                        spy("release", graphs.release_all))
    monkeypatch.setattr(dist, "barrier", spy("barrier", dist.barrier))
    monkeypatch.setattr(dist, "destroy_process_group",
                        spy("destroy", dist.destroy_process_group))

    def command(args):
        calls.append("command")
        if fails:
            raise RuntimeError("the command failed")
        return 0
    monkeypatch.setattr(cli, "cmd_synth", command)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    argv = ["--device", "cpu", "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", "1", "--process-id", "0", "synth", "--out",
            str(tmp_path)]
    saved, threads = dict(collective.WORLD), torch.get_num_threads()
    try:
        if fails:
            with pytest.raises(RuntimeError, match="the command failed"):
                cli.main(argv)
        else:
            assert cli.main(argv) == 0
    finally:
        collective.WORLD.clear()
        collective.WORLD.update(saved)
        torch.set_num_threads(threads)
    assert calls == (["command", "release", "destroy"] if fails else
                     ["command", "release", "barrier", "destroy"])
    assert not dist.is_initialized()
