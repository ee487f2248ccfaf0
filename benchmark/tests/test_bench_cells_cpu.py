"""Both windows and the reference at a tiny CPU shape through the
harness's own run (``run.main``): the last line's keys, the reference
following the program, the per-layer readers, and the control readings'
tool."""

import json

import pytest

from bench_tiny import args, run_cell

CELLS = [("yelp5m1m.sweep", "sweep"), ("c5.serve", "serve")]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload,kind", CELLS)
def test_untraced_line(capsys, workload, kind):
    out = run_cell(capsys, workload, kind, seed=2 ** 31 + 12345)
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


@pytest.mark.parametrize("workload,kind", CELLS)
def test_traced_line(capsys, workload, kind):
    out = run_cell(capsys, workload, kind, seed=77, trace=1)
    assert out["correct"] is True
    assert "setup_s" not in out["metrics"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("config", ["sweep_config", "sweep_config_epochs2",
                                    "sweep_config_fused_epochs2"])
def test_sweep_reference_follows_the_program(capsys, config):
    """The period from the seed and the window's first period from the
    program's state, at one epoch a phase and at two (the reference keeps
    each phase's last epoch, as the fused program does), eager and
    fused."""
    from bench_tiny import DATA
    import run
    assert run.main(["--workload", "yelp5m1m.sweep", "--seed", "5",
                     "--seconds", "0.5", "--trace", "0", "--device", "cpu",
                     "--config-file", str(DATA / f"{config}.json"),
                     "--traffic-file", str(DATA / "sweep_traffic.json")]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    n = {k: v["value"] for k, v in out["checks"].items()}
    # on the CPU both run f32 plain operations on the same draws
    assert out["correct"] is True
    assert n["loss"] < 1e-6 and n["window_loss"] < 1e-6
    assert n["epoch_loss"] < 1e-4 and n["moment"] < 1e-3
    assert n["change"] < 1e-3
    assert n["hits"] == 0.0 and n["refresh"] < 1e-6


def test_the_reference_is_the_same_every_run(capsys):
    """The reference held to itself (from the seed, and resumed from its
    own state at the window's first period) reads 0 on every number."""
    from tools import readings
    assert readings.main(["--workload", "yelp5m1m.sweep", "--seeds", "9",
                          "--variants", "f32/sound"] + args("sweep")) == 0
    nums = json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "numbers"]
    assert set(nums) == {"loss", "window_loss", "epoch_loss", "moment",
                         "change", "hits", "refresh"}
    assert all(v == 0.0 for v in nums.values()), nums


def test_serve_sizes_are_the_same_multiset_for_every_seed():
    import generate
    tr = json.loads((__import__("bench_tiny").DATA
                     / "serve_traffic.json").read_text())
    a, _ = generate.serve_requests(tr, 1000, 1, "cpu")
    b, _ = generate.serve_requests(tr, 1000, 2 ** 40 + 3, "cpu")
    assert sorted(a) == sorted(b) and list(a) != list(b)


def test_sweep_dataset_negatives(tmp_path):
    import numpy as np
    import generate
    tr = json.loads((__import__("bench_tiny").DATA
                     / "sweep_traffic.json").read_text())
    spec = generate.sweep_dataset(tr, 3000, 700, 11, str(tmp_path), "cpu")
    path = tmp_path / spec["name"]
    hist = set()
    for p in range(tr["distinct_periods"]):
        hist |= {tuple(r) for r in np.load(path / "train" / f"{p}.npy")}
    test = np.load(path / "test" / "1.npy")
    assert test.shape == (tr["interactions"], 2 + tr["neg_num"])
    for row in test[:200]:
        negs = row[2:]
        assert len(set(negs)) == len(negs)
        assert not any((row[0], n) in hist for n in negs)
    assert (np.load(path / "test" / f"{tr['distinct_periods']}.npy")
            == np.load(path / "test" / "0.npy")).all()


@pytest.mark.parametrize("workload,kind", CELLS)
def test_readings_tool_faults_exceed_the_limits(capsys, workload, kind):
    """The planted faults, in the reference put in the program's place,
    read above the cell's limits at the tiny shape."""
    import harness
    from tools import readings
    faults = {"sweep": "f32/unchanged,f32/half,f32/altered",
              "serve": "f32/altered,f32/half"}[kind]
    assert readings.main(["--workload", workload, "--seeds", "3",
                          "--variants", faults] + args(kind)) == 0
    limits = harness.cell(workload)["limits"]
    for line in capsys.readouterr().out.strip().splitlines():
        nums = json.loads(line)["numbers"]
        assert any(nums[k] > lim for k, lim in limits.items()), line


@pytest.mark.cuda
def test_control_fails_on_the_card(cuda_card, capsys):
    """The control (the reference served in TF32) fails the serving
    limits; on the card only (TF32 does not exist on the CPU)."""
    import harness
    from tools import readings
    assert readings.main(["--workload", "c5.serve", "--seeds", "4",
                          "--variants", "tf32/sound",
                          "--config-file",
                          str(__import__("bench_tiny").DATA
                              / "serve_config.json"),
                          "--traffic-file",
                          str(__import__("bench_tiny").DATA
                              / "serve_traffic.json")]) == 0
    limits = harness.cell("c5.serve")["limits"]
    nums = json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "numbers"]
    assert any(nums[k] > lim for k, lim in limits.items())
