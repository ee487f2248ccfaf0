"""BENCHMARK.json against the benchmark's contract: its keys, every name
and unit, the files each entry names, and the chip time a full check of
24 cells at its run length would take."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
E2E = {"setup_s", "sweep_examples_per_s", "serve_users_per_s",
       "serve_p95_ms"}


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]


def test_command_and_paths():
    assert 1 <= len(MAN["command"]) <= 32
    for w in MAN["command"]:
        assert TEXT.match(w) and not w.startswith("/") and ".." not in w
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert (ROOT / MAN["command"][1]).is_file()


def test_run_seconds_fit_the_check_with_24_cells():
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda e: e["name"])
def test_config_entries(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"])
    assert TEXT.match(entry["source"]) and TEXT.match(entry["why"])
    assert entry["file"].startswith("benchmark/")
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert len(entry["reduced"]) <= 16
    for key in entry["reduced"]:
        assert NAME.match(key) and key in cfg
        assert not key.endswith(("_dim", "_rank", "_size", "_hidden"))
    assert cfg["source"] == entry["source"]
    files = [c["file"] for c in MAN["configs"]]
    assert files.count(entry["file"]) == 1
    assert any(w["config"] == entry["name"] for w in MAN["workloads"])


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda e: e["name"])
def test_workload_entries(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert TEXT.match(cell["why"])
    assert cell["chips"] in (1, 4)
    assert cell["config"] in {c["name"] for c in MAN["configs"]}
    traffic = BENCH / "traffic" / f"{cell['traffic']}.json"
    kind = json.loads(traffic.read_text())["kind"]
    assert (BENCH / "drivers" / f"{kind}.py").is_file()
    limits = json.loads((BENCH / "limits" / f"{cell['name']}.json")
                        .read_text())
    assert limits and all(v > 0 for v in limits.values())
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert pairs.count((cell["config"], cell["traffic"])) == 1
    e2e = [m["name"] for m in MAN["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell["name"] in m.get("workloads", [cell["name"]])
               for m in MAN["per_layer"])


def test_four_chip_cells_within_a_quarter():
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)


@pytest.mark.parametrize("m", MAN["end_to_end"], ids=lambda e: e["name"])
def test_end_to_end_entries(m):
    assert set(m) <= {"name", "unit", "better", "bound", "source",
                      "workloads"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    assert m["name"] in E2E


def test_end_to_end_are_exactly_the_four():
    assert {m["name"] for m in MAN["end_to_end"]} == E2E


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda e: e["name"])
def test_per_layer_entries(m):
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("device_trace", "program_span",
                           "program_counter", "host_clock")
    assert TEXT.match(m["layer"])
    assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    moves = [e for e in MAN["end_to_end"] if e["name"] == m["moves"]]
    assert moves
    cells = {w["name"] for w in MAN["workloads"]}
    for w in m["workloads"]:
        assert w in cells
        assert w in moves[0].get("workloads", [w])
    if m["unit"] == "%" and (m["name"].endswith("_roofline")
                             or "mfu" in m["name"]):
        assert m["better"] == "higher"


def test_names_are_unique():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in MAN[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(metrics) == len(set(metrics))
