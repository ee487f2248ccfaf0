"""The port's protocol scripts against the JAX package's.

``sml_tpu_torch/scripts/adressa_run.py`` and ``yelp_scale_sweep.py`` are
the counterparts of ``scripts/adressa_run.py`` and
``scripts/yelp_scale_sweep.py``. At a tiny width and a cut depth (the JAX
script's protocol constants set to the same cut):

* ``gen`` writes the JAX script's dataset byte for byte (the JAX script is
  loaded by ``importlib``; its ``gen`` uses numpy and the native sampler
  only);
* every other phase runs on ``--device cpu`` and records the keys of the
  JAX script's ``results.json`` (read from the JAX script's source);
* the sweep fused (``--fuse-period on``) and on the eager path (``off``)
  give the same records and final tables bit for bit.
"""

import ast
import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from sml_tpu_torch.models.transfer import theta_leaves
from sml_tpu_torch.scripts import adressa_run as A
from sml_tpu_torch.scripts import protocol_runs as R
from sml_tpu_torch.scripts import yelp_scale_sweep as Y
from sml_tpu_torch.scripts.protocol import Protocol

ROOT = Path(__file__).resolve().parent.parent
# the cut protocols: Adressa's 8 periods (training from 2, tests 5-7) and
# Yelp's 6 (training from 2, tests 4-5), at a tiny width
CUT = {"adressa": Protocol("news", 8, 2, 5, 49, 7, 2, 16),
       "yelp": Protocol("synth", 6, 2, 4, 49, 10, 1, 16)}
SCRIPTS = {"adressa": (A, "adressa_run.py"),
           "yelp": (Y, "yelp_scale_sweep.py")}
WIDTH = ["--users", "300", "--items", "200", "--inter", "600"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # many small tensors: one intra-op thread runs them faster than a
    # pool, and a pool slows to a crawl on a CPU shared with other workers
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_script(name: str, proto: Protocol):
    """The JAX script as a module, its protocol constants set to ``proto``
    (its phases read them at call time)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "scripts" / SCRIPTS[name][1])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.N_PERIODS, mod.TRAIN_START = proto.n_periods, proto.train_start
    mod.TEST_START, mod.NEG, mod.MULTI = (proto.test_start, proto.neg,
                                          proto.multi)
    return mod


def _literal_keys(name: str, fn: str) -> set:
    """The string keys of every dict literal in the JAX script's ``fn``
    but those looked up at once (its ``--fuse-period`` map)."""
    tree = ast.parse((ROOT / "scripts" / SCRIPTS[name][1]).read_text())
    node = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == fn)
    lookups = {id(n.value) for n in ast.walk(node)
               if isinstance(n, ast.Subscript)}
    return {k.value for d in ast.walk(node)
            if isinstance(d, ast.Dict) and id(d) not in lookups
            for k in d.keys if isinstance(k, ast.Constant)}


def _nested_keys(value) -> set:
    if not isinstance(value, dict):
        return set()
    return set(value) | {k for v in value.values() for k in _nested_keys(v)}


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*.npy"))}


@pytest.mark.parametrize("name", ["adressa", "yelp"])
def test_gen_writes_the_jax_scripts_bytes(tmp_path, name):
    proto = CUT[name]
    mod, _ = SCRIPTS[name]
    port = tmp_path / "port"
    assert mod.main(["--phase", "gen", "--root", str(port), "--device",
                     "cpu"] + WIDTH, proto) == 0
    jax_mod = _jax_script(name, proto)
    jax_root = tmp_path / "jax"
    os.makedirs(jax_root)
    jax_mod.phase_gen(mod.build_parser().parse_args(
        ["--phase", "gen", "--root", str(jax_root)] + WIDTH))
    want, got = _files(jax_root / proto.name), _files(port / proto.name)
    assert len(got) == len(want) > 2 * proto.n_periods - proto.train_start
    assert got == want
    results = [json.loads((r / "results.json").read_text())["dataset"]
               for r in (port, jax_root)]
    for r in results:
        r.pop("gen_seconds")
    assert results[0] == results[1]


def _same_state(a, b) -> bool:
    pairs = [(x, y) for x, y in zip(a.mf, b.mf)]
    pairs += [(getattr(a, f), getattr(b, f))
              for f in ("last_user", "last_item", "hat_user", "hat_item")]
    ta, tb = theta_leaves(a.theta), theta_leaves(b.theta)
    pairs += [(ta[k], tb[k]) for k in ta]
    return all(torch.equal(x, y) for x, y in pairs)


def _check_keys(name, fn, value, extra=()):
    want = _literal_keys(name, fn)
    assert want <= _nested_keys(value), (fn, want - _nested_keys(value))
    assert set(value) <= want | set(extra), (fn, set(value) - want)


def _fused_pair(tmp_path, run_phase, args, proto, key):
    """The sweep fused (one program) and on the eager path (none):
    records, results and final tables bit-equal (wall times left out)."""
    runs = {}
    for fuse in ("on", "off"):
        args.fuse_period, args.key = fuse, f"{key}_{fuse}"
        args.log = str(tmp_path / f"{key}_{fuse}.jsonl")
        runs[fuse] = run_phase(args, proto)
    args.key = args.log = None
    assert runs["on"].line["graph_stats"]["programs"] >= 1
    assert runs["off"].line["graph_stats"]["programs"] == 0
    results = json.loads((tmp_path / "results.json").read_text())
    pair = R.compare_pair(str(tmp_path), results, f"{key}_on", f"{key}_off")
    assert pair["records_equal"] and pair["results_equal"], pair
    records = [json.loads(ln) for ln in open(tmp_path / f"{key}_on.jsonl")]
    assert {r["kind"] for r in records} >= {"test", "phase", "summary"}
    assert _same_state(runs["on"].state, runs["off"].state)
    return results[f"{key}_on"], records


def test_adressa_phases_run_on_the_cpu_with_the_jax_keys(tmp_path):
    proto = CUT["adressa"]
    args = A.build_parser().parse_args(
        ["--phase", "gen", "--root", str(tmp_path), "--device", "cpu",
         "--pool", "1000"] + WIDTH)
    A.phase_gen(args, proto)
    pre = A.phase_pretrain(args, proto)
    _check_keys("adressa", "phase_pretrain", pre,
                extra=[k for k in pre if "@" in k or k == "best_epoch"])
    sml, records = _fused_pair(tmp_path, A.phase_sml, args, proto, "sml")
    _check_keys("adressa", "phase_sml", sml)
    assert sml["test_num"] == [600] * (proto.n_periods - proto.test_start)
    assert len(sml["period_seconds"]) == proto.n_periods \
        - proto.train_start - 1
    assert sum(r["kind"] == "phase" for r in records) == proto.multi * len(
        sml["period_seconds"])
    assert all(0.0 <= v <= 1.0 for v in sml["per_period_recall@20"])
    out = A.phase_baselines(args, proto, max_periods=1)
    results = json.loads((tmp_path / "results.json").read_text())
    assert set(results) == {"dataset", "pretrain", "sml_on", "sml_off",
                            "baselines"}
    base = results["baselines"]
    _check_keys("adressa", "phase_baselines", base,
                extra=("fine", "full", "spmf"))
    for method in ("fine", "full", "spmf"):
        assert len(base[method]["per_period_recall@20"]) == 1
        drv = out["drivers"][method]
        assert drv.cfg.pool_init_type == 1 and drv._early_stop
    assert 0.0 < base["full"]["summary"]["test_recall@20"] <= 1.0


def test_yelp_phases_run_on_the_cpu_with_the_jax_keys(tmp_path):
    proto = CUT["yelp"]
    args = Y.build_parser().parse_args(
        ["--phase", "gen", "--root", str(tmp_path), "--device", "cpu",
         "--evals", "--epochs", "2"] + WIDTH)
    Y.phase_gen(args, proto)
    Y.phase_pretrain(args, proto)
    ours, records = _fused_pair(tmp_path, Y.phase_ours, args, proto,
                                "ours")
    _check_keys("yelp", "phase_ours", ours)
    trained = proto.n_periods - proto.train_start - 1
    for kind in ("inner_eval", "outer_eval"):
        assert sum(r["kind"] == kind for r in records) == \
            proto.multi * trained
    cfg = Y.ours_config(args, proto)
    assert (cfg.mf_sample, cfg.tr_sample_type) == ("all", "alone")
    assert cfg.eval_during_inner and cfg.eval_during_outer
    driver = Y.phase_baseline(args, proto)
    assert driver.cfg.pool_init_type == 0 and not driver._early_stop
    results = json.loads((tmp_path / "results.json").read_text())
    base = results["ours_baseline_fine"]
    _check_keys("yelp", "phase_baseline", base)
    assert base["test_num"] == [600] * (proto.n_periods - proto.test_start)
    assert base["epochs"] == 2 and base["method"] == "fine"
