"""Both full protocols' runs, one process each, through the port's own run
scripts, with their records checked:

    python -m sml_tpu_torch.scripts.protocol_runs --protocol adressa \\
        --root /tmp --out runs/adressa
    python -m sml_tpu_torch.scripts.protocol_runs --protocol yelp \\
        --root /tmp --out runs/yelp

``adressa`` (``adressa_run.py``): gen, pretrain, sml at seeds 2000-2005
with ``--fuse-period on``, seed 2000 again with ``--fuse-period off``
(the eager path: no captured program), then the three baselines. ``yelp``
(``yelp_scale_sweep.py``): gen, pretrain, ``ours --evals`` fused and
eager at seed 2000, ``ours`` without evals at seeds 2000 and 2001
(``"auto"``: fused on the card), then ``baseline --method fine``. The
seed-2000 fused and eager sweeps write their jsonl records (``--log``);
both must be equal record for record but for their wall times, as must
their ``results.json`` entries (:func:`compare_pair`).

The dataset goes to a new directory under ``--root``, deleted at the end.
On the card the kernels are built first (``build_s``), so no timed step
holds nvcc. Each step's stdout and stderr go to ``<out>/<step>.out`` /
``.err`` and the final ``results.json`` to ``<out>``. Prints one JSON
object: the card (``nvidia-smi``'s name and power limit), each step's exit
code and wall, its stderr phase lines (seconds, peak device memory, graph
counts), the recorded summaries, and whether the fused and eager records
agree. Exits 1 when a step fails or they disagree.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

# wall-clock fields of the records, which differ between any two runs
CLOCK_KEYS = ("ts", "seconds", "total_seconds", "period_seconds",
              "fuse_period")


def steps(protocol: str, root: str, out: str) -> list:
    """``(name, argv)`` per step; the fused/unfused pair's names end in
    ``_fused`` / ``_unfused``."""
    if protocol == "adressa":
        mod = "sml_tpu_torch.scripts.adressa_run"

        def sml(seed, fuse, name, log=False):
            argv = ["--phase", "sml", "--seed", str(seed), "--fuse-period",
                    fuse, "--key", name]
            return name, argv + (["--log", os.path.join(out, name + ".jsonl")]
                                 if log else [])
        runs = [("gen", ["--phase", "gen"]),
                ("pretrain", ["--phase", "pretrain"]),
                sml(2000, "on", "sml_seed2000_fused", log=True),
                sml(2000, "off", "sml_seed2000_unfused", log=True),
                *(sml(seed, "on", f"sml_seed{seed}")
                  for seed in range(2001, 2006)),
                ("baselines", ["--phase", "baselines"])]
    else:
        mod = "sml_tpu_torch.scripts.yelp_scale_sweep"

        def ours(seed, name, extra):
            return name, ["--phase", "ours", "--seed", str(seed), "--key",
                          name] + extra
        runs = [("gen", ["--phase", "gen"]),
                ("pretrain", ["--phase", "pretrain"]),
                ours(2000, "ours_evals_seed2000_fused",
                     ["--evals", "--fuse-period", "on", "--log",
                      os.path.join(out, "ours_evals_seed2000_fused.jsonl")]),
                ours(2000, "ours_evals_seed2000_unfused",
                     ["--evals", "--fuse-period", "off", "--log",
                      os.path.join(out, "ours_evals_seed2000_unfused.jsonl")]),
                ours(2000, "ours_seed2000", []),
                ours(2001, "ours_seed2001", []),
                ("baseline_fine", ["--phase", "baseline", "--method",
                                   "fine"])]
    return [(name, [sys.executable, "-m", mod, "--root", root] + argv)
            for name, argv in runs]


def strip_clock(obj):
    if isinstance(obj, dict):
        return {k: strip_clock(v) for k, v in obj.items()
                if k not in CLOCK_KEYS}
    if isinstance(obj, list):
        return [strip_clock(v) for v in obj]
    return obj


def compare_pair(out: str, results: dict, fused: str, unfused: str) -> dict:
    """The fused and unfused runs' jsonl records (``<out>/<name>.jsonl``)
    and ``results`` entries, wall times left out: equal counts, the first
    difference if any."""
    def records(name):
        with open(os.path.join(out, name + ".jsonl")) as fh:
            return [strip_clock(json.loads(ln)) for ln in fh]
    a, b = records(fused), records(unfused)
    first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    same_results = (strip_clock(results.get(fused))
                    == strip_clock(results.get(unfused)))
    return {"records": [len(a), len(b)],
            "records_equal": len(a) == len(b) and first is None,
            "first_difference": (None if first is None
                                 else {"fused": a[first],
                                       "unfused": b[first]}),
            "results_equal": same_results}


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("protocol_runs")
    ap.add_argument("--protocol", required=True, choices=["adressa", "yelp"])
    ap.add_argument("--root", required=True,
                    help="where to make the dataset's directory")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    out = os.path.abspath(args.out)
    os.makedirs(args.root, exist_ok=True)
    os.makedirs(out, exist_ok=True)
    root = tempfile.mkdtemp(prefix=f"{args.protocol}_", dir=args.root)
    report = {"protocol": args.protocol, "card": card(), "steps": {}}
    try:
        ok = run_steps(args, root, out, report)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    report["ok"] = ok
    print(json.dumps(report), flush=True)
    return 0 if ok else 1


def run_steps(args, root: str, out: str, report: dict) -> bool:
    """Every step of ``args.protocol`` in turn, into ``report``; whether all
    exited 0 and the fused and eager records agree."""
    if args.device == "cuda":
        # the kernels' nvcc build, once, before any timed step
        from sml_tpu_torch import _build
        t0 = time.time()
        _build.load_library()
        report["build_s"] = time.time() - t0
    for name, cmd in steps(args.protocol, root, out):
        cmd += ["--device", args.device]
        t0 = time.time()
        with open(os.path.join(out, name + ".out"), "w") as so, \
                open(os.path.join(out, name + ".err"), "w") as se:
            rc = subprocess.run(cmd, stdout=so, stderr=se).returncode
        with open(os.path.join(out, name + ".err")) as fh:
            lines = [json.loads(ln) for ln in fh
                     if ln.startswith('{"phase"')]
        report["steps"][name] = {"rc": rc, "wall_s": time.time() - t0,
                                 "phases": lines}
        print(json.dumps({name: report["steps"][name]}), file=sys.stderr,
              flush=True)
        if rc != 0:
            break
    path = os.path.join(root, "results.json")
    results = {}
    if os.path.exists(path):
        shutil.copy(path, out)
        with open(path) as fh:
            results = json.load(fh)
    report["summaries"] = {k: v.get("summary", v)
                           for k, v in results.items()}
    if rc != 0:
        return False
    pair = [n for n, _ in steps(args.protocol, root, out)
            if n.endswith("_fused") or n.endswith("_unfused")]
    report["fused_vs_unfused"] = compare_pair(out, results, *pair)
    return (report["fused_vs_unfused"]["records_equal"]
            and report["fused_vs_unfused"]["results_equal"])


if __name__ == "__main__":
    sys.exit(main())
