"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Loads the cell (``BENCHMARK.json``: its
configuration, traffic mix and limits), sets it up, measures for
``--seconds`` and prints, as the last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics read from
the profiler's trace and the program's counters), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with the plain reference beside its limit (also the last lines of
standard error). Exits non-zero with no result when there is no CUDA
card, too few cards for the cell, or when JAX or the JAX package is
loaded once the window has closed. ``--device cpu`` runs the same path on
the CPU at the sizes a test gives (``--config-file`` /
``--traffic-file``); it is for the tests only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))

import harness  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--config-file", default=None)
    p.add_argument("--traffic-file", default=None)
    return p.parse_args(argv)


def load_driver(kind: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"bench_driver_{kind}", BENCH / "drivers" / f"{kind}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    args = parse(argv)
    harness.cache_dirs()
    c = harness.cell(args.workload)
    if args.config_file:
        c["config"] = harness.load_json(Path(args.config_file))
    if args.traffic_file:
        c["traffic"] = harness.load_json(Path(args.traffic_file))
    import torch
    chips = int(c["workload"]["chips"])
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device: torch.cuda.is_available() is False",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < chips:
            print(f"the cell needs {chips} cards, "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            return 2
    dev = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    ctx = {"config": c["config"], "traffic": c["traffic"],
           "seed": args.seed, "seconds": args.seconds,
           "trace": bool(args.trace), "device": dev}
    out = load_driver(c["traffic"]["kind"]).run(ctx)

    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"the process holds {', '.join(loaded)}: the benchmark may "
              "not load JAX or the JAX package", file=sys.stderr)
        return 3
    correct, checks = harness.judge(out["numbers"], c["limits"])
    if args.trace:
        ctx_l = out["layer_ctx"]
        metrics = {}
        for m in c["per_layer"]:
            v = harness.read_metric(m["name"], ctx_l)
            if v is not None:
                metrics[m["name"]] = (v, m["unit"])
        breakdown = harness.breakdown(out["trace"])
    else:
        metrics = {"setup_s": (out["setup_s"], "s")}
        for m in c["end_to_end"]:
            if m["name"] in out["e2e"]:
                metrics[m["name"]] = out["e2e"][m["name"]]
        breakdown = None
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
              "count": chips if dev.type == "cuda" else 0,
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    if args.trace:
        device["busy_s"] = out["trace"]["busy_s"]
        device["window_s"] = out["trace"]["window_s"]
    print(json.dumps({"info": out.get("info", {}),
                      "setup_s": out["setup_s"],
                      "window_s": out["window_s"]}), file=sys.stderr)
    for name, (v, lim) in checks.items():
        print(f"check {name} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(correct, out["attempted"], out["failed"],
                              metrics, device, checks, breakdown))
    return 0


if __name__ == "__main__":
    sys.exit(main())
