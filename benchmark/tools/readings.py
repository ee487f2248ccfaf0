"""Readings the limits are set from: the check's numbers with the plain
reference put in the program's place, in the precision below the one the
configuration states (the control, ``tf32``) and with each planted fault,
on several seeds, at the cell's own sizes.

    python3 benchmark/tools/readings.py --workload <name> --seeds 1,2,3 \
        [--variants tf32/sound,f32/unchanged,f32/half,f32/altered]

prints one JSON line per seed and variant (``f32/sound``: the reference
held to itself, which reads 0 where it gives the same bits every run).
The program's own readings are the ``checks`` of the benchmark's runs.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))

import harness  # noqa: E402
from run import load_driver  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variants", default=None)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--config-file", default=None)
    p.add_argument("--traffic-file", default=None)
    args = p.parse_args(argv)
    harness.cache_dirs()
    c = harness.cell(args.workload)
    if args.config_file:
        c["config"] = harness.load_json(Path(args.config_file))
    if args.traffic_file:
        c["traffic"] = harness.load_json(Path(args.traffic_file))
    import torch
    dev = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    drv = load_driver(c["traffic"]["kind"])
    variants = [tuple(v.split("/")) for v in (
        args.variants.split(",") if args.variants else drv.VARIANTS)]
    variants = [(pr, None if f == "sound" else f) for pr, f in variants]
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = {"config": c["config"], "traffic": c["traffic"], "seed": seed,
               "device": dev}
        for name, nums in drv.control_numbers(ctx, variants).items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "variant": name, "numbers": nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
