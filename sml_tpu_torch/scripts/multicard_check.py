"""The parallel layer across R ranks, one per card where the host has R
cards (NCCL), or sharing cards or the CPU (gloo):

    python -m sml_tpu_torch.scripts.multicard_check --ranks 4
    python -m sml_tpu_torch.scripts.multicard_check --ranks 2 --device cpu

1. every collective of ``parallel.collective`` on the ranks' devices,
   against the values it must give, with the transport it used;
2. ``dryrun_multichip(R)``: one full step on an R-rank mesh against one
   rank, and sharded serving against dense serving;
3. ``python -m sml_tpu_torch sml`` as R processes against one process on a
   seeded synthetic dataset (the final tables and each test's hits), and
   ``rank --shard`` as R processes against ``rank`` as one (the printed
   rows): :func:`cli_against_one_process`.

Prints one JSON document (wall seconds per part, the transport, the
largest differences) and exits 1 when a part disagrees; every process it
starts has a timeout.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

TIMEOUT_S = 600
# the CLI's dataset and flags: tables and users that divide by 2 and 4
DATA = dict(n_users=2000, n_items=1000, n_periods=6,
            interactions_per_period=4000, first_test_period=2, neg_num=99,
            seed=1)
SML = ["--num-periods", "6", "--online-train-start", "2",
       "--online-test-start", "4", "--multi-num", "1", "--mf-sample",
       "alone", "--saddle-retries", "0", "--eval-scoring", "masked"]
RANK_USERS = "0,1,2,3,999,1998,1999"
RANK_K = 20
# R processes against one: the final tables within TABLE_ATOL; each test's
# hits within HIT_TOL (the refresh's products on a rank's row block may
# round the last bit differently, and a near tie then moves a hit); the
# served rows' scores within SCORE_ATOL (the CLI prints them rounded to
# 4 decimals)
TABLE_ATOL = 1e-4
HIT_TOL = 4
SCORE_ATOL = 1e-4


def _test_records(path: str) -> list:
    with open(path) as fh:
        return [r for r in map(json.loads, fh) if r["kind"] == "test"]


def cli_against_one_process(root: str, n: int, device: str,
                            data: dict = DATA,
                            timeout_s: float = TIMEOUT_S) -> tuple:
    """``sml`` on a synthetic dataset (``data``, written under ``root``)
    as ``n`` processes of one world against one process: every process
    exits 0, only process 0 prints, the final tables within ``TABLE_ATOL``
    and each test's hits within ``HIT_TOL``; then ``rank`` of the
    one-process tables, with ``--shard`` as ``n`` processes against one
    process: only process 0 prints, every row with the same item set and
    its scores within ``SCORE_ATOL``. The one-process and the
    ``n``-process run of each command start together. Returns
    ``(report, failed)``, ``failed`` the names of the parts that
    disagree."""
    import numpy as np

    from sml_tpu_torch.data.synthetic import (SyntheticSpec,
                                              generate_synthetic_dataset)
    from sml_tpu_torch.parallel.dryrun import run_cli_world
    generate_synthetic_dataset(os.path.join(root, "synth"),
                               SyntheticSpec(**data))
    argv = ["sml", "--data-root", root, "--data-name", "synth"] + SML

    def one_and_many(one_argv, many_argv):
        """The one-process and the ``n``-process run, started together."""
        with ThreadPoolExecutor(2) as pool:
            runs = [pool.submit(run_cli_world, a, procs, device, timeout_s)
                    for a, procs in ((one_argv, 1), (many_argv, n))]
            return [r.result() for r in runs]
    report, failed, out = {}, [], {}
    t0 = time.perf_counter()
    out["one"], out["many"] = one_and_many(*(argv + [
        "--metrics-jsonl", os.path.join(root, f"{tag}.jsonl"),
        "--save-model", os.path.join(root, f"{tag}.npz")]
        for tag in ("one", "many")))
    report["sml_s"] = time.perf_counter() - t0
    codes = [rc for rc, _, _ in out["one"] + out["many"]]
    sml = {"returncodes": codes,
           "mesh_line": [ln for ln in out["many"][0][2].splitlines()
                         if ln.startswith("multi-process")],
           "others_silent": all(so == "" for _, so, _ in out["many"][1:])}
    if not any(codes):
        tables = {t: np.load(os.path.join(root, f"{t}.npz"))
                  for t in ("one", "many")}
        sml["table_max_abs_err"] = max(
            float(np.abs(tables["one"][f] - tables["many"][f]).max())
            for f in ("user_emb", "item_emb"))
        tests = [_test_records(os.path.join(root, f"{t}.jsonl"))
                 for t in ("one", "many")]
        sml["tests"] = [len(t) for t in tests]
        sml["hit_diff"] = max(
            (abs(a[f"recall@{k}"] - b[f"recall@{k}"]) * a["n_test"]
             for a, b in zip(*tests) for k in (5, 10, 20)), default=None)
    else:
        sml["stderr"] = [se[-3000:] for rc, _, se in
                         out["one"] + out["many"] if rc]
    if (any(codes) or not sml["others_silent"]
            or out["many"][0][1].strip() == ""
            or sml["table_max_abs_err"] > TABLE_ATOL
            or not sml["tests"][0] == sml["tests"][1] > 0
            or sml["hit_diff"] > HIT_TOL):
        failed.append("sml")
    report["sml"] = sml
    if any(codes):
        return report, failed
    rank = ["rank", "--model", os.path.join(root, "one.npz"), "--users",
            RANK_USERS, "-k", str(RANK_K)]
    t0 = time.perf_counter()
    one, many = one_and_many(rank, rank + ["--shard"])
    report["rank_shard_s"] = time.perf_counter() - t0
    codes = [rc for rc, _, _ in one + many]
    rows = [[json.loads(x) for x in r[0][1].splitlines()]
            for r in (one, many)]
    shard = {"returncodes": codes, "rows": [len(r) for r in rows],
             "others_silent": all(so == "" for _, so, _ in many[1:]),
             "same_text": one[0][1] == many[0][1]}
    if not any(codes) and len(rows[0]) == len(rows[1]):
        shard["same_item_sets"] = all(
            set(a["items"]) == set(b["items"]) for a, b in zip(*rows))
        shard["score_max_abs_err"] = max(
            abs(x - y) for a, b in zip(*rows)
            for x, y in zip(sorted(a["scores"]), sorted(b["scores"])))
    if (any(codes) or not shard["others_silent"]
            or shard["rows"] != [len(RANK_USERS.split(","))] * 2
            or not shard.get("same_item_sets")
            or shard["score_max_abs_err"] > SCORE_ATOL):
        failed.append("rank_shard")
    report["rank_shard"] = shard
    return report, failed


def main(argv=None) -> int:
    p = argparse.ArgumentParser("multicard_check")
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from sml_tpu_torch.device import resolve_device
    from sml_tpu_torch.parallel.dryrun import dryrun_multichip, run_world
    resolve_device(args.device)
    n, report, failed = args.ranks, {"ranks": args.ranks}, []
    t0 = time.perf_counter()
    ranks = run_world("sml_tpu_torch.parallel.dryrun:check_transport", n,
                      args.device, (), TIMEOUT_S)
    report["collectives"] = {
        "transport": ranks[0]["transport"],
        "devices": [r["device"] for r in ranks],
        "max_error": max(max(r["errors"].values()) for r in ranks),
        "wall_s": time.perf_counter() - t0}
    if report["collectives"]["max_error"] or not all(r["on_device"]
                                                     for r in ranks):
        failed.append("collectives")
    t0 = time.perf_counter()
    try:
        # its progress lines go to stderr: stdout carries the document
        with contextlib.redirect_stdout(sys.stderr):
            dry = dryrun_multichip(n, device=args.device,
                                   timeout_s=TIMEOUT_S)
        report["dryrun"] = {
            "mesh": dry["mesh"], "serving_score_err": dry["serving"],
            "max_delta": {m: dry[m]["max_delta"]
                          for m in ("alone", "replay", "all")},
            "launches_per_rank": dry["alone"]["launches"]}
    except AssertionError as exc:
        report["dryrun"] = {"error": str(exc)}
        failed.append("dryrun")
    report["dryrun"]["wall_s"] = time.perf_counter() - t0
    root = tempfile.mkdtemp(prefix="sml_multicard_")
    try:
        report["cli"], cli_failed = cli_against_one_process(root, n,
                                                            args.device)
        failed += cli_failed
    finally:
        shutil.rmtree(root, ignore_errors=True)
    report["failed"] = failed
    print(json.dumps(report, indent=2))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
