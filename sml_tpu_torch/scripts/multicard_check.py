"""The parallel layer across R ranks, one per card where the host has R
cards (NCCL), or sharing cards or the CPU (gloo):

    python -m sml_tpu_torch.scripts.multicard_check --ranks 4
    python -m sml_tpu_torch.scripts.multicard_check --ranks 4 --hosts 2
    python -m sml_tpu_torch.scripts.multicard_check --ranks 2 --device cpu

``--hosts H`` spawns the ranks of parts 1-3 as H simulated hosts
(``parallel.dryrun.run_world(hosts=H)``: each sees its own share of the
cards), so their global mesh (``make_global_mesh``) is ``(H, R/H)``, its
'data' axis across the hosts; part 4, the CLI, runs on this machine's one
host, as the CLI takes its host from the machine.

1. every collective of ``parallel.collective`` on the ranks' devices,
   against the values it must give, with the transport it used;
2. ``dryrun_multichip(R)``: one full step on an R-rank mesh against one
   rank, the fused parts (c) ``phase_step`` and (d) ``period_step`` with
   in-program evals against one rank, and sharded serving against dense
   serving;
3. the fused sweep (:func:`fused_sweep_part`): ``SMLDriver`` on a
   synthetic dataset, on cards at the Yelp widths and table sizes
   (100,000 x 20,000, d=64, C1=10, C2=5, H=512; on the CPU at a tiny
   size), on the R ranks' global mesh (``(1, R)`` on one host) unfused
   and fused
   (``fuse_period="auto"``, which on cards over NCCL captures each
   program once per rank, its step slots split at their collectives;
   ``True`` on the CPU, where a program runs eagerly on the mesh), then
   fused on rank 0 alone (one card: captured): the mesh's second sweep
   bit-equal to its first, and within the CLI part's limits of one rank;
   wall per period of each run on every rank, the route "auto" took and
   why, the graphs' counts (captures, their seconds, IF nodes per step
   slot) per rank and the transport;
4. ``python -m sml_tpu_torch sml`` as R processes against one process on a
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
# the fused sweep's dataset and depth: the Yelp widths and tables (both
# divide by 2 and 4), cut to four periods (two warm-up, two tests) of
# 40,000 interactions and three phases a period; "tiny" for the CPU
SWEEPS = {
    "yelp": dict(data=dict(n_users=100_000, n_items=20_000, n_periods=4,
                           interactions_per_period=40_000,
                           first_test_period=2, neg_num=999, seed=3),
                 cfg=dict(latent_dim=64, fc_hidden=512, multi_num=3)),
    "tiny": dict(data=dict(n_users=400, n_items=200, n_periods=4,
                           interactions_per_period=800, first_test_period=2,
                           neg_num=49, seed=3),
                 cfg=dict(latent_dim=16, fc_hidden=64, multi_num=3,
                          mf_batch_size=128, tr_batch_size=64,
                          eval_batch_size=64)),
}
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


def sweep_config(sweep: str):
    """The fused sweep's configuration: ``yelp_sml()`` with the row-sparse
    table Adam (K3), masked scoring and sampled negatives (the dataset has
    no presampled training rows), at the sweep's widths and depth."""
    from sml_tpu_torch.config import TransferConfig, yelp_sml
    kw = dict(SWEEPS[sweep]["cfg"])
    d, h = kw.pop("latent_dim"), kw.pop("fc_hidden")
    return yelp_sml().replace(
        latent_dim=d, transfer=TransferConfig(latent_dim=d, fc_hidden=h),
        fast_table_adam=True, eval_scoring="masked", mf_sample="alone",
        prefetch_periods=False, saddle_retries=0, **kw)


def sweep_rank(device: str, cfg, spec, fused) -> dict:
    """One rank of the fused sweep part: the sweep on the world's global
    mesh unfused, then with ``fuse_period=fused``, then (rank 0)
    fused on this rank alone. Per run: the wall of each period, the route
    taken, the graphs' counts and the launches per kernel; rank 0 also
    the whole final tables and the tests' recalls; and why the mesh's
    programs cannot be captured here (None where they can)."""
    import torch

    from sml_tpu_torch.parallel import collective
    from sml_tpu_torch.parallel.dryrun import _kernel_modules
    from sml_tpu_torch.parallel.multihost import (make_global_mesh,
                                                  process_index)
    from sml_tpu_torch.train.driver import SMLDriver, fusion_route
    from sml_tpu_torch.utils.logging import MetricsLogger
    mesh = make_global_mesh()
    counters = _kernel_modules()

    def sweep(mesh, fuse):
        drv = SMLDriver(cfg.replace(fuse_period=fuse,
                                    fuse_phases=fuse is not False),
                        spec, logger=MetricsLogger(None), device=device)
        try:
            eng = drv.engine
            state = (eng.init_state() if mesh is None
                     else eng.init_state_sharded(mesh))
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            report = drv.run(state)
            if eng.device.type == "cuda":
                torch.cuda.synchronize(eng.device)
            out = {"wall_s": time.perf_counter() - t0,
                   "period_s": report.period_seconds,
                   "fused": fusion_route(drv.cfg, eng),
                   "graphs": dict(eng.graph_stats),
                   "launches": {k: c.launches for k, c in counters.items()}}
            whole = eng.whole_state(drv.final_state)
        finally:
            # the programs' graphs go before the world's next collectives
            # and its teardown
            drv.close()
        if process_index() == 0:
            out["tables"] = {f: getattr(whole.mf, f).cpu().numpy()
                             for f in ("user_emb", "item_emb")}
            out["tests"] = {"counts": report.test_counts,
                            "recall": report.per_period}
        return out
    out = {"transport": {a: collective.transport(mesh.group(a))
                         for a in ("data", "model")},
           "refusal": collective.capture_refusal(
               [mesh.group(a) for a in ("data", "model")], device),
           "unfused": sweep(mesh, False), "fused": sweep(mesh, fused)}
    if process_index() == 0:
        out["one"] = sweep(None, fused)
    return out


def fused_sweep_dataset(root: str, sweep: str):
    """The fused sweep's synthetic dataset (``SWEEPS[sweep]``), written
    under ``root``; returns its ``DataSpec``."""
    from sml_tpu_torch.config import DataSpec
    from sml_tpu_torch.data.synthetic import (SyntheticSpec,
                                              generate_synthetic_dataset)
    data = SWEEPS[sweep]["data"]
    generate_synthetic_dataset(os.path.join(root, "sweep"),
                               SyntheticSpec(**data))
    return DataSpec(root=root, name="sweep", num_periods=data["n_periods"],
                    online_train_start=0,
                    online_test_start=data["first_test_period"],
                    eval_neg_num=data["neg_num"])


def fused_sweep_part(root: str, n: int, device: str,
                     timeout_s: float = TIMEOUT_S, hosts: int = 1) -> tuple:
    """Part 3 (module note): ``(report, failed)``; the Yelp sizes on
    cards, the tiny ones on the CPU; the ranks as ``hosts`` simulated
    hosts."""
    import numpy as np

    from sml_tpu_torch.parallel.dryrun import run_world
    sweep = "yelp" if device == "cuda" else "tiny"
    data = SWEEPS[sweep]["data"]
    t0 = time.perf_counter()
    spec = fused_sweep_dataset(root, sweep)
    data_s = time.perf_counter() - t0
    fused = "auto" if device == "cuda" else True
    t0 = time.perf_counter()
    ranks = run_world(f"{__name__}:sweep_rank", n, device,
                      (sweep_config(sweep), spec, fused), timeout_s, hosts)
    r0 = ranks[0]

    def tables_err(a, b):
        return max(float(np.abs(a["tables"][f] - b["tables"][f]).max())
                   for f in a["tables"])

    def hit_diff(a, b):
        t = a["tests"]
        return max((abs(x - y) * c for k in t["recall"]
                    for x, y, c in zip(t["recall"][k], b["tests"]["recall"][k],
                                       t["counts"])), default=0.0)
    rep = {"sweep": sweep, "users": data["n_users"], "items": data["n_items"],
           "data_s": data_s, "world_s": time.perf_counter() - t0,
           "transport": r0["transport"], "fused_route": r0["fused"]["fused"],
           "refusal": r0["refusal"],
           "graphs": [r["fused"]["graphs"] for r in ranks],
           "one_graphs": r0["one"]["graphs"],
           "period_s": {run: [r[run]["period_s"] for r in ranks]
                        for run in ("unfused", "fused")},
           "one_period_s": r0["one"]["period_s"],
           "launches": {run: [r[run]["launches"] for r in ranks]
                        for run in ("unfused", "fused")},
           "fused_vs_unfused_table_err": tables_err(r0["fused"],
                                                    r0["unfused"]),
           "fused_vs_unfused_hit_diff": hit_diff(r0["fused"], r0["unfused"]),
           "fused_vs_one_table_err": tables_err(r0["fused"], r0["one"]),
           "fused_vs_one_hit_diff": hit_diff(r0["fused"], r0["one"]),
           "tests": len(r0["fused"]["tests"]["counts"])}
    # the programs run on the mesh eagerly on the CPU; on cards every rank
    # of the mesh captures its programs once (the phase program and the
    # test periods' phase-0 epoch programs), and rank 0 alone once more
    captures = [g["captures"] for g in rep["graphs"] + [rep["one_graphs"]]]
    failed = []
    if (rep["fused_vs_unfused_table_err"] != 0.0
            or rep["fused_vs_unfused_hit_diff"] != 0.0
            or rep["fused_vs_one_table_err"] > TABLE_ATOL
            or rep["fused_vs_one_hit_diff"] > HIT_TOL or rep["tests"] < 1
            or rep["fused_route"] is not True
            or captures != [3 * int(device == "cuda")] * (n + 1)):
        failed.append("fused_sweep")
    return rep, failed


def main(argv=None) -> int:
    p = argparse.ArgumentParser("multicard_check")
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--hosts", type=int, default=1,
                   help="run parts 1-3 as this many simulated hosts")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from sml_tpu_torch.device import resolve_device
    from sml_tpu_torch.parallel.dryrun import dryrun_multichip, run_world
    resolve_device(args.device)
    n, report, failed = args.ranks, {"ranks": args.ranks,
                                     "hosts": args.hosts}, []
    t0 = time.perf_counter()
    ranks = run_world("sml_tpu_torch.parallel.dryrun:check_transport", n,
                      args.device, (), TIMEOUT_S, args.hosts)
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
                                   timeout_s=TIMEOUT_S, hosts=args.hosts)
        report["dryrun"] = {
            "mesh": dry["mesh"], "serving_score_err": dry["serving"],
            "max_delta": {m: dry[m]["max_delta"]
                          for m in ("alone", "replay", "all")},
            "fused": dry["fused"],
            "launches_per_rank": dry["alone"]["launches"]}
    except AssertionError as exc:
        report["dryrun"] = {"error": str(exc)}
        failed.append("dryrun")
    report["dryrun"]["wall_s"] = time.perf_counter() - t0
    root = tempfile.mkdtemp(prefix="sml_multicard_")
    try:
        report["fused_sweep"], sweep_failed = fused_sweep_part(
            root, n, args.device, hosts=args.hosts)
        failed += sweep_failed
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
