"""``SMLDriver`` at production table sizes: the sweep a user runs, fused by
``fuse_period="auto"``, held bit for bit to the same sweep eager.

For one shape the parent process writes a synthetic dataset once
(``generate_synthetic_dataset``); then each rank runs the sweep twice from
the same seed, on state born row-sharded (``init_state_sharded`` on the
R ranks' global mesh, ``(H, R/H)`` over ``--hosts H`` simulated hosts,
``(1, R)`` on one, NCCL with one card a rank; ``init_state`` with one
rank):
eager (``fuse_phases=False``: no program at all), then fused (``"auto"``
on the card, where it captures the period program once per rank;
``fuse_period=True`` on the CPU, where "auto" stays unfused and the
program runs eagerly). No rank ever holds a whole table: each compares
its own digests, per leaf and row block an f64 sum and a ``blake2b`` of
the bytes, read back block by block, and its test hits and losses.

    one card, 5M users x 1M items, bf16 snapshots (A):
      python -m sml_tpu_torch.scripts.scale_sweep --users 5000000 \\
          --items 1000000 --snapshot-dtype bfloat16
    four cards, 50M x 5M f32 on a (1, 4) NCCL mesh (B):
      python -m sml_tpu_torch.scripts.scale_sweep --users 50000000 \\
          --items 5000000 --devices 4
    the same as two simulated hosts of two cards, a (2, 2) mesh with
    'data' across the hosts (BASELINE.json config 5's layout):
      python -m sml_tpu_torch.scripts.scale_sweep --users 50000000 \\
          --items 5000000 --devices 4 --hosts 2
    one card, 50M x 5M, bf16 snapshots, no saddle guard (D: its restart
    copy of the 52.4 GiB state would not fit the card):
      python -m sml_tpu_torch.scripts.scale_sweep --users 50000000 \\
          --items 5000000 --snapshot-dtype bfloat16 --saddle-retries 0
    the CPU, tiny (``--devices 2``: two gloo ranks):
      python -m sml_tpu_torch.scripts.scale_sweep --device cpu \\
          --users 400 --items 200 --inter 800 --neg 49 --latent 16

The configuration is ``multicard_check.sweep_config("yelp")`` (``yelp_sml()``
at d=64, C1=10, C2=5, H=512) with the table Adam's auto rule (K3 from
1,000,000 rows), ``eval_scoring="auto"`` (the gather path once the catalog
passes the mask cap) and the flags' depth. Prints one JSON line: per rank
and run the period walls (every engine call waited for on the card, a
synchronization before and after it, so they are not the driver's own
walls, where the host runs ahead of the card), init and data seconds, ``make_eval_set``'s
seconds, the peak device memory (reset between the runs), the graphs'
counts, the K1/K2/K3 launches (replays counted) against those derived from
the configuration, the data and the guard's retries (``sweep_launches``,
which ``chip_smoke.py`` also derives its sweeps' launches with), the bytes copied into the programs'
state slot per period (``SMLEngine.slot_copies``), the bytes the rank
handed to each mesh axis's collectives (counted at each call: the fused
run's at its capture and its eager calls, not per replay), the route
"auto" took and the tests' recall@20; and the checks. A run that runs out of device
memory reports the allocator's message and its peak instead, and fails
the check that both runs complete. Diagnostics go to stderr. Exit 1 when
a check fails.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import itertools
import json
import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# a sharded world lives as long as its slowest rank's two sweeps
WORLD_TIMEOUT_S = 3600.0
# rows of a leaf per digest block, and the host threads that hash blocks
DIGEST_ROWS = 1 << 20
DIGEST_THREADS = 8
# the fused run's peak device memory against the eager run's
PEAK_RATIO = 1.10
RUNS = ("eager", "fused")
KERNELS = ("decay_adam_kernel", "transfer_rows_kernel",
           "masked_rank_gather_kernel")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("scale_sweep")
    ap.add_argument("--users", type=int, default=5_000_000)
    ap.add_argument("--items", type=int, default=1_000_000)
    ap.add_argument("--periods", type=int, default=4)
    ap.add_argument("--inter", type=int, default=300_000,
                    help="interactions per period")
    ap.add_argument("--first-test", type=int, default=2,
                    help="the first period with test rows")
    ap.add_argument("--neg", type=int, default=999,
                    help="negatives per test row")
    ap.add_argument("--multi-num", type=int, default=3)
    ap.add_argument("--latent", type=int, default=64)
    ap.add_argument("--snapshot-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--saddle-retries", type=int, default=2)
    ap.add_argument("--devices", type=int, default=0,
                    help="row-shard the state over R ranks' global mesh, "
                         "one process per rank")
    ap.add_argument("--hosts", type=int, default=1,
                    help="spawn the --devices ranks as this many simulated "
                         "hosts (mesh (hosts, devices / hosts))")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=2000)
    return ap


def _log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def shape_of(args) -> tuple:
    """Users and items, rounded down to a multiple of the ranks."""
    r = max(args.devices, 1)
    return (args.users // r) * r, (args.items // r) * r


def sweep_config(args):
    """``multicard_check.sweep_config("yelp")`` at ``--latent`` with the
    table Adam's auto rule, ``eval_scoring="auto"`` and the flags'
    depth, seed, snapshots and guard."""
    from sml_tpu_torch.config import TransferConfig
    from sml_tpu_torch.scripts.multicard_check import \
        sweep_config as yelp_sweep
    return yelp_sweep("yelp").replace(
        latent_dim=args.latent,
        transfer=TransferConfig(latent_dim=args.latent, fc_hidden=512),
        fast_table_adam=None, eval_scoring="auto",
        multi_num=args.multi_num, saddle_retries=args.saddle_retries,
        snapshot_dtype=args.snapshot_dtype, seed=args.seed)


def write_data(args, root: str):
    """The sweep's dataset under ``root``; returns its ``DataSpec`` and the
    seconds it took."""
    from sml_tpu_torch.config import DataSpec
    from sml_tpu_torch.data.synthetic import (SyntheticSpec,
                                              generate_synthetic_dataset)
    users, items = shape_of(args)
    t0 = time.perf_counter()
    generate_synthetic_dataset(os.path.join(root, "sweep"), SyntheticSpec(
        n_users=users, n_items=items, n_periods=args.periods,
        interactions_per_period=args.inter,
        first_test_period=args.first_test, neg_num=args.neg,
        seed=args.seed))
    spec = DataSpec(root=root, name="sweep", num_periods=args.periods,
                    online_train_start=0, online_test_start=args.first_test,
                    eval_neg_num=args.neg)
    return spec, time.perf_counter() - t0


def state_digest(state, rows: int = DIGEST_ROWS) -> dict:
    """Per leaf (``program_stress.state_tensors``: tables, snapshots, Θ,
    moments and the generator's state) and block of ``rows`` rows of this
    rank's state: the block's f64 sum (on the device) and a ``blake2b``
    of its bytes (read back block by block, hashed on host threads); plus
    the step counts."""
    from sml_tpu_torch.scripts.program_stress import state_tensors
    out, jobs = {}, []

    def hexdigest(b: np.ndarray) -> str:
        return hashlib.blake2b(b, digest_size=16).hexdigest()
    with torch.no_grad(), ThreadPoolExecutor(DIGEST_THREADS) as pool:
        for name, t in state_tensors(state).items():
            flat = t.detach().contiguous().reshape(t.shape[0], -1)
            for lo in range(0, flat.shape[0], rows):
                blk = flat[lo:lo + rows]
                total = float(torch.sum(blk, dtype=torch.float64))
                host = blk.reshape(-1).view(torch.uint8).cpu().numpy()
                # a bounded number of blocks on the host at a time
                if len(jobs) >= 2 * DIGEST_THREADS:
                    jobs[-2 * DIGEST_THREADS][2].result()
                jobs.append((name, total, pool.submit(hexdigest, host)))
        for name, total, fut in jobs:
            out.setdefault(name, []).append((total, fut.result()))
    out["counts"] = [(state.mf_opt.count, state.tr_opt.count)]
    return out


def inner_steps(spec, cfg, feeder_rows) -> list:
    """The inner step slots of each trained period: ``feeder_rows(kind,
    period)`` gives a period file's row count."""
    kind = "test" if cfg.mf_sample == "all" else "train"
    return [-(-feeder_rows(kind, t) // cfg.mf_batch_size)
            for t in range(spec.online_train_start, spec.num_periods - 1)]


def sweep_launches(spec, cfg, feeder_rows, fast: bool,
                   eval_batches=None, stalled_phases: int = 0) -> dict:
    """K3, K1 and K2 launches an ``SMLDriver`` sweep over ``spec`` must
    make, from its configuration and data: ``multi_num`` phases a trained
    period, and ``stalled_phases`` more in the first (the phases of the
    saddle guard's stalled attempts: :func:`stalled_phase_counts`). One K3
    launch per fast inner step, for all four MF leaves (none on the
    dense-gradient path); a refresh after each phase's inner block and
    outer epoch and one at the period's end, two K1 launches a refresh
    (``conv_com`` alone reaches K1); ``eval_batches(rows)``, the batches
    of a padded eval set, gives one K2 launch a batch of each test
    (``None``: the gather path, no K2)."""
    k3 = k1 = k2 = 0
    for d_time, steps in enumerate(inner_steps(spec, cfg, feeder_rows)):
        t = spec.online_train_start + d_time
        phases = cfg.multi_num + (stalled_phases if d_time == 0 else 0)
        if fast:
            k3 += steps * cfg.mf_epochs * phases
        if cfg.transfer.kind == "conv_com":
            k1 += 2 * (phases * (1 + cfg.tr_epochs) + 1)
        if eval_batches is not None and t + 1 >= spec.online_test_start:
            # branch C tests test/(t+1)
            k2 += eval_batches(feeder_rows("test", t + 1))
    return {"decay_adam_kernel": k3, "transfer_rows_kernel": k1,
            "masked_rank_gather_kernel": k2}


def stalled_phase_counts(cfg, retries: int, fused: bool) -> list:
    """The phases that ``retries`` stalled attempts of the saddle guard
    can have run in all: the fused program runs each attempt whole
    (``multi_num``: its guard reads the stacked losses after); the eager
    phases stop where the rule fires, at its check phase or the last, so
    each attempt ran one of those two counts."""
    from sml_tpu_torch.train.driver import saddle_check_phase
    each = ({cfg.multi_num} if fused
            else {saddle_check_phase(cfg) + 1, cfg.multi_num})
    return sorted({sum(c) for c in
                   itertools.combinations_with_replacement(each, retries)})


def _kernel_counters() -> dict:
    from sml_tpu_torch.ops import adam_kernel, eval_kernel, transfer_kernel
    return {"decay_adam_kernel": adam_kernel.decay_adam_cuda,
            "transfer_rows_kernel": transfer_kernel.transfer_rows_cuda,
            "masked_rank_gather_kernel": eval_kernel.masked_rank_cuda}


def run_sweep(args, spec, device, mesh, run: str) -> dict:
    """One sweep (``run`` "eager" or "fused") on this rank: its figures,
    its losses per period and phase, its hits and its state's digest."""
    from sml_tpu_torch.data.formats import row_count
    from sml_tpu_torch.parallel import collective
    from sml_tpu_torch.scripts.program_stress import state_tensors
    from sml_tpu_torch.train.driver import SMLDriver, fusion_route
    from sml_tpu_torch.utils.logging import MetricsLogger
    dev = torch.device(device) if isinstance(device, str) else device
    fuse = (dict(fuse_phases=False, fuse_period=False) if run == "eager"
            else {} if dev.type == "cuda" else dict(fuse_period=True))
    cfg = sweep_config(args).replace(**fuse)
    drv = SMLDriver(cfg, spec, logger=MetricsLogger(None), device=dev)
    eng = drv.engine
    counters = _kernel_counters()
    # each phase's last inner and outer losses, in call order, and the
    # seconds of the engine's calls (the card waited for at each end)
    losses, seconds = [], {}
    mf_epochs, tr_epochs = cfg.mf_epochs, cfg.tr_epochs

    def timed(name, fn, record=None):
        def wrapped(*a, **k):
            _sync(dev)
            t = time.perf_counter()
            out = fn(*a, **k)
            _sync(dev)
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t
            if record is not None:
                record(a, out)
            return out
        return wrapped

    def epoch_losses(kind):
        return lambda a, out: losses.append((kind, out[1].detach().clone()))

    def stacked_losses(a, out):
        ils, ols = out[2]
        for p in range(a[3]):
            losses.extend([("inner", ils[p].clone()),
                           ("outer", ols[p].clone())])
    for name in ("snapshot_last", "snapshot_hat", "refresh", "prep_inner",
                 "prep_outer", "make_eval_set", "evaluate_deferred"):
        setattr(eng, name, timed(name, getattr(eng, name)))
    eng.inner_epoch = timed("inner_epoch", eng.inner_epoch,
                            epoch_losses("inner"))
    eng.outer_epoch = timed("outer_epoch", eng.outer_epoch,
                            epoch_losses("outer"))
    eng.period_step = timed("period_step", eng.period_step, stacked_losses)

    marks = []

    def on_period_end(state, pass_id, d_time, driver):
        marks.append((len(losses), dict(eng.slot_copies), dict(seconds),
                      driver.report.saddle_retries_used))
    if dev.type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    before = {k: c.launches for k, c in counters.items()}
    axes = {} if mesh is None else {a: mesh.group(a)
                                    for a in ("data", "model")}
    sent = {a: collective.traffic(g) for a, g in axes.items()}
    t0 = time.perf_counter()
    held = [eng.init_state() if mesh is None
            else eng.init_state_sharded(mesh)]
    _sync(dev)
    init_s = time.perf_counter() - t0
    state_bytes = sum(t.numel() * t.element_size()
                      for t in state_tensors(held[0]).values())
    t0 = time.perf_counter()
    # the driver consumes the state: no reference to it stays here
    oom = None
    try:
        report = drv.run(held.pop(), on_period_end=on_period_end)
    except torch.OutOfMemoryError as exc:
        oom = " ".join(str(exc).split())[:600]
    _sync(dev)
    wall_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    if oom is not None:
        # the shape does not fit the card on this route: where and how much
        info = {"out_of_memory": oom, "periods_done": len(marks),
                "peak_gib": None if peak is None else peak / 2 ** 30,
                "init_s": init_s,
                "wall_s": wall_s, "graphs": dict(eng.graph_stats)}
        drv.close()
        del drv, eng
        gc.collect()
        torch.cuda.empty_cache()
        return {"info": info, "oom": True}
    launches = {k: c.launches - before[k] for k, c in counters.items()}
    sent = {a: collective.traffic(g) - sent[a] for a, g in axes.items()}
    route = fusion_route(cfg, eng)
    refusal = eng.capture_refusal()
    graphs = dict(eng.graph_stats)

    # the losses of each period, grouped into phases (inner epochs, then
    # outer epochs); each period's phases from its last attempt
    periods, lo_at, prev, prev_s = [], 0, None, {}
    for hi, copies, secs, retries in marks:
        seq = losses[lo_at:hi]
        phases = []
        while seq:
            inner, seq = seq[:mf_epochs], seq[mf_epochs:]
            outer, seq = seq[:tr_epochs], seq[tr_epochs:]
            if ([k for k, _ in inner] != ["inner"] * mf_epochs
                    or [k for k, _ in outer] != ["outer"] * tr_epochs):
                raise RuntimeError("unexpected epoch order in a phase")
            phases.append((inner[-1][1], outer[-1][1]))
        base = prev or {g: 0 for g in copies}
        periods.append({"phases": phases,
                        "copies": {g: copies[g] - base[g] for g in copies},
                        "seconds": {k: v - prev_s.get(k, 0.0)
                                    for k, v in secs.items()},
                        "retries": retries})
        lo_at, prev, prev_s = hi, copies, secs

    def rows(kind, t):
        return row_count(spec.path, kind, t)

    def derived(stalled: int) -> dict:
        # the CPU's wrappers take their kernels' plain versions; the
        # masked path's K2 launches are not derived here
        if dev.type != "cuda":
            return dict.fromkeys(KERNELS, 0)
        want = sweep_launches(spec, eng.cfg, rows, eng.cfg.fast_table_adam,
                              stalled_phases=stalled)
        if eng._want_masks:
            want["masked_rank_gather_kernel"] = None
        return want
    # from the configuration, the data and the guard's reported retries
    want = [derived(n) for n in stalled_phase_counts(
        cfg, report.saddle_retries_used, run == "fused")]
    finite = all(bool(torch.isfinite(x).all())
                 for p in periods for ph in p["phases"] for x in ph)
    hits = {k: [round(r * n) for r, n in zip(v, report.test_counts)]
            for k, v in report.per_period.items()}
    t0 = time.perf_counter()
    digest = state_digest(drv.final_state)
    digest_s = time.perf_counter() - t0
    drv.close()
    del drv, eng
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {
        "info": {"period_s": report.period_seconds, "init_s": init_s,
                 "wall_s": wall_s,
                 "make_eval_set_s": seconds.get("make_eval_set", 0.0),
                 "call_s_per_period": [p["seconds"] for p in periods],
                 "peak_gib": None if peak is None else peak / 2 ** 30,
                 "state_gib": state_bytes / 2 ** 30,
                 "guard_copy_gib": (state_bytes / 2 ** 30
                                    if cfg.saddle_retries else 0.0),
                 "route": "fused" if route else "unfused",
                 "refusal": refusal, "graphs": graphs,
                 "launches": launches, "derived_launches": want,
                 "bytes_by_axis": sent,
                 "phases_per_period": [len(p["phases"]) for p in periods],
                 "inner_steps_per_period": inner_steps(spec, cfg, rows),
                 "slot_copies_per_period": [p["copies"] for p in periods],
                 "saddle_retries_used": report.saddle_retries_used,
                 "recall@20": report.per_period.get(20),
                 "losses_finite": finite, "digest_s": digest_s},
        "periods": periods, "hits": hits, "digest": digest,
        "peak": peak, "multi_num": cfg.multi_num}


def _same_losses(a: list, b: list, n: int) -> bool:
    """Each period's last ``n`` (``multi_num``) phases bit-equal: a stalled
    guard attempt, thrown away in both runs, runs its phases through the
    stalled one eagerly and all of them fused."""
    for pa, pb in zip(a, b):
        for (ia, oa), (ib, ob) in zip(pa["phases"][-n:], pb["phases"][-n:]):
            if not (torch.equal(ia, ib) and torch.equal(oa, ob)):
                return False
    return len(a) == len(b)


def checks(runs: dict, device: torch.device) -> dict:
    """This rank's checks of the fused run against the eager one (only
    that both completed, where one ran out of device memory)."""
    if any(runs[run].get("oom") for run in RUNS):
        return {"completed": False, "failed": ["completed"]}
    e, f = runs["eager"], runs["fused"]
    mismatch = [k for k in e["digest"]
                if e["digest"][k] != f["digest"].get(k)]
    out = {"digests_equal": not mismatch and e["digest"].keys()
           == f["digest"].keys(),
           "digest_mismatch": mismatch[:8],
           "digest_blocks": sum(len(v) for v in e["digest"].values()),
           "hits_equal": e["hits"] == f["hits"],
           "losses_equal": _same_losses(e["periods"], f["periods"],
                                        e["multi_num"]),
           "losses_finite": e["info"]["losses_finite"]
           and f["info"]["losses_finite"]}
    for run in RUNS:
        info = runs[run]["info"]
        out[f"{run}_launches_as_derived"] = any(
            all(want is None or info["launches"][k] == want
                for k, want in cand.items())
            for cand in info["derived_launches"])
    g = f["info"]["graphs"]
    if device.type == "cuda":
        out["fused_route"] = f["info"]["route"] == "fused"
        out["one_capture_per_program"] = (g["programs"] >= 1
                                          and g["captures"] == g["programs"])
        out["peak_ratio"] = f["peak"] / e["peak"]
        out["peak_within"] = out["peak_ratio"] <= PEAK_RATIO
    else:
        out["fused_route"] = g["programs"] >= 1 and g["captures"] == 0
    # no copy of Θ or the moments into the slot, but a saddle retry's
    # re-rolled Θ and its moments
    out["no_theta_moment_copies"] = all(
        p["copies"]["theta"] == p["copies"]["moments"] == 0
        for t, p in enumerate(f["periods"]) if t or not p["retries"])
    out["failed"] = [k for k, v in out.items()
                     if v is False]
    return out


def rank_main(device, argd: dict, spec):
    """One rank: the eager sweep, then the fused one, then the checks;
    returns the rank's report (digests summarized)."""
    args = argparse.Namespace(**argd)
    mesh = None
    if args.devices and args.devices > 1:
        from sml_tpu_torch.parallel.multihost import (make_global_mesh,
                                                      process_index)
        mesh = make_global_mesh()
    dev = torch.device(device) if isinstance(device, str) else device
    tag = "" if mesh is None else f"[rank {process_index()}] "
    runs = {}
    for run in RUNS:
        runs[run] = run_sweep(args, spec, dev, mesh, run)
        info = runs[run]["info"]
        _log(f"{tag}{run}: periods {info.get('period_s')} s, init "
             f"{info['init_s']:.1f} s, peak {info['peak_gib']} GiB, graphs "
             f"{info['graphs']}, out of memory: {info.get('out_of_memory')}")
    out = {"device": str(dev), "checks": checks(runs, dev),
           "mesh": (None if mesh is None
                    else [mesh.shape["data"], mesh.shape["model"]])}
    for run in RUNS:
        out[run] = dict(runs[run]["info"])
        if "digest" in runs[run]:
            out[run]["digest"] = hashlib.blake2b(
                json.dumps(runs[run]["digest"], sort_keys=True).encode(),
                digest_size=16).hexdigest()
    return out


def run(args) -> dict:
    """The dataset written once, then every rank's two sweeps; the JSON
    line's document."""
    from sml_tpu_torch.device import resolve_device
    resolve_device(args.device)
    root = tempfile.mkdtemp(prefix="sml_scale_sweep_")
    try:
        spec, data_s = write_data(args, root)
        _log(f"dataset written in {data_s:.1f} s")
        if args.devices and args.devices > 1:
            from sml_tpu_torch.parallel.dryrun import run_world
            ranks = run_world("sml_tpu_torch.scripts.scale_sweep:rank_main",
                              args.devices, args.device, (vars(args), spec),
                              WORLD_TIMEOUT_S, hosts=args.hosts)
        else:
            ranks = [rank_main(args.device, vars(args), spec)]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    users, items = shape_of(args)
    failed = sorted({f"rank{r}:{k}" for r, rk in enumerate(ranks)
                     for k in rk["checks"]["failed"]})
    return {"users": users, "items": items, "latent": args.latent,
            "snapshot_dtype": args.snapshot_dtype,
            "devices": max(args.devices, 1), "hosts": args.hosts,
            "periods": args.periods,
            "inter": args.inter, "first_test": args.first_test,
            "multi_num": args.multi_num,
            "saddle_retries": args.saddle_retries, "data_s": data_s,
            "ranks": ranks, "failed": failed}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    doc = run(args)
    print(json.dumps(doc), flush=True)
    return 1 if doc["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
