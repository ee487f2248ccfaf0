"""Production-scale run of the port's ``SMLEngine`` (counterpart of
``scripts/scale_engine_run.py``).

Runs full SML phases (snapshot -> inner epoch -> snapshot -> full-table
refresh -> outer epoch -> refresh) and then a leave-one-out test through
``SMLEngine`` at production table sizes, on synthetic in-memory period
data, and prints one JSON line with the JAX script's keys: examples/s,
per-op wall times and the refresh's rows/s. Flags, defaults and the numpy
draws (``default_rng(0)``: ``set_t``, ``set_tt``, then the test rows) are
the JAX script's, so both scripts make the same data. Two shapes:

  one card, bf16 snapshots (5M users / 1M items, d=64):
    python -m sml_tpu_torch.scripts.scale_engine_run --users 5000000 \\
        --items 1000000 --snapshot-dtype bfloat16
  50M/5M row-sharded over four cards (one process per card, a (1, 4)
  mesh over NCCL):
    python -m sml_tpu_torch.scripts.scale_engine_run --users 50000000 \\
        --items 5000000 --devices 4
  the same over two simulated hosts of two cards (BASELINE.json config
  5's layout: a (2, 2) mesh, 'data' across the hosts over NCCL):
    python -m sml_tpu_torch.scripts.scale_engine_run --users 50000000 \\
        --items 5000000 --devices 4 --hosts 2

On the CPU (``--device cpu``; without it a host with no GPU raises) at a
tiny shape:
    python -m sml_tpu_torch.scripts.scale_engine_run --device cpu \\
        --users 3000 --items 700 --inter 4000 --eval-rows 64 --neg 99

``--devices R`` (R > 1) spawns R processes (``parallel.dryrun.run_world``),
each on its own card (or the CPU, over gloo), as ``--hosts H`` simulated
hosts (default 1), whose state is born row-sharded
(``SMLEngine.init_state_sharded``) on their global mesh
(``make_global_mesh``: ``(H, R/H)``, the tables row-sharded over a host's
ranks and each block held once per host); users and items are rounded
down to a multiple of R, and rank 0's result is the line.
``--save-model PATH`` (the port's own flag) writes the final
tables as the ``.npz`` that ``python -m sml_tpu_torch rank`` serves.
Diagnostics go to stderr, among them, per rank, the peak device memory
(``torch.cuda.max_memory_allocated``) after init, after each phase and
after the evaluation, its place on the mesh and the bytes it handed to
each axis's collectives.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

# a sharded world lives as long as its slowest rank's init and phases
WORLD_TIMEOUT_S = 3600.0


class ScaleRun(NamedTuple):
    """What :func:`run_scale` returns: the engine, the final state, the
    JSON line's dict and the run's diagnostics (per-batch losses of every
    phase, step counts, seconds and peak device bytes)."""
    engine: object
    state: object
    result: dict
    info: dict


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("scale_engine_run")
    ap.add_argument("--users", type=int, default=5_000_000)
    ap.add_argument("--items", type=int, default=1_000_000)
    ap.add_argument("--inter", type=int, default=300_000,
                    help="interactions per period")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--phases", type=int, default=2)
    ap.add_argument("--eval-rows", type=int, default=4096)
    ap.add_argument("--neg", type=int, default=999)
    ap.add_argument("--snapshot-dtype", default="float32")
    ap.add_argument("--latent", type=int, default=64)
    ap.add_argument("--devices", type=int, default=0,
                    help="row-shard tables over N ranks' global mesh, one "
                         "process per rank")
    ap.add_argument("--hosts", type=int, default=1,
                    help="spawn the --devices ranks as this many simulated "
                         "hosts (mesh (hosts, devices / hosts))")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--key", default="scale_5m_chip")
    ap.add_argument("--out", default=None,
                    help="merge the result under --key into this JSON file")
    ap.add_argument("--save-model", default=None,
                    help="write the final tables to this .npz (rank's "
                         "--model format)")
    return ap


def _log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(dev: torch.device):
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None


def _gib(n) -> str:
    return "n/a (cpu)" if n is None else f"{n / 2**30:.2f} GiB"


def _save_tables(engine, state, path: str) -> None:
    """The final tables as ``rank``'s ``.npz`` (whole tables: under a mesh
    every rank gathers them and rank 0 writes)."""
    from sml_tpu_torch.models.mf import MFParams
    from sml_tpu_torch.parallel.multihost import process_index
    leaves = {}
    for f in MFParams._fields:
        t = getattr(state.mf, f)
        if engine.layout is not None:
            t = engine.layout.whole(t, "user" if f.startswith("user")
                                    else "item")
        if process_index() == 0:
            leaves[f] = t.detach().cpu().numpy()
    if leaves:
        np.savez(path, **leaves)


def run_scale(args, device="cuda", mesh=None) -> ScaleRun:
    """The JAX script's run through the port's engine on ``device``; under
    ``mesh`` (the global mesh of a running world) the state is born
    row-sharded."""
    from sml_tpu_torch.config import SMLConfig, TransferConfig
    from sml_tpu_torch.device import resolve_device
    from sml_tpu_torch.train.engine import SMLEngine

    dev = resolve_device(device)
    from sml_tpu_torch.parallel import collective
    from sml_tpu_torch.parallel.multihost import process_index
    tag = "" if mesh is None else f"[rank {process_index()}] "
    U, I = args.users, args.items
    if args.devices:
        U = (U // args.devices) * args.devices
        I = (I // args.devices) * args.devices
    _log(f"{tag}backend={dev.type} device={dev} users={U} items={I} "
         f"snap={args.snapshot_dtype} devices={args.devices or 1}")

    cfg = SMLConfig(mf_batch_size=args.batch, tr_batch_size=args.batch,
                    eval_batch_size=1024, latent_dim=args.latent, multi_num=1,
                    transfer=TransferConfig(latent_dim=args.latent),
                    mf_sample="alone", tr_sample_type="alone",
                    snapshot_dtype=args.snapshot_dtype)
    engine = SMLEngine(cfg, U, I, device=dev)
    _log(f"{tag}fast_table_adam={engine.cfg.fast_table_adam}")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    t0 = time.time()
    state = (engine.init_state() if mesh is None
             else engine.init_state_sharded(mesh))
    _sync(dev)
    init_s = time.time() - t0
    peaks = {"init": _peak(dev)}
    _log(f"{tag}state init {init_s:.1f}s user block "
         f"{tuple(state.mf.user_emb.shape)} peak {_gib(peaks['init'])}")

    rng = np.random.default_rng(0)

    def period(n):
        return np.unique(np.stack([rng.integers(0, U, n),
                                   rng.integers(0, I, n)], 1), axis=0)

    set_t, set_tt = period(args.inter), period(args.inter)
    test_rows = np.stack([rng.integers(0, U, args.eval_rows),
                          rng.integers(0, I, args.eval_rows)] +
                         [rng.integers(0, I, args.eval_rows)
                          for _ in range(args.neg)], axis=1)

    padded_t, idx_t = engine.prep_inner(set_t)
    padded_tt, idx_tt = engine.prep_outer(set_tt)

    times = {"inner": [], "outer": [], "refresh": [], "snapshot": []}
    losses = {"inner": [], "outer": []}
    t_all = time.time()
    for phase in range(args.phases):
        t = time.time()
        state = engine.snapshot_last(state)
        state, inner_l = engine.inner_epoch(state, padded_t, idx_t)
        _sync(dev)
        times["inner"].append(time.time() - t)

        t = time.time()
        state = engine.snapshot_hat(state)
        _sync(dev)
        times["snapshot"].append(time.time() - t)

        t = time.time()
        state = engine.refresh(state)
        _sync(dev)
        times["refresh"].append(time.time() - t)

        t = time.time()
        state, outer_l = engine.outer_epoch(state, padded_tt, idx_tt)
        state = engine.refresh(state)
        _sync(dev)
        times["outer"].append(time.time() - t)
        losses["inner"].append(inner_l.cpu().tolist())
        losses["outer"].append(outer_l.cpu().tolist())
        peaks[f"phase{phase}"] = _peak(dev)
        _log(f"{tag}phase {phase}: inner={times['inner'][-1]:.2f}s "
             f"refresh={times['refresh'][-1]:.2f}s "
             f"outer+refresh={times['outer'][-1]:.2f}s "
             f"loss={float(inner_l.mean()):.4f} "
             f"peak {_gib(peaks[f'phase{phase}'])}")

    t = time.time()
    metrics = engine.evaluate(state.mf, test_rows)
    eval_s = time.time() - t
    total = time.time() - t_all
    peaks["eval"] = _peak(dev)
    _log(f"{tag}eval {eval_s:.2f}s peak {_gib(peaks['eval'])}")

    # steady-state numbers come from the LAST phase (the first one pays
    # the kernels' first launches and the allocator's growth)
    inner_s = times["inner"][-1]
    res = {
        "backend": dev.type,
        "users": U, "items": I, "latent": args.latent,
        "snapshot_dtype": args.snapshot_dtype,
        "devices": args.devices or 1,
        "interactions_per_epoch": int(set_t.shape[0]),
        "inner_epoch_seconds": round(inner_s, 3),
        "train_examples_per_s": round(set_t.shape[0] / inner_s, 1),
        "refresh_seconds": round(times["refresh"][-1], 3),
        "refresh_rows_per_s": round((U + I) / times["refresh"][-1], 1),
        "outer_epoch_plus_refresh_seconds": round(times["outer"][-1], 3),
        "eval_seconds": round(eval_s, 3),
        "eval_rows": int(test_rows.shape[0]),
        # throughput probe on random synthetic tables, not an accuracy
        # claim (with an untrained Θ the refresh can pull the tables
        # together, so scores tie and the strictly-greater rank hits: 1.0)
        "recall@20_synthetic_probe": round(metrics[20]["recall"], 4),
        "phase_seconds_all": {k: [round(v, 2) for v in vs]
                              for k, vs in times.items()},
        "total_seconds": round(total, 1),
    }
    if args.save_model:
        t = time.time()
        _save_tables(engine, state, args.save_model)
        _log(f"{tag}tables gathered and saved to {args.save_model} in "
             f"{time.time() - t:.1f}s")
    info = {"fast_table_adam": engine.cfg.fast_table_adam,
            "inner_steps": -(-padded_t.n_real // args.batch),
            "outer_steps": -(-padded_tt.n_real // args.batch),
            "init_seconds": init_s, "peak_bytes": peaks,
            "losses": losses, "test_rows": test_rows,
            "device": str(dev),
            "mesh": (None if mesh is None
                     else [mesh.shape["data"], mesh.shape["model"]]),
            # bytes this rank handed to each axis's collectives (phases,
            # test and the gather of --save-model)
            "bytes": (None if mesh is None
                      else {a: collective.traffic(mesh.group(a))
                            for a in ("data", "model")})}
    return ScaleRun(engine, state, res, info)


def rank_main(device: str, argd: dict):
    """One rank of ``--devices R``: :func:`run_scale` on the world's global
    mesh; returns the result and the diagnostics (the test rows left
    out)."""
    from sml_tpu_torch.parallel.multihost import make_global_mesh
    args = argparse.Namespace(**argd)
    run = run_scale(args, device, make_global_mesh())
    info = {k: v for k, v in run.info.items() if k != "test_rows"}
    return run.result, info


def run(args):
    """``(result, info)`` of rank 0: in this process, or with ``--devices
    R`` (R > 1) from a world of R spawned ranks (``info["ranks"]`` then
    holds every rank's diagnostics)."""
    if args.devices and args.devices > 1:
        from sml_tpu_torch.parallel.dryrun import run_world
        ranks = run_world(
            "sml_tpu_torch.scripts.scale_engine_run:rank_main",
            args.devices, args.device, (vars(args),), WORLD_TIMEOUT_S,
            hosts=args.hosts)
        result, info = ranks[0]
        return result, {**info, "ranks": [r[1] for r in ranks]}
    out = run_scale(args, args.device)
    return out.result, out.info


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    result, info = run(args)
    for r, rank_info in enumerate(info.get("ranks", [info])):
        _log(f"rank {r} on {rank_info['device']} (mesh "
             f"{rank_info['mesh']}): init "
             f"{rank_info['init_seconds']:.1f}s, peak device memory "
             + ", ".join(f"{k} {_gib(v)}"
                         for k, v in rank_info["peak_bytes"].items())
             + f"; bytes to collectives by axis {rank_info['bytes']}")
    print(json.dumps(result), flush=True)
    if args.out:
        from sml_tpu_torch.utils.results import record
        record(args.out, args.key, result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
