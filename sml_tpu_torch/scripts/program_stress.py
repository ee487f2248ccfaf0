"""The captured programs, run again and again in one process, to catch a
fault that shows only now and then (a native crash, or a result that
drifts from one round to the next).

    python -m sml_tpu_torch.scripts.program_stress [--rounds 50]
        [--trace-every K] [--device cuda] [--out stress.jsonl]

Each round runs, in this order, with ``gc.collect()`` between the steps
(so that a finalizer runs at a varied point):

  sweep      the ragged sweep of ``tests/test_torch_cuda.py``'s
             ``test_one_capture_serves_a_ragged_sweep``, both of its
             parametrisations: five periods of different train and test
             row counts, fused by ``"auto"`` (on the card one capture
             replayed in every period, with skipped step slots; with the
             saddle retry in the second), then unfused; each driver
             ``close()``d;
  pretrain   ``pretrain_mf`` on the same data (its plain MF epoch through
             a ``PlainEpochProgram``: one capture, replays);
  spmf       the SPMF baseline (its epoch through an ``EpochProgram``).

Checked every round: each fused sweep against its unfused one (tables,
snapshots, Θ, moments, counts, the generator bit-equal; the per-period
records equal), and every result against round 0's (the seeds are fixed,
so any drift is a fault). ``--trace-every K`` runs round K, 2K, ...'s
fused sweeps inside a ``torch.profiler`` trace (``utils/profiling``), as
``sml --profile-dir`` traces a period. ``faulthandler`` prints every
thread's Python stack if the process dies of a signal. One JSON line per
round and a summary line; exit 1 on any disagreement. On the CPU
(``--device cpu``) the fused sweep is ``fuse_period=True`` (the programs
run eagerly there).
"""

from __future__ import annotations

import argparse
import faulthandler
import gc
import hashlib
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from sml_tpu_torch.config import (BaselineConfig, DataSpec, PretrainConfig,
                                  SMLConfig, TransferConfig)
from sml_tpu_torch.device import resolve_device

# the second parametrisation of the ragged sweep: evals inside the
# program, norms, and a saddle retry (period 0 stalls, then retries)
SADDLE = dict(eval_during_inner=True, eval_during_outer=True, log_norms=True,
              saddle_retries=1, saddle_mode="legacy", saddle_frac=0.0,
              saddle_check_phase=1)
SWEEPS = (("plain", {}), ("saddle", SADDLE))


def ragged_dataset(root: Path) -> DataSpec:
    """Five periods whose train and test row counts and item pools all
    differ, under ``root`` (the card tests' ragged sweeps run on it)."""
    from sml_tpu_torch.data.formats import DatasetInfo, write_dataset
    rng = np.random.default_rng(11)
    train_rows, test_rows = (700, 420, 910, 515, 650), (90, 61, 118, 75, 102)
    train, test = [], {}
    for p, (n, m) in enumerate(zip(train_rows, test_rows)):
        lo = 7 * p
        train.append(np.stack([rng.integers(0, 200, n),
                               rng.integers(lo, lo + 60 + 5 * p, n)], 1))
        negs = np.stack([rng.choice(120, 20, replace=False)
                         for _ in range(m)])
        test[p] = np.concatenate([rng.integers(0, 200, (m, 1)),
                                  rng.integers(lo, lo + 60, (m, 1)), negs],
                                 axis=1)
    write_dataset(str(root / "synth"), train, test,
                  DatasetInfo(sum(train_rows), 200, 120))
    return DataSpec(root=str(root), name="synth", num_periods=5,
                    online_train_start=1, online_test_start=3,
                    eval_neg_num=20)


def sweep_cfg(extra: dict, fused: bool, device: torch.device) -> SMLConfig:
    """The ragged sweep's configuration; ``fused``: ``"auto"`` on the card,
    ``fuse_period=True`` on the CPU (where "auto" runs unfused)."""
    fuse = (dict(fuse_phases=False, fuse_period=False) if not fused
            else {} if device.type == "cuda" else dict(fuse_period=True))
    return SMLConfig(multi_num=3, mf_epochs=2, tr_epochs=2,
                     mf_batch_size=64, tr_batch_size=32, eval_batch_size=64,
                     latent_dim=16, mf_sample="alone", fast_table_adam=True,
                     eval_scoring="masked", prefetch_periods=False,
                     transfer=TransferConfig(latent_dim=16, fc_hidden=64),
                     **extra, **fuse)


def run_sweep(spec: DataSpec, extra: dict, fused: bool,
              device: torch.device) -> dict:
    """One ragged sweep; its final state, graph counts and per-period
    records, the driver ``close()``d."""
    from sml_tpu_torch.train.driver import SMLDriver
    drv = SMLDriver(sweep_cfg(extra, fused, device), spec, device=device)
    try:
        report = drv.run()
        if device.type == "cuda":
            torch.cuda.synchronize()
        return {"state": drv.final_state,
                "stats": dict(drv.engine.graph_stats),
                "per_period": report.per_period,
                "retries": report.saddle_retries_used}
    finally:
        drv.close()


def state_tensors(state) -> dict:
    """Every tensor of an SML state by name (tables, snapshots, Θ, both
    optimizers' moments, the generator's state)."""
    from sml_tpu_torch.models.transfer import theta_leaves
    out = {f"mf{i}": t for i, t in enumerate(state.mf)}
    for f in ("last_user", "last_item", "hat_user", "hat_item"):
        out[f] = getattr(state, f)
    out.update({f"theta/{k}": v for k, v in theta_leaves(state.theta).items()})
    for opt in ("mf_opt", "tr_opt"):
        for part in ("mu", "nu"):
            for k, t in getattr(getattr(state, opt), part).items():
                out[f"{opt}/{part}/{k}"] = t
    out["gen"] = state.gen.get_state()
    return out


def sweep_differences(a: dict, b: dict) -> list:
    """What differs between two ragged sweeps' results: tensor names,
    optimizer counts, records, retries."""
    ta, tb = state_tensors(a["state"]), state_tensors(b["state"])
    bad = [k for k in ta if not torch.equal(ta[k], tb[k])]
    for opt in ("mf_opt", "tr_opt"):
        if getattr(a["state"], opt).count != getattr(b["state"], opt).count:
            bad.append(f"{opt}.count")
    if a["per_period"] != b["per_period"]:
        bad.append("per_period")
    if a["retries"] != b["retries"]:
        bad.append("saddle_retries_used")
    return bad


def digest(tensors) -> str:
    """A hash of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def run_pretrain(spec: DataSpec, device: torch.device) -> dict:
    from sml_tpu_torch.train.graphs import GraphSite
    from sml_tpu_torch.train.pretrain import pretrain_mf
    site = GraphSite(device)
    cfg = PretrainConfig(max_epochs=4, eval_every=2, latent_dim=16,
                         batch_size=64)
    mf, _ = pretrain_mf(cfg, spec, spec.online_test_start - 1,
                        device=device, site=site)
    return {"digest": digest(mf), "stats": dict(site.stats)}


def run_spmf(spec: DataSpec, device: torch.device) -> dict:
    from sml_tpu_torch.train.baselines import BaselineDriver
    cfg = BaselineConfig(method="spmf", epochs=2, batch_size=64,
                         latent_dim=16, pool_size=300,
                         start_period=spec.online_test_start)
    drv = BaselineDriver(cfg, spec, device=device)
    drv.run()
    return {"digest": digest([*drv.mf, drv.gen.get_state()]),
            "stats": dict(drv.graph_stats)}


def one_round(spec: DataSpec, device: torch.device, trace_dir=None) -> dict:
    """One round of the sequence; what it found, and a digest of each
    result to hold later rounds to."""
    from sml_tpu_torch.utils.profiling import maybe_trace
    out = {"mismatch": {}, "digest": {}, "captures": 0}
    for name, extra in SWEEPS:
        gc.collect()
        with maybe_trace(trace_dir and str(Path(trace_dir) / name), device):
            fused = run_sweep(spec, extra, True, device)
        gc.collect()
        unfused = run_sweep(spec, extra, False, device)
        bad = sweep_differences(fused, unfused)
        if bad:
            out["mismatch"][name] = bad
        out["captures"] += fused["stats"]["captures"]
        out["digest"][name] = digest(state_tensors(fused["state"]).values())
        del fused, unfused
    gc.collect()
    pre = run_pretrain(spec, device)
    out["digest"]["pretrain"] = pre["digest"]
    out["captures"] += pre["stats"]["captures"]
    gc.collect()
    spmf = run_spmf(spec, device)
    out["digest"]["spmf"] = spmf["digest"]
    out["captures"] += spmf["stats"]["captures"]
    gc.collect()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace-every", type=int, default=0,
                    help="trace the fused sweeps of every K-th round")
    ap.add_argument("--out", default=None, help="also write the JSON lines "
                    "to this file")
    args = ap.parse_args(argv)
    # the process's own stderr, whatever has replaced sys.stderr
    faulthandler.enable(file=sys.__stderr__, all_threads=True)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    sink = open(args.out, "w") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    first, failed, t_start = None, 0, time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="sml_stress_") as root:
        spec = ragged_dataset(Path(root))
        for r in range(args.rounds):
            t0 = time.perf_counter()
            traced = args.trace_every > 0 and r % args.trace_every == 0 \
                and r > 0
            res = one_round(spec, device,
                            Path(root) / f"trace{r}" if traced else None)
            first = first or res["digest"]
            drift = sorted(k for k, v in res["digest"].items()
                           if v != first[k])
            ok = not res["mismatch"] and not drift
            failed += not ok
            emit({"round": r, "ok": ok, "mismatch": res["mismatch"],
                  "drift_from_round_0": drift, "traced": traced,
                  "captures": res["captures"],
                  "seconds": time.perf_counter() - t0})
    emit({"rounds": args.rounds, "failed_rounds": failed,
          "device": (torch.cuda.get_device_name(0) if device.type == "cuda"
                     else "cpu"),
          "seconds": time.perf_counter() - t_start})
    if sink:
        sink.close()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
