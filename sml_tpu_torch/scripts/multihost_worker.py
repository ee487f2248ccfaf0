"""The multi-host layout on simulated hosts (counterpart of
``scripts/multihost_worker.py``, whose processes each hold
``--local-devices`` virtual devices):

    python -m sml_tpu_torch.scripts.multihost_worker --hosts 2 \\
        --ranks-per-host 2 --width yelp --out mh.npz
    python -m sml_tpu_torch.scripts.multihost_worker --hosts 2 \\
        --ranks-per-host 2 --device cpu --width tiny --out mh.npz

Spawns ``H x L`` ranks as H simulated hosts of L ranks
(``parallel.dryrun.run_world(hosts=H)``: on cards each host sees its own
share of the cards and NCCL tells the hosts apart, so 'data' crosses them
over NCCL's network transport; with fewer cards than hosts they share the
first over gloo). Every rank builds ``make_global_mesh()`` (``(H, L)``:
'model' inside a host, 'data' across hosts) and an engine placed on it
(``MultihostPlacement``), then runs the JAX worker's two SML phases
(``snapshot_last``, ``inner_epoch``, ``snapshot_hat``, ``refresh``,
``outer_epoch``, ``refresh``) on two periods drawn as
``tests/test_multihost.py`` draws them; rank 0 writes the JAX worker's
``.npz`` keys (``user_emb``, ``item_emb``, ``losses``: each phase's mean
inner and outer loss, ``theta_<i>``: Θ's leaves in the JAX tree's order).

Widths: ``tiny`` is ``tests/test_multihost.py``'s (320 x 160, d=16,
H=64, batches 128/64, 700 draws a period); ``yelp`` is
``multicard_check``'s Yelp sweep (100,000 x 20,000, d=64, C1=10, C2=5,
H=512, the row-sparse table Adam, 40,000 draws a period). Then each runs
``SMLDriver``'s sweep of that width (``multicard_check.SWEEPS``: four
periods, three phases a period; in ``yelp`` the Yelp widths, in ``tiny``
multicard_check's CPU size) on the same world unfused and with
``fuse_period="auto"`` (on cards over NCCL: each program captured once a
rank; over gloo, ranks sharing a card, unfused; on the CPU ``True``, the
programs run eagerly). Fused and unfused must agree bit
for bit in every rank's digests of every leaf's blocks
(``scale_sweep.state_digest``) and hits. Rank 0 then runs the phases (and
the fused sweep) alone, and the world is held to it: tables and Θ within
``TRAIN_ATOL``, the phases' per-batch losses within ``LOSS_RTOL``, the
tests' hits within ``HIT_TOL``. Each rank's K1, K2 and K3 launches must
equal those derived from the configuration and the data (none on the
CPU, where the wrappers take their plain versions).

Prints one JSON line (mesh, hosts, cards, the transport of each axis,
per rank the peak device memory of the mesh's runs, the seconds per phase
and per period, launches, bytes handed to
each axis's collectives in the eager runs, the graphs' counts, the
differences) and exits 1 when a check fails.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

WORLD_TIMEOUT_S = 1800.0
TRAIN_ATOL = 1e-4
LOSS_RTOL = 1e-5
HIT_TOL = 4
PHASE_SEED = 7
WIDTHS = {
    "tiny": dict(users=320, items=160, latent=16, hidden=64, draws=700),
    "yelp": dict(users=100_000, items=20_000, latent=64, hidden=512,
                 draws=40_000),
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("multihost_worker")
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--ranks-per-host", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--width", default="tiny", choices=sorted(WIDTHS))
    ap.add_argument("--out", required=True,
                    help="the .npz rank 0 writes (the JAX worker's keys)")
    return ap


def phase_config(width: str):
    """The phases' configuration: the JAX worker's (``tests/
    test_multihost.py`` ``mk_cfg``) in ``tiny``; ``multicard_check``'s
    Yelp sweep configuration, one phase a period, in ``yelp``."""
    from sml_tpu_torch.config import SMLConfig, TransferConfig
    from sml_tpu_torch.scripts.multicard_check import sweep_config
    if width == "yelp":
        return sweep_config("yelp").replace(multi_num=1)
    w = WIDTHS[width]
    return SMLConfig(mf_batch_size=128, tr_batch_size=64,
                     eval_batch_size=128, latent_dim=w["latent"],
                     multi_num=1,
                     transfer=TransferConfig(latent_dim=w["latent"],
                                             fc_hidden=w["hidden"]),
                     mf_sample="alone", tr_sample_type="alone")


def phase_periods(width: str, n_periods: int = 2) -> list:
    """``(set_t, set_tt)`` per period, drawn as ``tests/test_multihost.py``
    ``mk_periods`` draws them (``default_rng(7)``), at the width's
    table sizes and draws."""
    w = WIDTHS[width]
    rng = np.random.default_rng(PHASE_SEED)
    out = []
    for _ in range(n_periods):
        def draw():
            inter = np.stack([rng.integers(0, w["users"], w["draws"]),
                              rng.integers(0, w["items"], w["draws"])],
                             axis=1)
            return np.unique(inter, axis=0)
        out.append((draw(), draw()))
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _axis_bytes(mesh, before: dict) -> dict:
    from sml_tpu_torch.parallel import collective
    return {a: collective.traffic(mesh.group(a)) - before[a]
            for a in ("data", "model")}


def phase_launches(eng, periods) -> dict:
    """K1, K2 and K3 launches the phases must make on this rank: two
    refreshes a phase, two K1 launches each (``conv_com``); one K3 launch
    a row-sparse inner step; no test, so no K2; none on the CPU."""
    cfg = eng.cfg
    out = {"decay_adam_kernel": 0, "transfer_rows_kernel": 0,
           "masked_rank_gather_kernel": 0}
    if eng.device.type != "cuda":
        return out
    for set_t, _ in periods:
        if cfg.transfer.kind == "conv_com":
            out["transfer_rows_kernel"] += 4
        if cfg.fast_table_adam:
            out["decay_adam_kernel"] += (cfg.mf_epochs
                                         * -(-len(set_t)
                                             // cfg.mf_batch_size))
    return out


def run_phases(device, width: str, mesh) -> dict:
    """The JAX worker's two SML phases on this rank (``mesh=None``: alone):
    whole tables, Θ's leaves, the losses (each phase's means and per-batch
    vectors), seconds per phase, launches and the derived ones, bytes per
    axis."""
    from sml_tpu_torch.config import resolve_fast_table_adam
    from sml_tpu_torch.models.transfer import theta_leaves
    from sml_tpu_torch.parallel import collective
    from sml_tpu_torch.parallel.multihost import MultihostPlacement
    from sml_tpu_torch.scripts.scale_sweep import _kernel_counters
    from sml_tpu_torch.train.engine import SMLEngine
    w = WIDTHS[width]
    cfg = phase_config(width)
    cfg = cfg.replace(fast_table_adam=resolve_fast_table_adam(
        cfg.fast_table_adam, w["users"] + w["items"], cfg.mf_batch_size))
    periods = phase_periods(width)
    eng = SMLEngine(cfg, w["users"], w["items"], device=device)
    dev = eng.device
    if mesh is None:
        state = eng.init_state()
    else:
        eng.placement = MultihostPlacement(mesh, w["users"], w["items"])
        state = eng.placement.state(eng.init_state())
    before = (None if mesh is None
              else {a: collective.traffic(mesh.group(a))
                    for a in ("data", "model")})
    counters = _kernel_counters()
    for c in counters.values():
        c.launches = 0
    losses, batches, seconds = [], [], []
    for set_t, set_tt in periods:
        _sync(dev)
        t0 = time.perf_counter()
        state = eng.snapshot_last(state)
        state, inner = eng.inner_epoch(state, *eng.prep_inner(set_t))
        state = eng.snapshot_hat(state)
        state = eng.refresh(state)
        state, outer = eng.outer_epoch(state, *eng.prep_outer(set_tt))
        state = eng.refresh(state)
        _sync(dev)
        seconds.append(time.perf_counter() - t0)
        inner, outer = inner.cpu().numpy(), outer.cpu().numpy()
        losses.append([float(np.mean(inner)), float(np.mean(outer))])
        batches.append((inner, outer))
    whole = eng.whole_state(state)
    return {"user_emb": whole.mf.user_emb.detach().cpu().numpy(),
            "item_emb": whole.mf.item_emb.detach().cpu().numpy(),
            "theta": [p.detach().cpu().numpy()
                      for p in theta_leaves(whole.theta).values()],
            "losses": losses, "batches": batches, "seconds": seconds,
            "launches": {k: c.launches for k, c in counters.items()},
            "derived": phase_launches(eng, periods),
            "bytes": None if mesh is None else _axis_bytes(mesh, before)}


def run_sweep(device, width: str, spec, mesh, fuse) -> dict:
    """``SMLDriver``'s sweep on this rank (``mesh=None``: alone) with
    ``fuse_period=fuse`` (False: no program at all): seconds per period,
    the route taken, the graphs' counts, launches and those derived from
    the data, bytes per axis, hits, this rank's state digest, and the
    whole final tables and Θ."""
    from sml_tpu_torch.data.formats import row_count
    from sml_tpu_torch.models.transfer import theta_leaves
    from sml_tpu_torch.ops.batching import bucket_rows
    from sml_tpu_torch.parallel import collective
    from sml_tpu_torch.scripts.multicard_check import sweep_config
    from sml_tpu_torch.scripts.scale_sweep import (_kernel_counters,
                                                   state_digest,
                                                   sweep_launches)
    from sml_tpu_torch.train.driver import SMLDriver, fusion_route
    from sml_tpu_torch.utils.logging import MetricsLogger
    cfg = sweep_config(width).replace(fuse_period=fuse,
                                      fuse_phases=fuse is not False)
    drv = SMLDriver(cfg, spec, logger=MetricsLogger(None), device=device)
    counters = _kernel_counters()
    try:
        eng = drv.engine
        dev = eng.device
        state = (eng.init_state() if mesh is None
                 else eng.init_state_sharded(mesh))
        before = (None if mesh is None
                  else {a: collective.traffic(mesh.group(a))
                        for a in ("data", "model")})
        for c in counters.values():
            c.launches = 0
        _sync(dev)
        t0 = time.perf_counter()
        report = drv.run(state)
        _sync(dev)
        wall = time.perf_counter() - t0
        b, n_data = cfg.eval_batch_size, (1 if mesh is None
                                          else mesh.shape["data"])
        bound = eng.shape_targets.get("eval", 0)
        derived = (sweep_launches(
            spec, eng.cfg, lambda kind, t: row_count(spec.path, kind, t),
            eng.cfg.fast_table_adam,
            # this rank's data block of each padded test, in batches
            lambda n: -(-max(bucket_rows(n, b), bucket_rows(bound, b))
                        // (b * n_data)))
            if dev.type == "cuda" else dict.fromkeys(counters, 0))
        out = {"wall_s": wall, "period_s": report.period_seconds,
               "fused": fusion_route(drv.cfg, eng),
               "refusal": eng.capture_refusal(),
               "graphs": dict(eng.graph_stats),
               "launches": {k: c.launches for k, c in counters.items()},
               "derived": derived,
               "bytes": None if mesh is None else _axis_bytes(mesh, before),
               "hits": {k: [round(r * n) for r, n in
                            zip(v, report.test_counts)]
                        for k, v in report.per_period.items()},
               "digest": state_digest(drv.final_state)}
        whole = eng.whole_state(drv.final_state)
        out["user_emb"] = whole.mf.user_emb.detach().cpu().numpy()
        out["item_emb"] = whole.mf.item_emb.detach().cpu().numpy()
        out["theta"] = [p.detach().cpu().numpy()
                        for p in theta_leaves(whole.theta).values()]
    finally:
        # the programs' graphs go before the world's next collectives and
        # its teardown
        drv.close()
    return out


def _differences(a: dict, b: dict) -> dict:
    """Largest absolute differences of the tables and Θ of two runs."""
    return {"user": float(np.abs(a["user_emb"] - b["user_emb"]).max()),
            "item": float(np.abs(a["item_emb"] - b["item_emb"]).max()),
            "theta": max(float(np.abs(x - y).max())
                         for x, y in zip(a["theta"], b["theta"]))}


def _loss_rtol(a: dict, b: dict) -> float:
    return max(float((np.abs(x - y) / np.abs(y).clip(1e-30)).max())
               for pa, pb in zip(a["batches"], b["batches"])
               for x, y in zip(pa, pb))


def _hit_diff(a: dict, b: dict) -> int:
    return max((abs(x - y) for k in a["hits"]
                for x, y in zip(a["hits"][k], b["hits"][k])), default=0)


def rank_main(device, width: str, spec) -> dict:
    """One rank: the phases, then the sweep unfused and fused, on the
    global mesh; then rank 0 alone. Returns the rank's report;
    rank 0's also holds its tables, Θ and losses, and the one-rank
    runs."""
    from sml_tpu_torch.parallel import collective
    from sml_tpu_torch.parallel.multihost import (make_global_mesh,
                                                  process_index)
    mesh = make_global_mesh()
    world = collective.WORLD
    if world["device"].type == "cuda":
        torch.cuda.reset_peak_memory_stats(world["device"])
    out = {"device": str(world["device"]),
           "mesh": [mesh.shape["data"], mesh.shape["model"]],
           "host": world["hosts"][process_index()],
           "card": world["cards"][process_index()],
           "transport": {a: collective.transport(mesh.group(a))
                         for a in ("data", "model")},
           "phases": run_phases(device, width, mesh)}
    fused = "auto" if world["device"].type == "cuda" else True
    out["unfused"] = run_sweep(device, width, spec, mesh, False)
    out["fused"] = run_sweep(device, width, spec, mesh, fused)
    dev = world["device"]
    out["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                       if dev.type == "cuda" else None)
    if process_index() == 0:
        out["one"] = {"phases": run_phases(device, width, None),
                      "fused": run_sweep(device, width, spec, None, fused)}
    else:
        for run in ("unfused", "fused"):
            for k in ("user_emb", "item_emb", "theta"):
                out[run].pop(k)
        for k in ("user_emb", "item_emb", "theta", "batches"):
            out["phases"].pop(k)
    return out


def check(ranks: list, device: str, width: str) -> tuple:
    """The report's checks over every rank; returns ``(report, failed)``."""
    r0 = ranks[0]
    failed = []
    for r, rk in enumerate(ranks):
        for name in ("phases", "unfused", "fused"):
            if rk[name]["launches"] != rk[name]["derived"]:
                failed.append(f"rank{r}:{name}_launches")
        if rk["fused"]["digest"] != rk["unfused"]["digest"]:
            failed.append(f"rank{r}:digests")
        if rk["fused"]["hits"] != rk["unfused"]["hits"]:
            failed.append(f"rank{r}:hits")
        # ranks sharing a card (gloo) stay unfused under "auto"; else one
        # capture a program and rank on the card (the phase program and
        # the test periods' phase-0 epoch programs; none on the CPU)
        refused = rk["fused"]["refusal"] is not None
        if (rk["fused"]["fused"] is refused
                or rk["fused"]["graphs"]["captures"]
                != 3 * int(device == "cuda" and not refused)):
            failed.append(f"rank{r}:one_capture")
    one = r0["one"]
    report = {"phases_vs_one": _differences(r0["phases"], one["phases"]),
              "phases_loss_rtol_vs_one": _loss_rtol(r0["phases"],
                                                    one["phases"])}
    if max(report["phases_vs_one"].values()) > TRAIN_ATOL:
        failed.append("phases_vs_one")
    if report["phases_loss_rtol_vs_one"] > LOSS_RTOL:
        failed.append("phases_losses_vs_one")
    report["sweep_vs_one"] = _differences(r0["fused"], one["fused"])
    report["sweep_hit_diff_vs_one"] = _hit_diff(r0["fused"], one["fused"])
    report["sweep_fused_vs_unfused"] = _differences(r0["fused"],
                                                    r0["unfused"])
    if max(report["sweep_vs_one"].values()) > TRAIN_ATOL:
        failed.append("sweep_vs_one")
    if report["sweep_hit_diff_vs_one"] > HIT_TOL:
        failed.append("sweep_hits_vs_one")
    if one["fused"]["launches"] != one["fused"]["derived"]:
        failed.append("one_launches")
    if (one["fused"]["fused"] is not True
            or one["fused"]["graphs"]["captures"]
            != 3 * int(device == "cuda")):
        failed.append("one_capture")
    return report, failed


def _summary(run: dict) -> dict:
    """A run's figures for the JSON line (no arrays, no digests)."""
    keep = ("seconds", "wall_s", "period_s", "fused", "refusal", "graphs",
            "launches", "derived", "bytes", "losses")
    return {k: run[k] for k in keep if k in run}


def run(args) -> dict:
    """Every rank's runs and the checks; rank 0's ``.npz``; the JSON
    line's document."""
    from sml_tpu_torch.device import resolve_device
    from sml_tpu_torch.parallel.dryrun import run_world
    from sml_tpu_torch.scripts.multicard_check import fused_sweep_dataset
    resolve_device(args.device)
    n = args.hosts * args.ranks_per_host
    root = tempfile.mkdtemp(prefix="sml_multihost_")
    try:
        t0 = time.perf_counter()
        spec = fused_sweep_dataset(root, args.width)
        data_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = run_world(f"{__name__}:rank_main", n, args.device,
                          (args.width, spec), WORLD_TIMEOUT_S,
                          hosts=args.hosts)
        world_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    report, failed = check(ranks, args.device, args.width)
    r0 = ranks[0]["phases"]
    np.savez(args.out, user_emb=r0["user_emb"], item_emb=r0["item_emb"],
             losses=np.asarray(r0["losses"]),
             **{f"theta_{i}": t for i, t in enumerate(r0["theta"])})
    doc = {"hosts": args.hosts, "ranks_per_host": args.ranks_per_host,
           "width": args.width, "device": args.device,
           "mesh": ranks[0]["mesh"], "data_s": data_s, "world_s": world_s,
           "transport": ranks[0]["transport"],
           "ranks": [{"device": rk["device"], "host": rk["host"],
                      "card": rk["card"], "peak_gib": rk["peak_gib"],
                      **{run: _summary(rk[run])
                         for run in ("phases", "unfused", "fused")}}
                     for rk in ranks],
           "one": {run: _summary(x) for run, x in ranks[0]["one"].items()},
           **report, "failed": failed}
    return doc


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    doc = run(args)
    print(json.dumps(doc), flush=True)
    return 1 if doc["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
