"""Adressa ("news") protocol end to end on the port: SML and all three
baselines (counterpart of ``scripts/adressa_run.py``).

The news protocol's shape (reference ``main_news.py:221-227``,
``model/baseline.py:624-625``): 63 periods, online training from 21,
online test 48-62, MF_epochs = TR_epochs = 2, multi_num = 7, baselines with
``pool_init_type=1`` (which turns on the reference's early stop), on a
synthetic dataset of 12,000 users x 8,000 items. The same flags, dataset,
configurations and ``results.json`` keys as the JAX script; ``--device``
(default ``cuda``) in place of its ``--platform``, and no compile cache.

    python -m sml_tpu_torch.scripts.adressa_run --phase gen --root /tmp/adressa
    python -m sml_tpu_torch.scripts.adressa_run --phase pretrain --root /tmp/adressa
    python -m sml_tpu_torch.scripts.adressa_run --phase sml --root /tmp/adressa
    python -m sml_tpu_torch.scripts.adressa_run --phase baselines --root /tmp/adressa

Each phase merges its result into ``<root>/results.json`` and prints its
device, seconds and peak device memory to stderr. Each phase function takes
a :class:`~sml_tpu_torch.scripts.protocol.Protocol`, so the tests and
``chip_smoke.py`` run them at a cut depth.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from sml_tpu_torch.scripts.protocol import (Protocol, SweepRun, dspec_for,
                                            fuse_fields, gen, load_pre, log,
                                            note, pretrain, record,
                                            reset_peak, run_sweep)

N_PERIODS = 63
TRAIN_START = 21
TEST_START = 48
NEG = 999
MULTI = 7
EPOCHS = 2          # MF_epochs = TR_epochs = 2 (main_news.py:22,34)
LATENT = 64
BASE_EPOCHS = 20    # baseline --epochs default (baseline.py:604)

PROTOCOL = Protocol("news", N_PERIODS, TRAIN_START, TEST_START, NEG, MULTI,
                    EPOCHS, LATENT)


def phase_gen(args, proto: Protocol = PROTOCOL) -> dict:
    return gen(args.root, proto, args.users, args.items, args.inter,
               drift=0.08, seed=23)


def phase_pretrain(args, proto: Protocol = PROTOCOL) -> dict:
    return pretrain(args.root, proto, args.device)


def sml_config(args, proto: Protocol = PROTOCOL):
    """``adressa_sml()`` at the protocol's width, with the run's seed,
    saddle guard, diagnostics and fusion switch."""
    from sml_tpu_torch.config import TransferConfig, adressa_sml
    cfg = adressa_sml().replace(
        latent_dim=proto.latent,
        transfer=TransferConfig(latent_dim=proto.latent),
        seed=args.seed, saddle_retries=args.saddle_retries,
        log_norms=bool(args.log), **fuse_fields(args.fuse_period))
    assert cfg.multi_num == proto.multi and cfg.mf_epochs == proto.epochs \
        and cfg.tr_epochs == proto.epochs
    return cfg


def phase_sml(args, proto: Protocol = PROTOCOL) -> SweepRun:
    key = args.key or "sml"
    run = run_sweep(sml_config(args, proto), args.root, proto, args.device,
                    key, args.log)
    report = run.report
    record(args.root, key, {
        "backend": run.engine.device.type,
        "seed": args.seed,
        "total_seconds": round(run.seconds, 1),
        "fuse_period": args.fuse_period,
        "saddle_retries_used": report.saddle_retries_used,
        "period_seconds": [round(s, 2) for s in report.period_seconds],
        "summary": {k: round(v, 5) for k, v in report.summary().items()},
        "per_period_recall@20":
            [round(v, 4) for v in report.per_period.get(20, [])],
        "test_num": report.test_counts,
    })
    return run


def phase_baselines(args, proto: Protocol = PROTOCOL,
                    base_epochs: int = BASE_EPOCHS, max_periods=None) -> dict:
    """fine, full and SPMF from the test start, each for ``max_periods``
    test periods (all by default); returns the method's drivers beside
    the record under ``"drivers"``."""
    from sml_tpu_torch.config import BaselineConfig
    from sml_tpu_torch.device import resolve_device
    from sml_tpu_torch.train.baselines import BaselineDriver

    dev = resolve_device(args.device)
    out = {"backend": dev.type}
    drivers = {}
    for method in ("fine", "full", "spmf"):
        reset_peak(dev)
        t0 = time.time()
        cfg = BaselineConfig(
            method=method, epochs=base_epochs, batch_size=256,
            pool_size=args.pool if method == "spmf" else 0,
            pool_init_type=1,                      # news: early stop active
            start_period=proto.test_start, latent_dim=proto.latent,
            seed=args.seed)
        driver = BaselineDriver(cfg, dspec_for(args.root, proto),
                                pretrained=load_pre(args.root, dev),
                                device=dev)
        summary = driver.run(max_periods)
        seconds = time.time() - t0
        out[method] = {
            "seconds": round(seconds, 1),
            "summary": {k: round(v, 5) for k, v in summary.items()},
            "per_period_recall@20":
                [round(r[-1], 4) for r in driver.recall],
        }
        note(dev, "baseline", method, seconds,
             graph_stats=dict(driver.graph_stats))
        log(f"{method}: {out[method]['summary']}")
        drivers[method] = driver
    record(args.root, "baselines", out)
    return {**out, "drivers": drivers}


PHASES = {"gen": phase_gen, "pretrain": phase_pretrain, "sml": phase_sml,
          "baselines": phase_baselines}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("adressa_run")
    ap.add_argument("--phase", required=True, choices=list(PHASES))
    ap.add_argument("--fuse-period", default="auto",
                    choices=["auto", "on", "off"],
                    help="sml: one captured program per run (auto: on "
                         "the card, eager on the CPU; off: eager)")
    ap.add_argument("--root", required=True)
    ap.add_argument("--users", type=int, default=12_000)
    ap.add_argument("--items", type=int, default=8_000)
    ap.add_argument("--inter", type=int, default=8_000)
    ap.add_argument("--pool", type=int, default=30_000)
    ap.add_argument("--seed", type=int, default=2000)
    ap.add_argument("--key", default=None,
                    help="results.json key (default: the phase name)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--saddle-retries", type=int, default=0,
                    help="sml: first-period bad-stream guard (0 = "
                         "reference-faithful)")
    ap.add_argument("--log", default=None,
                    help="sml: per-phase diagnostics jsonl (log_norms)")
    return ap


def main(argv=None, proto: Protocol = PROTOCOL) -> int:
    args = build_parser().parse_args(argv)
    os.makedirs(args.root, exist_ok=True)
    PHASES[args.phase](args, proto)
    return 0


if __name__ == "__main__":
    sys.exit(main())
