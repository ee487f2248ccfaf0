"""The full Yelp-scale SML sweep on the port (counterpart of
``scripts/yelp_scale_sweep.py``).

The reference's Yelp protocol shape: 40 periods, online training from
period 10, online testing 30-39, 999 eval negatives, d=64, multi_num=10,
MF/TR 1 epoch, on a synthetic dataset of Yelp-like size (31,000 users x
21,000 items, 30,000 interactions a period). The same flags, dataset,
configurations and ``results.json`` keys as the JAX script's ``gen``,
``pretrain``, ``ours`` and ``baseline`` phases; ``--device`` (default
``cuda``) in place of its ``--platform``, and no compile cache.

    python -m sml_tpu_torch.scripts.yelp_scale_sweep --phase gen --root /tmp/yelp_scale
    python -m sml_tpu_torch.scripts.yelp_scale_sweep --phase pretrain --root /tmp/yelp_scale
    python -m sml_tpu_torch.scripts.yelp_scale_sweep --phase ours --evals --root /tmp/yelp_scale
    python -m sml_tpu_torch.scripts.yelp_scale_sweep --phase baseline --method fine --root /tmp/yelp_scale

With ``--evals`` every inner and outer epoch evaluates the period's val
rows (the reference's always-on in-training evals); the 21,000-item
catalog is under the packed masks' cap, so those evals and the tests rank
through kernel K2. Each phase merges its result into ``<root>/results.json``
and prints its device, seconds and peak device memory to stderr; each
phase function takes a :class:`~sml_tpu_torch.scripts.protocol.Protocol`.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from sml_tpu_torch.scripts.protocol import (Protocol, SweepRun, dspec_for,
                                            fuse_fields, gen, load_pre, note,
                                            pretrain, record, reset_peak,
                                            run_sweep)

N_PERIODS = 40
TRAIN_START = 10
TEST_START = 30
NEG = 999
MULTI = 10
LATENT = 64

PROTOCOL = Protocol("synth", N_PERIODS, TRAIN_START, TEST_START, NEG, MULTI,
                    1, LATENT)


def phase_gen(args, proto: Protocol = PROTOCOL) -> dict:
    return gen(args.root, proto, args.users, args.items, args.inter,
               drift=0.05, seed=17)


def phase_pretrain(args, proto: Protocol = PROTOCOL) -> dict:
    return pretrain(args.root, proto, args.device)


def ours_config(args, proto: Protocol = PROTOCOL):
    """The JAX script's ``SMLConfig``, field for field."""
    from sml_tpu_torch.config import SMLConfig, TransferConfig
    return SMLConfig(multi_num=proto.multi, mf_epochs=proto.epochs,
                     tr_epochs=proto.epochs, latent_dim=proto.latent,
                     transfer=TransferConfig(latent_dim=proto.latent),
                     mf_batch_size=1024, tr_batch_size=256,
                     eval_batch_size=1024, mf_sample="all",
                     tr_sample_type="alone", seed=args.seed,
                     eval_during_inner=args.evals,
                     eval_during_outer=args.evals,
                     log_norms=bool(args.log),
                     theta_warmstart_steps=args.warmstart,
                     theta_seed=args.theta_seed,
                     saddle_retries=args.saddle_retries,
                     uniform_shapes=not args.per_period_shapes,
                     upload_dedup=not args.no_upload_dedup,
                     **fuse_fields(args.fuse_period))


def phase_ours(args, proto: Protocol = PROTOCOL) -> SweepRun:
    key = args.key or "ours"
    run = run_sweep(ours_config(args, proto), args.root, proto, args.device,
                    key, args.log)
    report = run.report
    record(args.root, key, {
        "backend": run.engine.device.type,
        "seed": args.seed,
        "evals_during_train": args.evals,
        "theta_warmstart_steps": args.warmstart,
        "total_seconds": round(run.seconds, 1),
        "saddle_retries_used": report.saddle_retries_used,
        "period_seconds": [round(s, 2) for s in report.period_seconds],
        "summary": {k: round(v, 5) for k, v in report.summary().items()},
        "per_period_recall@20":
            [round(v, 4) for v in report.per_period.get(20, [])],
    })
    return run


def phase_baseline(args, proto: Protocol = PROTOCOL):
    """full, fine or SPMF from the test start (``pool_init_type=0``: no
    early stop); returns the driver."""
    from sml_tpu_torch.config import BaselineConfig
    from sml_tpu_torch.device import resolve_device
    from sml_tpu_torch.ops.metrics import weighted_period_average
    from sml_tpu_torch.train.baselines import BaselineDriver

    dev = resolve_device(args.device)
    cfg = BaselineConfig(method=args.method, lr=0.01, l2_user=1e-5,
                         l2_item=1e-5, epochs=args.epochs, batch_size=256,
                         pool_size=args.pool if args.method == "spmf" else 0,
                         pool_init_type=0, start_period=proto.test_start,
                         latent_dim=proto.latent, eval_batch_size=1024,
                         seed=args.seed)
    driver = BaselineDriver(cfg, dspec_for(args.root, proto),
                            pretrained=load_pre(args.root, dev), device=dev)
    key = args.key or f"ours_baseline_{args.method}"
    reset_peak(dev)
    t0 = time.time()
    summary = driver.run()
    total = time.time() - t0
    note(dev, "baseline", key, total, graph_stats=dict(driver.graph_stats))
    rec = np.asarray(driver.recall, dtype=float)
    counts = driver.test_counts
    val20, test20 = (round(float(v), 5) for v in weighted_period_average(
        rec[:, 2], counts, drop_last_test=False))
    record(args.root, key, {
        "seed": args.seed, "method": args.method, "epochs": args.epochs,
        "pool": args.pool if args.method == "spmf" else 0,
        "total_seconds": round(total, 1),
        "summary": {"val_recall@20": val20, "test_recall@20": test20,
                    **{k: round(v, 5) for k, v in summary.items()}},
        "recall@20": [round(v, 4) for v in rec[:, 2]],
        "recall@5": [round(v, 4) for v in rec[:, 0]],
        "test_num": counts,
    })
    return driver


PHASES = {"gen": phase_gen, "pretrain": phase_pretrain, "ours": phase_ours,
          "baseline": phase_baseline}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("yelp_scale_sweep")
    ap.add_argument("--phase", required=True, choices=list(PHASES))
    ap.add_argument("--method", default="fine",
                    help="baseline: full | fine | spmf")
    ap.add_argument("--epochs", type=int, default=10,
                    help="baseline: epochs per period")
    ap.add_argument("--pool", type=int, default=30_000,
                    help="baseline: spmf reservoir size")
    ap.add_argument("--root", required=True)
    ap.add_argument("--users", type=int, default=31_000)
    ap.add_argument("--items", type=int, default=21_000)
    ap.add_argument("--inter", type=int, default=30_000)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=2000)
    ap.add_argument("--key", default=None,
                    help="results.json key (default: the phase name)")
    ap.add_argument("--evals", action="store_true",
                    help="ours: the reference's always-on in-training "
                         "evals")
    ap.add_argument("--log", default=None,
                    help="ours: jsonl diagnostics path (enables log_norms)")
    ap.add_argument("--warmstart", type=int, default=0,
                    help="ours: theta_warmstart_steps (saddle stabilizer)")
    ap.add_argument("--saddle-retries", type=int, default=0,
                    help="ours: SMLConfig.saddle_retries (first-period "
                         "bad-stream guard)")
    ap.add_argument("--theta-seed", type=int, default=None,
                    help="ours: freeze Θ's init to this seed while --seed "
                         "varies the data stream")
    ap.add_argument("--fuse-period", default="auto",
                    choices=["auto", "on", "off"],
                    help="ours: one captured program per run (auto: on "
                         "the card, eager on the CPU; off: eager)")
    ap.add_argument("--per-period-shapes", action="store_true",
                    help="ours: no sweep-wide shape buckets")
    ap.add_argument("--no-upload-dedup", action="store_true",
                    help="ours: no content-keyed reuse of uploaded eval "
                         "sets")
    return ap


def main(argv=None, proto: Protocol = PROTOCOL) -> int:
    args = build_parser().parse_args(argv)
    os.makedirs(args.root, exist_ok=True)
    PHASES[args.phase](args, proto)
    return 0


if __name__ == "__main__":
    sys.exit(main())
