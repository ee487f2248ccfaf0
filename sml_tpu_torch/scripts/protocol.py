"""What the two protocol scripts share (``adressa_run.py`` and
``yelp_scale_sweep.py``, the counterparts of the JAX package's
``scripts/adressa_run.py`` and ``scripts/yelp_scale_sweep.py``).

A :class:`Protocol` holds a protocol's constants. Every phase function of
both scripts takes one, so the scripts run their protocols at full depth
and the tests and ``chip_smoke.py`` run the same code at a cut depth.
Results merge into ``<root>/results.json`` (``utils/results.py``) with the
JAX scripts' keys; each phase also prints one JSON line to stderr with its
device, seconds and peak device memory (``torch.cuda.max_memory_allocated``;
null on the CPU) and, for a sweep, its graph counts.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch


class Protocol(NamedTuple):
    name: str           # the dataset's folder under --root
    n_periods: int
    train_start: int
    test_start: int
    neg: int
    multi: int          # multi_num
    epochs: int         # MF_epochs = TR_epochs
    latent: int


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def record(root: str, key: str, value) -> None:
    from sml_tpu_torch.utils.results import record as _rec
    _rec(os.path.join(root, "results.json"), key, value)
    log(f"recorded {key}")


def dspec_for(root: str, proto: Protocol):
    from sml_tpu_torch.config import DataSpec
    return DataSpec(root=root, name=proto.name, num_periods=proto.n_periods,
                    online_train_start=proto.train_start,
                    online_test_start=proto.test_start,
                    eval_neg_num=proto.neg)


def load_pre(root: str, device):
    from sml_tpu_torch.models.mf import MFParams
    blob = np.load(os.path.join(root, "pre.npz"))
    return MFParams(*(torch.from_numpy(blob[f]).to(device)
                      for f in MFParams._fields))


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def note(dev: torch.device, phase: str, key: str, seconds: float,
         **extra) -> dict:
    """Print the phase's stderr line (device, seconds, peak GiB); returns
    it."""
    peak = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    line = {"phase": phase, "key": key, "device": str(dev),
            "seconds": seconds, "peak_gib": peak, **extra}
    log(json.dumps(line, default=str))
    return line


def gen(root: str, proto: Protocol, users: int, items: int, inter: int,
        drift: float, seed: int) -> dict:
    """The synthetic dataset (``latent_dim=8``), test files from the
    training start on; records ``dataset``."""
    from sml_tpu_torch.data.synthetic import (SyntheticSpec,
                                              generate_synthetic_dataset)
    t0 = time.time()
    spec = SyntheticSpec(n_users=users, n_items=items,
                         n_periods=proto.n_periods,
                         interactions_per_period=inter,
                         first_test_period=proto.train_start,
                         neg_num=proto.neg, latent_dim=8, drift=drift,
                         seed=seed)
    info = generate_synthetic_dataset(os.path.join(root, proto.name), spec)
    value = {"n_users": info.n_users, "n_items": info.n_items,
             "n_interactions": info.n_interactions,
             "gen_seconds": round(time.time() - t0, 1)}
    record(root, "dataset", value)
    return value


def pretrain(root: str, proto: Protocol, device) -> dict:
    """The base MF on the periods before the last warm-up period, early
    stopped on its test rows; writes ``<root>/pre.npz`` and records
    ``pretrain``."""
    from sml_tpu_torch.config import PretrainConfig
    from sml_tpu_torch.device import resolve_device
    from sml_tpu_torch.train.pretrain import pretrain_mf
    dev = resolve_device(device)
    reset_peak(dev)
    t0 = time.time()
    pcfg = PretrainConfig(max_epochs=60, eval_every=2, patience=8,
                          batch_size=1024, latent_dim=proto.latent,
                          emb_init_scale=0.1)
    params, metrics = pretrain_mf(pcfg, dspec_for(root, proto),
                                  pretrain_period=proto.test_start - 1,
                                  device=dev)
    np.savez(os.path.join(root, "pre.npz"),
             **{f: getattr(params, f).cpu().numpy()
                for f in params._fields})
    seconds = time.time() - t0
    note(dev, "pretrain", "pretrain", seconds)
    value = {**{k: round(v, 4) for k, v in metrics.items()},
             "seconds": round(seconds, 1)}
    record(root, "pretrain", value)
    return value


class SweepRun(NamedTuple):
    """What :func:`run_sweep` returns: the driver's report, the sweep's
    seconds, the final state, the engine and the stderr line."""
    report: object
    seconds: float
    state: object
    engine: object
    line: dict


def run_sweep(cfg, root: str, proto: Protocol, device, key: str,
              log_path=None) -> SweepRun:
    """``SMLDriver(cfg)`` over the protocol from the pretrained tables;
    ``log_path``: the driver's jsonl records."""
    from sml_tpu_torch.device import resolve_device
    from sml_tpu_torch.train.driver import SMLDriver
    from sml_tpu_torch.utils.logging import MetricsLogger
    dev = resolve_device(device)
    logger = MetricsLogger(log_path) if log_path else None
    driver = SMLDriver(cfg, dspec_for(root, proto), logger=logger,
                       device=dev)
    try:
        assert driver._stop_stage == proto.test_start - proto.train_start - 1
        state = driver.engine.init_state(pretrained_mf=load_pre(root, dev))
        reset_peak(dev)
        t0 = time.time()
        report = driver.run(state)
        seconds = time.time() - t0
    finally:
        driver.close()
        if logger is not None:
            logger.close()
    line = note(dev, "sweep", key, seconds,
                graph_stats=dict(driver.engine.graph_stats))
    return SweepRun(report, seconds, driver.final_state, driver.engine, line)


def fuse_fields(value: str) -> dict:
    """``--fuse-period``'s ``SMLConfig`` fields: ``auto`` (fused on the
    card, eager on the CPU), ``on`` (the whole period one program) or
    ``off`` (no program at all: the eager path, which the fused runs are
    held to; the JAX scripts' ``off`` still fuses phase by phase)."""
    return {"auto": dict(fuse_period="auto"),
            "on": dict(fuse_period=True),
            "off": dict(fuse_phases=False, fuse_period=False)}[value]
