"""Base-MF pretraining (counterpart of ``sml_tpu/train/pretrain.py``).

The training protocol that produces the SML starting tables
(``SPMF.base_train``, ``model/baseline.py:161-223``): plain BCE-MF with
per-side L2 on the cumulative history up to the pretrain period, Adam,
evaluation every ``eval_every`` epochs on the pretrain period's test rows,
the best recall@20 state kept, a stop after ``patience`` best-less eval
rounds.

The epochs run through one :class:`~sml_tpu_torch.train.steps.
PlainEpochProgram` (the JAX package jits the epoch): on the card the
first epoch eagerly (the warm-up), then one capture, then a replay per
epoch; the evaluations and the stop stay on the host between epochs.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from sml_tpu_torch.config import (DataSpec, PretrainConfig,
                                  resolve_fast_table_adam)
from sml_tpu_torch.data.feeder import StreamingPeriods
from sml_tpu_torch.device import resolve_device
from sml_tpu_torch.eval.evaluator import make_eval_fn
from sml_tpu_torch.models.mf import MFParams, init_mf
from sml_tpu_torch.ops.batching import pad_rows
from sml_tpu_torch.ops.sampling import build_period_index
from sml_tpu_torch.train.engine import derive_seed
from sml_tpu_torch.train.graphs import GraphSite
from sml_tpu_torch.train.optim import adam_init
from sml_tpu_torch.train.steps import PlainEpochProgram, make_plain_mf_epoch
from sml_tpu_torch.utils.logging import MetricsLogger


def pretrain_mf(cfg: PretrainConfig, spec: DataSpec, pretrain_period: int,
                logger: Optional[MetricsLogger] = None,
                topks: Sequence[int] = (5, 10, 20),
                device="cuda", site: Optional[GraphSite] = None
                ) -> Tuple[MFParams, dict]:
    """Train the base MF on ``train/0..pretrain_period-1``, early-stopping
    on recall@20 of ``test/<pretrain_period>``; returns (best_params,
    metrics). Tables draw from a CPU generator seeded ``cfg.seed`` (the
    same tables on every device), the epochs' draws from a generator on
    ``device``. ``site``: where the epoch program runs (its ``stats``
    count the warm-up, captures and replays); a new one by default."""
    device = resolve_device(device)
    site = site or GraphSite(device)
    logger = logger or MetricsLogger(None)
    stream = StreamingPeriods(spec)
    train, test = stream.get_next(pretrain_period, mode="not_only_new")
    if train is None:
        raise ValueError(f"no data for pretrain period {pretrain_period}")

    info = stream.info
    fast = resolve_fast_table_adam(None, info.n_users + info.n_items,
                                   cfg.batch_size)
    epoch_fn = make_plain_mf_epoch(cfg.batch_size, cfg.l2_user, cfg.l2_item,
                                   cfg.lr, cfg.neg_tries,
                                   fast_lr=cfg.lr if fast else None)
    eval_fn = make_eval_fn(topks, 1024, scoring=cfg.eval_scoring)

    mf = init_mf(torch.Generator().manual_seed(cfg.seed), info.n_users,
                 info.n_items, cfg.latent_dim, device=device,
                 emb_scale=cfg.emb_init_scale)
    opt = adam_init(mf._asdict())
    gen = torch.Generator(device=device).manual_seed(
        derive_seed(cfg.seed, "pretrain"))

    padded = pad_rows(train, cfg.batch_size, device=device)
    index = build_period_index(train, info.n_items, device=device)
    test_padded = pad_rows(test, 1024, device=device)

    def evaluate(mfp):
        sums = eval_fn(mfp, test_padded.rows, test_padded.mask)
        n = max(test_padded.n_real, 1)
        return {k: (float(h) / n, float(nd) / n)
                for k, (h, nd) in sums.items()}

    best = {"recall20": -1.0, "params": mf, "epoch": -1}
    stale = 0
    program = PlainEpochProgram(epoch_fn, site, mf, opt, padded, index,
                                cfg.batch_size)
    for epoch in range(cfg.max_epochs):
        mf, opt, losses = program.run(mf, opt, padded, gen, index)
        if epoch % cfg.eval_every == 0:
            m = evaluate(mf)
            r20 = m[max(topks)][0]
            stale += 1
            if r20 > best["recall20"]:
                best = {"recall20": r20,
                        "params": MFParams(*(t.clone() for t in mf)),
                        "epoch": epoch}
                stale = 0
            logger.log(kind="pretrain_eval", epoch=epoch,
                       loss=float(losses.mean()),
                       **{f"recall@{k}": v[0] for k, v in m.items()},
                       **{f"ndcg@{k}": v[1] for k, v in m.items()})
            if stale > cfg.patience:
                break

    final = evaluate(best["params"])
    metrics = {"best_epoch": best["epoch"],
               **{f"recall@{k}": v[0] for k, v in final.items()},
               **{f"ndcg@{k}": v[1] for k, v in final.items()}}
    return best["params"], metrics
