"""Retraining baselines: full retrain, fine-tune, SPMF (counterpart of
``sml_tpu/train/baselines.py``).

* **full retrain**: each period, train on all history;
* **fine-tune**: the newest period only;
* **SPMF** (streaming MF): a reservoir pool joined with the new data,
  sampled with a rank-derived softmax distribution, and a classic
  reservoir update.

The loss everywhere is mean BCE plus per-side summed L2. The reservoir and
the stream bookkeeping are host-side numpy (stream logic, not compute); the
training and evaluation run on the device. As in the JAX package, padded
shapes are sweep-wide, per-period metrics are deferred and resolved in
:meth:`BaselineDriver.finalize`, and a dataset that ships new-entity id
files is evaluated with hit attribution. Every epoch runs through one
program per padded shape (one per run: the shapes are sweep-wide), on the
card one capture replayed in every epoch of every period: the full and
fine epochs through a :class:`~sml_tpu_torch.train.steps.PlainEpochProgram`,
SPMF's through an :class:`~sml_tpu_torch.train.steps.EpochProgram` whose
inputs are the padded pool and its draw distribution (``cdf``, made
eagerly from the tables before each epoch) and whose step slots cover
``round(n_pad/B)``, the batches of the largest pool; a period's
``round(N/B)`` batches take the first slots.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sml_tpu_torch.config import (BaselineConfig, DataSpec,
                                  resolve_fast_table_adam)
from sml_tpu_torch.data.feeder import StreamingPeriods
from sml_tpu_torch.data.formats import row_count
from sml_tpu_torch.device import resolve_device
from sml_tpu_torch.eval.evaluator import (check_eval_ids,
                                          make_attributed_eval_fn,
                                          make_eval_fn)
from sml_tpu_torch.models.mf import MFParams, init_mf, score_pairs
from sml_tpu_torch.ops.batching import pad_rows
from sml_tpu_torch.ops.losses import bce_pair_loss, l2_embedding_penalty
from sml_tpu_torch.ops.metrics import weighted_period_average
from sml_tpu_torch.ops.sampling import (PeriodIndex, build_period_index,
                                        draw_offset, rand_offset,
                                        sample_negatives)
from sml_tpu_torch.train.engine import derive_seed
from sml_tpu_torch.train.graphs import GraphSite, shape_key
from sml_tpu_torch.train.optim import AdamState, adam_init, adam_update
from sml_tpu_torch.train.steps import (EpochProgram, PlainEpochProgram,
                                       loss_buffer, make_plain_mf_epoch,
                                       run_slots)
from sml_tpu_torch.utils.logging import MetricsLogger


class Reservoir:
    """Streaming reservoir over the interaction stream: each new row is
    admitted with probability ``len/(t+i+1)`` and overwrites a uniformly
    random slot. Numpy, the same draws as the JAX package's from the same
    generator."""

    def __init__(self, length: int, rng: np.random.Generator):
        self.len = length
        self.pool = np.zeros((max(length, 1), 2), dtype=np.int64)
        self.pool_have = 0
        self.t = 0
        self.rng = rng

    def update(self, new_data: np.ndarray) -> None:
        if self.len == 0:
            return
        if self.pool_have < self.len:
            take = min(self.len - self.pool_have, new_data.shape[0])
            self.pool[self.pool_have:self.pool_have + take] = new_data[:take]
            self.pool_have += take
            self.t += take
            new_data = new_data[take:]
        n = new_data.shape[0]
        if n == 0:
            return
        p = self.len / (self.t + np.arange(n) + 1.0)
        admit = self.rng.random(n) < p
        selected = new_data[admit]
        slots = self.rng.integers(0, self.len, selected.shape[0])
        self.pool[slots] = selected
        self.t += n

    def init_pool(self, data: np.ndarray) -> None:
        """Fill with the most recent rows (``pool_init_type=1``)."""
        if self.len == 0:
            return
        self.pool[:] = data[-self.len:]
        self.pool_have = self.len
        self.t = data.shape[0]


def rank_sampling_probs(mf: MFParams, pairs: torch.Tensor,
                        valid: Optional[torch.Tensor] = None,
                        n_real: Optional[int] = None) -> torch.Tensor:
    """SPMF's rank-softmax sampling distribution: rank all pool pairs by
    model score descending (a stable sort, as ``jnp.argsort``), weight
    ``w = exp(rank/N)``, normalize; worse-fit interactions weigh more.

    ``valid``/``n_real``: pad rows score ``-inf`` (ranked after every real
    row, so real ranks are unchanged) and get weight zero; ``N`` is the
    real count."""
    pairs = pairs.long()
    scores = score_pairs(mf, pairs[:, 0], pairs[:, 1])
    n_pad = scores.shape[0]
    if valid is not None:
        scores = torch.where(valid, scores,
                             torch.full_like(scores, float("-inf")))
    n = float(n_pad if n_real is None else n_real)
    order = torch.argsort(-scores, stable=True)
    ranks = torch.zeros(n_pad, dtype=torch.float32, device=scores.device)
    ranks[order] = torch.arange(1, n_pad + 1, dtype=torch.float32,
                                device=scores.device)
    w = torch.exp(ranks / n)
    if valid is not None:
        w = torch.where(valid, w, torch.zeros_like(w))
    return w / torch.sum(w)


def draw_cdf(probs: torch.Tensor) -> torch.Tensor:
    """The cumulative distribution SPMF draws from, on ``probs``' device:
    the scan runs on the host, in order. On the card ``torch.cumsum`` of a
    pool-long f32 vector groups its partial sums by timing (a decoupled
    look-back scan), so two identical runs would draw differently."""
    return torch.cumsum(probs.cpu(), 0).to(probs.device)


def spmf_slots(n_pad: int, batch_size: int) -> int:
    """SPMF's step slots for a pool padded to ``n_pad`` rows: the
    reference's ``round(N/B)`` batches (at least one) of the largest pool
    the padding holds."""
    return max(1, round(n_pad / batch_size))


def spmf_draw(cdf: torch.Tensor, u01: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse-CDF draw: the first index whose cumulative weight reaches
    ``u01`` (``searchsorted`` on the left side, as ``jnp.searchsorted``),
    clipped into ``[0, n)``."""
    return torch.clamp(torch.searchsorted(cdf, u01), 0, n - 1)


def _make_spmf_epoch(batch_size: int, l2_u: float, l2_i: float, lr: float,
                     neg_tries: int):
    """One SPMF epoch: ``n_batches`` weighted-draw batches. Each batch is
    drawn from the pool by :func:`spmf_draw` over the rank-softmax
    probabilities; negatives are rejection-sampled against the cumulative
    user history. ``epoch(mf, opt, pairs, cdf, n_batches, generator,
    hist_index, losses=None, slots=None) -> (mf, opt, losses)`` in place;
    ``epoch.step(mf, opt, u, i, j) -> (opt, loss)`` is one dense Adam step
    on a given triple batch.

    The epoch has ``round(P/B)`` step slots for a ``P``-row padded pool
    (``losses`` is that long, 0 past the run's batches): eagerly the first
    ``n_batches`` run, inside an :class:`EpochProgram` (``slots=``) the
    slots it marks, and eager epochs on a CUDA generator skip the Philox
    offsets of the slots they do not run (``steps.run_slots``), so the
    eager and the replayed epochs draw alike."""

    def loss_fn(mfp: MFParams, u, i, j):
        pos = score_pairs(mfp, u, i)
        neg = score_pairs(mfp, u, j)
        ones = torch.ones_like(pos)
        xu, xi, xj = mfp.user_emb[u], mfp.item_emb[i], mfp.item_emb[j]
        return (bce_pair_loss(pos, neg, ones)
                + l2_u * l2_embedding_penalty(ones, xu)
                + l2_i * l2_embedding_penalty(ones, xi, xj))

    def step(mf: MFParams, opt: AdamState, u, i, j):
        tabs = {f: getattr(mf, f).detach().requires_grad_()
                for f in ("user_emb", "item_emb")}
        with torch.enable_grad():
            loss = loss_fn(mf._replace(**tabs), u, i, j)
            grads = dict(zip(tabs, torch.autograd.grad(
                loss, list(tabs.values()))))
        return adam_update(mf._asdict(), grads, opt, lr=lr), loss

    def per_step(device):
        return (rand_offset(batch_size, device)
                + draw_offset(batch_size, neg_tries, device))

    def epoch(mf: MFParams, opt: AdamState, pairs: torch.Tensor,
              cdf: torch.Tensor, n_batches: int, generator: torch.Generator,
              hist_index: PeriodIndex, losses=None, slots=None):
        pairs = pairs.long()
        nb_max = spmf_slots(pairs.shape[0], batch_size)
        losses = loss_buffer(losses, nb_max, pairs.device)

        def one(b):
            nonlocal opt
            u01 = torch.rand(batch_size, generator=generator,
                             device=pairs.device)
            idx = spmf_draw(cdf, u01, pairs.shape[0])
            u, i = pairs[idx, 0], pairs[idx, 1]
            j = sample_negatives(hist_index, u, generator, neg_tries)
            opt, loss = step(mf, opt, u, i, j)
            losses[b] = loss.detach()
        run_slots(nb_max, min(n_batches, nb_max), generator, slots, one,
                  per_step)
        return mf, opt, losses

    epoch.step = step
    return epoch


class BaselineDriver:
    def __init__(self, cfg: BaselineConfig, spec: DataSpec,
                 pretrained: Optional[MFParams] = None,
                 logger: Optional[MetricsLogger] = None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.stream = StreamingPeriods(spec)
        self.logger = logger or MetricsLogger(None)
        info = self.stream.info
        self.rng = np.random.default_rng(cfg.seed)
        self.reservoir = Reservoir(cfg.pool_size, self.rng)

        fast = resolve_fast_table_adam(None, info.n_users + info.n_items,
                                       cfg.batch_size)
        self._epoch = make_plain_mf_epoch(
            cfg.batch_size, cfg.l2_user, cfg.l2_item, cfg.lr, cfg.neg_tries,
            fast_lr=cfg.lr if fast else None)
        self._spmf_epoch = _make_spmf_epoch(cfg.batch_size, cfg.l2_user,
                                            cfg.l2_item, cfg.lr,
                                            cfg.neg_tries)
        self._eval = make_eval_fn(cfg.topk, cfg.eval_batch_size,
                                  scoring=cfg.eval_scoring)
        self._eval_attr = make_attributed_eval_fn(
            cfg.topk, cfg.eval_batch_size, scoring=cfg.eval_scoring)

        # new-entity indicators for hit attribution
        def indicator(ids: np.ndarray, n: int):
            if not ids.size:
                return None
            out = torch.zeros(n, dtype=torch.float32, device=self.device)
            out[torch.from_numpy(ids).to(self.device)] = 1.0
            return out
        self._is_new_user = indicator(self.stream.test_new_user,
                                      info.n_users)
        self._is_new_item = indicator(self.stream.test_new_item,
                                      info.n_items)

        self.gen = torch.Generator(device=self.device).manual_seed(
            derive_seed(cfg.seed, "baseline"))
        if pretrained is not None:
            self.mf = MFParams(*(torch.as_tensor(t).to(self.device, copy=True)
                                 for t in pretrained))
        else:
            self.mf = init_mf(torch.Generator().manual_seed(cfg.seed),
                              info.n_users, info.n_items, cfg.latent_dim,
                              device=self.device,
                              emb_scale=cfg.emb_init_scale)
        self.opt = adam_init(self.mf._asdict())
        # the full / fine epoch programs by input shape, and their site
        self.site = GraphSite(self.device)
        self.graph_stats = self.site.stats
        self._programs: Dict[tuple, EpochProgram] = {}

        # cumulative user history for SPMF's negative sampler
        self._hist_pairs: List[np.ndarray] = []
        # sweep-wide row-count bounds (npy headers only): one padded shape
        # per stream for every period
        self._bounds = self._shape_bounds()
        # per-period final metrics, resolved together in finalize()
        self._pending: List[tuple] = []

        self.recall: List[List[float]] = []
        self.ndcg: List[List[float]] = []
        self.test_counts: List[int] = []
        self.hit_new_user: List[List[float]] = []
        self.hit_new_item: List[List[float]] = []

    def _shape_bounds(self) -> Dict[str, int]:
        """Sweep-wide max row counts: ``train`` covers the largest pool any
        period trains on (cumulative history for full, one period for fine,
        reservoir + one period for spmf), ``hist`` the whole history,
        ``eval`` the largest test set."""
        spec = self.stream.spec
        counts = []
        for p in range(spec.num_periods):
            c = row_count(spec.path, "train", p)
            if c is not None:
                counts.append(c)
        per_period = max(counts, default=0)
        if self.cfg.method == "full":
            train = sum(counts)
        elif self.cfg.method == "spmf":
            train = min(self.cfg.pool_size, sum(counts)) + per_period
        else:
            train = per_period
        evals = [row_count(spec.path, "test", p)
                 for p in range(spec.num_periods)]
        return {"train": train, "hist": sum(counts),
                "eval": max((c for c in evals if c is not None), default=0)}

    def _pad_eval(self, test_rows: np.ndarray):
        """Pad and upload an eval set once per period (sweep-wide shape);
        early-stop evals and the final metrics reuse it. An id outside
        the tables raises ``ValueError`` first (:func:`check_eval_ids`)."""
        info = self.stream.info
        check_eval_ids(test_rows, info.n_users, info.n_items)
        return pad_rows(test_rows, self.cfg.eval_batch_size,
                        pad_to=self._bounds["eval"], device=self.device)

    def evaluate(self, test_rows) -> Dict[int, Tuple[float, float]]:
        padded = (test_rows if hasattr(test_rows, "n_real")
                  else self._pad_eval(test_rows))
        sums = self._eval(self.mf, padded.rows, padded.mask)
        n = max(padded.n_real, 1)
        return {k: (float(h) / n, float(nd) / n)
                for k, (h, nd) in sums.items()}

    def evaluate_attributed(self, test_rows, deferred: bool = False):
        """Eval plus hit attribution on new users/items, normalized by the
        test count. None if the dataset ships no new-entity id files.
        ``deferred``: return the device results and n, unresolved."""
        if self._is_new_user is None or self._is_new_item is None:
            return None
        padded = (test_rows if hasattr(test_rows, "n_real")
                  else self._pad_eval(test_rows))
        out = self._eval_attr(self.mf, padded.rows, padded.mask,
                              self._is_new_user, self._is_new_item)
        n = max(padded.n_real, 1)
        if deferred:
            return out, n
        return self._resolve_attr(out, n)

    @staticmethod
    def _resolve_attr(out, n):
        return {
            "base": {k: (float(h) / n, float(nd) / n)
                     for k, (h, nd) in out["base"].items()},
            "hit_new_user": {k: float(v) / n
                             for k, v in out["hit_new_user"].items()},
            "hit_new_item": {k: float(v) / n
                             for k, v in out["hit_new_item"].items()},
            "buckets_at_max_k": [float(x) for x in out["buckets_at_max_k"]],
        }

    # ------------------------------------------------------------------ modes
    @property
    def _early_stop(self) -> bool:
        """The reference breaks epoch loops early only when
        ``pool_init_type == 1`` (its news configuration); ``early_stop``
        forces it on for any pool type."""
        return self.cfg.early_stop or self.cfg.pool_init_type == 1

    def _recall_at_maxk(self, test) -> float:
        return self.evaluate(test)[max(self.cfg.topk)][0]

    def _train_offline(self, train_data: np.ndarray, test=None) -> None:
        """Full-retrain / fine-tune epochs, with the reference's early stop:
        recall@K_max every 5 epochs, a break after more than 5 epochs
        without a new best."""
        padded = pad_rows(train_data, self.cfg.batch_size,
                          pad_to=self._bounds["train"], device=self.device)
        index = build_period_index(train_data, self.stream.info.n_items,
                                   min_rows=self._bounds["train"],
                                   device=self.device)
        key = shape_key(padded.rows, *index)
        program = self._programs.get(key)
        if program is None:
            program = self._programs[key] = PlainEpochProgram(
                self._epoch, self.site, self.mf, self.opt, padded, index,
                self.cfg.batch_size)
        best20, not_chang = 0.0, 0
        for epoch in range(self.cfg.epochs):
            self.mf, self.opt, _ = program.run(self.mf, self.opt, padded,
                                               self.gen, index)
            if self._early_stop and test is not None:
                not_chang += 1
                if epoch % 5 == 0:
                    r20 = self._recall_at_maxk(test)
                    if r20 > best20:
                        best20, not_chang = r20, 0
                    if not_chang > 5:
                        break

    def _train_spmf(self, pool_data: np.ndarray, test=None) -> None:
        """SPMF epochs over reservoir ∪ new data with rank-softmax draws;
        the early stop evaluates every epoch and breaks after 5 without a
        new best.

        The pool pads to the sweep-wide bound by repeating its last row
        with sampling weight zero, so the real draws are unchanged (pads
        rank after every real row; the boundary case ``u >= cdf[-1]``
        selects a pad, which is the last real row, as the unpadded clip
        would). ``n_batches`` stays the reference's ``round(N/B)``."""
        hist = np.concatenate(self._hist_pairs, axis=0)
        hist_index = build_period_index(hist, self.stream.info.n_items,
                                        min_rows=self._bounds["hist"],
                                        device=self.device)
        n_real = pool_data.shape[0]
        n_pad = -(-max(n_real, self._bounds["train"]) // 1024) * 1024
        pool_padded = np.concatenate(
            [pool_data[:, :2],
             np.repeat(pool_data[-1:, :2], n_pad - n_real, axis=0)], axis=0)
        pairs = torch.from_numpy(pool_padded.astype(np.int64)).to(self.device)
        valid = torch.arange(n_pad, device=self.device) < n_real
        n_batches = max(1, round(n_real / self.cfg.batch_size))
        key = ("spmf", shape_key(pairs, *hist_index))
        best20, not_chang = 0.0, 0
        for _ in range(self.cfg.epochs):
            with torch.no_grad():
                cdf = draw_cdf(
                    rank_sampling_probs(self.mf, pairs, valid, n_real))
            program = self._programs.get(key)
            if program is None:
                program = self._programs[key] = EpochProgram(
                    self._spmf_epoch, self.site, self.mf, self.opt,
                    (pairs, cdf), hist_index,
                    spmf_slots(n_pad, self.cfg.batch_size))
            self.mf, self.opt, _ = program.run_taken(
                self.mf, self.opt, (pairs, cdf), hist_index, n_batches,
                self.gen)
            if self._early_stop and test is not None:
                not_chang += 1
                r20 = self._recall_at_maxk(test)
                if r20 > best20:
                    best20, not_chang = r20, 0
                if not_chang >= 5:
                    break

    # ---------------------------------------------------------------- periods
    def warm_reservoir(self, period: int) -> None:
        """Seed the reservoir with the cumulative data before the first
        SPMF period (``base_train_not_train``)."""
        train, _ = self.stream.get_next(period, mode="not_only_new")
        if train is None:
            return
        self._hist_pairs.append(train)
        if self.cfg.pool_init_type == 1:
            self.reservoir.init_pool(train)
        else:
            self.reservoir.update(train)

    def run_one_period(self, period: int) -> bool:
        method = self.cfg.method
        mode = "not_only_new" if method == "full" else "only_new"
        train, test = self.stream.get_next(period, mode=mode)
        if train is None or test is None:
            return False
        t0 = time.time()
        self.test_counts.append(int(test.shape[0]))
        padded_test = self._pad_eval(test)   # one upload serves every eval

        if method == "spmf":
            self._hist_pairs.append(train)
            pool = (np.concatenate(
                [self.reservoir.pool[:self.reservoir.pool_have], train],
                axis=0) if self.reservoir.pool_have > 0 else train)
            self._train_spmf(pool, padded_test)
            self.reservoir.update(train)
        else:
            self._train_offline(train, padded_test)

        # the period's final metrics stay on the device until finalize()
        attr = self.evaluate_attributed(padded_test, deferred=True)
        if attr is not None:
            self._pending.append(("attr", method, period, attr[0], attr[1],
                                  time.time() - t0))
        else:
            sums = self._eval(self.mf, padded_test.rows, padded_test.mask)
            self._pending.append(("base", method, period, sums,
                                  max(padded_test.n_real, 1),
                                  time.time() - t0))
        return True

    def finalize(self) -> None:
        """Resolve the deferred per-period metrics into the ``recall`` /
        ``ndcg`` / attribution lists and the jsonl, in period order.
        Idempotent; called by :meth:`run`."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        for kind, method, period, out, n, secs in pending:
            extra = {}
            if kind == "attr":
                attributed = self._resolve_attr(out, n)
                metrics = attributed["base"]
                kx = max(self.cfg.topk)
                self.hit_new_user.append(
                    [attributed["hit_new_user"][k] for k in self.cfg.topk])
                self.hit_new_item.append(
                    [attributed["hit_new_item"][k] for k in self.cfg.topk])
                extra = {f"hit_new_user@{kx}": attributed["hit_new_user"][kx],
                         f"hit_new_item@{kx}": attributed["hit_new_item"][kx]}
            else:
                metrics = {k: (float(h) / n, float(nd) / n)
                           for k, (h, nd) in out.items()}
            self.recall.append([metrics[k][0] for k in self.cfg.topk])
            self.ndcg.append([metrics[k][1] for k in self.cfg.topk])
            self.logger.log(
                kind="baseline_test", method=method, period=period,
                seconds=secs,
                **{f"recall@{k}": metrics[k][0] for k in self.cfg.topk},
                **{f"ndcg@{k}": metrics[k][1] for k in self.cfg.topk},
                **extra)

    def run(self, max_periods: Optional[int] = None) -> Dict[str, float]:
        """Sequential sweep from ``start_period``; returns the weighted
        val/test averages (the baselines' protocol keeps the final
        period)."""
        if self.cfg.method == "spmf":
            self.warm_reservoir(self.cfg.start_period - 1)
        period = self.cfg.start_period
        done = 0
        while max_periods is None or done < max_periods:
            if not self.run_one_period(period):
                break
            period += 1
            done += 1
        self.finalize()
        out: Dict[str, float] = {}
        if self.test_counts:
            rec = np.asarray(self.recall)
            ndc = np.asarray(self.ndcg)
            counts = np.asarray(self.test_counts)
            for ki, k in enumerate(self.cfg.topk):
                v, t = weighted_period_average(rec[:, ki], counts,
                                               drop_last_test=False)
                out[f"val_recall@{k}"] = float(v)
                out[f"test_recall@{k}"] = float(t)
                v, t = weighted_period_average(ndc[:, ki], counts,
                                               drop_last_test=False)
                out[f"val_ndcg@{k}"] = float(v)
                out[f"test_ndcg@{k}"] = float(t)
        return out
