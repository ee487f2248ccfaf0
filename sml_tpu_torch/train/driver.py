"""The SML sequential-retraining driver (counterpart of
``sml_tpu/train/driver.py``).

Per period t:

1. snapshot ``last <- MF tables``;
2. fetch (set_t, set_tt, now_test, val) from the feeder;
3. branch A (warm-up), B (``tr_stop``) or C (test), each alternating
   ``multi_num`` phases of [inner MF epochs -> snapshot hat -> refresh ->
   (the test, at phase 0 of C) -> outer Θ epochs, each followed by a
   refresh];
4. a final refresh;

then the end-of-run weighted aggregation of the test periods. Records go
to the jsonl log in the JAX package's kinds and order. Under a
multi-process placement every rank runs the driver, its collectives in the
same order; the epochs' losses and the evaluations' sums are already the
whole world's, so :meth:`finalize` runs on every rank and every rank
reaches the same saddle-guard decisions. The caller gives the ranks other
than the main one a logger that writes nothing (as ``sml`` does). With
``cfg.attributed_eval`` and the dataset's new-entity id files, each test is
the attributed evaluation (its base sums make the ``test`` record) and adds
a ``test_attribution`` record; with ``cfg.profile_dir`` period
``cfg.profile_period`` is traced by ``torch.profiler``, with one span per
engine call (``refresh``, ``make_eval_set``, ``evaluate``,
``inner_epoch``, ``outer_epoch``, and for the fused programs
``period_step`` and ``phase_step``: a replay enters no per-epoch span).

The fused branches are the JAX package's (``cfg.fuse_phases``,
``cfg.fuse_period``): a fused period runs its phases through
``SMLEngine.period_step`` (on the card, CUDA-graph replays), branch A
whole, branch C after its unfused phase 0 (the test must score the
post-refresh tables before the outer epochs refresh them again); the
saddle guard replays its rule on the returned outer-loss stack, and the
in-program evals are logged as the records the unfused path logs, in its
order. ``fuse_period="auto"`` fuses on a CUDA engine and runs the unfused
path on the CPU and under a mesh (``SMLEngine.fused_program_warm``);
``True`` under a mesh raises. Every route gives the unfused path's
numbers, draws and records. One phase program serves the whole run (on
the card one capture, replayed in every period; the saddle retry's new
buffers and generator are copied into it); :meth:`SMLDriver.run` and
:meth:`SMLDriver.close` drop it.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from sml_tpu_torch.config import DataSpec, SMLConfig
from sml_tpu_torch.data.feeder import PeriodFeeder, StageData
from sml_tpu_torch.ops.batching import PaddedRows
from sml_tpu_torch.ops.metrics import weighted_period_average
from sml_tpu_torch.train.engine import (DIAG_NAMES, SMLEngine, SMLState,
                                        copy_state)
from sml_tpu_torch.utils.logging import MetricsLogger
from sml_tpu_torch.utils.profiling import annotate, maybe_trace


@dataclass
class RunReport:
    topks: tuple
    per_period: Dict[int, List[float]] = field(default_factory=dict)
    per_period_ndcg: Dict[int, List[float]] = field(default_factory=dict)
    test_counts: List[int] = field(default_factory=list)
    period_seconds: List[float] = field(default_factory=list)
    saddle_retries_used: int = 0

    def summary(self) -> Dict[str, float]:
        """Weighted val/test averages per K."""
        out: Dict[str, float] = {}
        counts = np.asarray(self.test_counts)
        if counts.size == 0:
            return out
        for k in self.topks:
            for name, arr in (("recall", self.per_period[k]),
                              ("ndcg", self.per_period_ndcg[k])):
                val, test = weighted_period_average(arr, counts)
                out[f"val_{name}@{k}"] = float(val)
                out[f"test_{name}@{k}"] = float(test)
        out["total_seconds"] = float(sum(self.period_seconds))
        return out

    def to_dict(self) -> Dict:
        """JSON-safe snapshot for a checkpoint's ``extra``: a resumed run
        reports over every test period, not only the resumed ones."""
        return {
            "topks": list(self.topks),
            "per_period": {str(k): v for k, v in self.per_period.items()},
            "per_period_ndcg": {str(k): v
                                for k, v in self.per_period_ndcg.items()},
            "test_counts": list(self.test_counts),
            "period_seconds": list(self.period_seconds),
            "saddle_retries_used": self.saddle_retries_used,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "RunReport":
        return cls(
            topks=tuple(d["topks"]),
            per_period={int(k): list(v)
                        for k, v in d["per_period"].items()},
            per_period_ndcg={int(k): list(v)
                             for k, v in d["per_period_ndcg"].items()},
            test_counts=list(d["test_counts"]),
            period_seconds=list(d["period_seconds"]),
            saddle_retries_used=int(d.get("saddle_retries_used", 0)))


class SMLDriver:
    def __init__(self, cfg: SMLConfig, spec: DataSpec,
                 engine: Optional[SMLEngine] = None,
                 logger: Optional[MetricsLogger] = None, device="cuda"):
        self.cfg = cfg
        self.feeder = PeriodFeeder(
            spec, mf_sample=cfg.mf_sample, tr_sample_type=cfg.tr_sample_type,
            tr_stop=cfg.tr_stop)
        if cfg.prefetch_periods:
            from sml_tpu_torch.data.prefetch import PrefetchingFeeder
            self.feeder = PrefetchingFeeder(self.feeder)
        self.engine = engine or SMLEngine(
            cfg, self.feeder.n_users, self.feeder.n_items, device=device)
        if cfg.uniform_shapes and not cfg.replay_mode:
            bounds = self.feeder.shape_bounds()
            if (cfg.mf_sample == "all"
                    and cfg.mf_batch_size == cfg.eval_batch_size):
                # 'all'-mode set_t IS an eval-format test file: one upload
                # serves both (SMLEngine.prep_inner)
                m = max(bounds["set_t"], bounds["eval"])
                bounds["set_t"] = bounds["eval"] = m
            self.engine.shape_targets = bounds
        # the prefetch worker pads and uploads period t+1's eval sets while
        # the device trains period t
        self._eval_cache: Dict[tuple, object] = {}
        if hasattr(self.feeder, "on_prefetch"):
            self.feeder.on_prefetch = self._preload_eval_sets
        self.logger = logger or MetricsLogger(None)
        self.report = RunReport(topks=tuple(cfg.topk))
        self._last_inner_loss = float("nan")
        self._last_outer_loss = float("nan")
        # reading the per-batch losses waits for the device: only when
        # something reads them (the saddle guard reads period 0's)
        self._track_losses = cfg.log_norms or cfg.saddle_retries > 0
        # in-training evals and the tests are run without reading their
        # sums back; they are resolved later in one pass, in order
        self._pending_evals: List[tuple] = []
        self._pending_evals_done: Optional[torch.cuda.Event] = None
        self._pending_tests: List[tuple] = []
        # hit attribution by entity freshness: 0/1 masks over the ids,
        # built once from the dataset's new-entity id files
        self._is_new_user = self._is_new_item = None
        self._pending_attr: List[tuple] = []
        if cfg.attributed_eval:
            ids = _load_new_entity_ids(spec.path)
            if ids is not None:
                self._is_new_user, self._is_new_item = \
                    self.engine.new_entity_masks(*ids)
        self._stop_stage = (cfg.multipass_stop_stage
                            if cfg.multipass_stop_stage is not None
                            else spec.online_test_start
                            - spec.online_train_start - 1)

    # ------------------------------------------------------------------ phases
    def _inner_block(self, state: SMLState, prep, epochs: int,
                     val) -> SMLState:
        """``MF_train_onestage``; ``prep`` is the period's ``prep_inner``
        result, built once per period."""
        padded, index = prep
        for e in range(epochs):
            with annotate("inner_epoch"):
                state, losses = self.engine.inner_epoch(state, padded, index)
            if self._track_losses:
                self._last_inner_loss = _mean_loss(
                    losses, padded.n_real, self.cfg.mf_batch_size)
            if self.cfg.eval_during_inner and val is not None:
                self._defer_eval("inner_eval", e, state, val)
        return state

    def _outer_block(self, state: SMLState, prep, val) -> SMLState:
        """``transfer_train_onestage``, with the refresh after each outer
        epoch."""
        padded, index = prep
        for e in range(self.cfg.tr_epochs):
            with annotate("outer_epoch"):
                state, losses = self.engine.outer_epoch(state, padded, index)
            if self._track_losses:
                self._last_outer_loss = _mean_loss(
                    losses, padded.n_real, self.cfg.tr_batch_size)
            if self.cfg.refresh_after_outer_epoch:
                state = self._refresh(state)
                if self.cfg.eval_during_outer and val is not None:
                    self._defer_eval("outer_eval", e, state, val)
        if self.cfg.load_w_hat:
            state = self.engine.load_hat_into_mf(state)
        return state

    def _refresh(self, state: SMLState) -> SMLState:
        with annotate("refresh"):
            return self.engine.refresh(state)

    def _make_eval_set(self, rows: np.ndarray):
        with annotate("make_eval_set"):
            return self.engine.make_eval_set(rows, build_mask=True)

    def _defer_eval(self, kind: str, epoch: int, state: SMLState,
                    val) -> None:
        with annotate("evaluate"):
            sums = self.engine.evaluate_deferred(state.mf, val)
        self._defer(kind, epoch, sums)

    def _defer(self, kind: str, epoch: int, payload) -> None:
        """Queue an eval's device sums (or a fused period's stacked ones)
        for :meth:`_flush_evals`, marking where its work ends."""
        self._pending_evals.append((kind, epoch, payload))
        if self.engine.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            self._pending_evals_done = ev

    def _fusion(self) -> bool:
        """Whether the fused programs may run: ``fuse_phases``, and
        ``fuse_period`` True, False (phases may still fuse one by one) or
        "auto" (the engine's route). Under a mesh only "auto" and False
        are taken, both unfused; True raises."""
        cfg = self.cfg
        if not cfg.fuse_phases:
            return False
        if isinstance(cfg.fuse_period, str):
            return self.engine.fused_program_warm()
        if self.engine.mesh is not None:
            if cfg.fuse_period:
                raise ValueError(
                    "fuse_period=True needs the fused period under a mesh, "
                    "which the port does not have yet (gloo's collectives "
                    "cannot be captured; ROADMAP §2, fused periods over "
                    "NCCL): use fuse_period='auto' or False")
            return False
        return True

    def _can_fuse(self, val) -> bool:
        """One fused program per phase, unless in-training evals need the
        intermediate states."""
        return self._fusion() and not (
            val is not None and (self.cfg.eval_during_inner
                                 or self.cfg.eval_during_outer))

    def _can_fuse_period(self, prep_tt) -> bool:
        """One fused program per period (``SMLEngine.period_step``):
        in-training evals and diagnostics ride inside it."""
        return bool(self._fusion() and self.cfg.fuse_period
                    and prep_tt is not None)

    def _fused_period(self, state: SMLState, prep_t, prep_tt, val,
                      n_phases: int, d_time: int = 0, start_phase: int = 0,
                      guard: bool = False):
        """``n_phases`` phases through ``SMLEngine.period_step``; any
        in-program eval sums are deferred as one ``"__stacked__"`` entry,
        expanded by :meth:`_flush_evals` into the unfused path's records.
        With ``log_norms`` the phase records come from the stacked losses
        and norms; ``guard`` replays the saddle rule on the outer-loss
        stack, and a stalled attempt keeps the records of the phases the
        unfused guard would have run. Returns ``(state, stalled)``."""
        ev = val if isinstance(val, PaddedRows) else None
        with annotate("period_step"):
            state, evals, (ils, ols), diags = self.engine.period_step(
                state, prep_t, prep_tt, n_phases, ev, self.cfg.log_norms)
        stalled, keep = False, n_phases
        if guard or self._track_losses:
            ils, ols, diags = self.engine.fetch_host((ils, ols, diags))
            inner_mean = [_mean_loss(ils[p], prep_t[0].n_real,
                                     self.cfg.mf_batch_size)
                          for p in range(n_phases)]
            outer_mean = [_mean_loss(ols[p], prep_tt[0].n_real,
                                     self.cfg.tr_batch_size)
                          for p in range(n_phases)]
            if guard:
                check_phase, stalled_at = self._saddle_rule()
                for phase in dict.fromkeys(
                        (check_phase, self.cfg.multi_num - 1)):
                    if phase < n_phases and stalled_at(phase,
                                                       outer_mean[phase]):
                        stalled, keep = True, phase + 1
                        break
            self._last_inner_loss = inner_mean[keep - 1]
            self._last_outer_loss = outer_mean[keep - 1]
            if self.cfg.log_norms:
                for p in range(keep):
                    self.logger.log(
                        kind="phase", d_time=d_time, phase=start_phase + p,
                        inner_loss=inner_mean[p], outer_loss=outer_mean[p],
                        **{nm: float(diags[i][p])
                           for i, nm in enumerate(DIAG_NAMES)},
                        **self.engine.sampler_stats)
        if evals:
            self._defer("__stacked__", 0, (evals, max(ev.n_real, 1), keep))
        return state, stalled

    def _one_phase(self, state: SMLState, prep_t, prep_tt, val) -> SMLState:
        """One SML phase: inner epochs -> hat snapshot -> refresh -> outer
        epochs; one fused program (``SMLEngine.phase_step``) when it can
        fuse."""
        if self._can_fuse(val):
            with annotate("phase_step"):
                state, il, ol = self.engine.phase_step(state, prep_t,
                                                       prep_tt)
            if self._track_losses:
                self._last_inner_loss = _mean_loss(
                    il, prep_t[0].n_real, self.cfg.mf_batch_size)
                self._last_outer_loss = _mean_loss(
                    ol, prep_tt[0].n_real, self.cfg.tr_batch_size)
            return state
        state = self._inner_block(state, prep_t, self.cfg.mf_epochs, val)
        state = self.engine.snapshot_hat(state)
        state = self._refresh(state)
        return self._outer_block(state, prep_tt, val)

    def _saddle_rule(self):
        """``(check_phase, stalled_at)`` for the period-0 guard."""
        saddle = 2.0 * float(np.log(2.0))
        multi = self.cfg.multi_num
        if self.cfg.saddle_mode == "auto":
            # stall iff (saddle - L) / saddle < tau * (phase+1) / multi_num
            check_phase = min(max(1, round(0.3 * multi)), multi - 1)

            def stalled_at(phase, loss):
                escape = (saddle - loss) / saddle
                return escape < self.cfg.saddle_tau * (phase + 1) / multi
        else:
            thresh = self.cfg.saddle_frac * saddle
            final_thresh = self.cfg.saddle_final_frac * saddle
            check_phase = min(self.cfg.saddle_check_phase, multi - 1)

            def stalled_at(phase, loss):
                return ((phase == check_phase and loss > thresh)
                        or (phase == multi - 1 and loss > final_thresh))
        return check_phase, stalled_at

    def _warmup_phases(self, state: SMLState, prep_t, prep_tt, val,
                       d_time: int, guard: bool):
        """Branch-A phases. With ``guard``, abort when the outer loss is
        still near the zero-score BCE saddle (2 ln 2) at the check phase
        or the last phase."""
        multi = self.cfg.multi_num
        check_phase, stalled_at = self._saddle_rule()
        for phase in range(multi):
            state = self._one_phase(state, prep_t, prep_tt, val)
            self._log_phase(state, d_time, phase)
            if guard and phase in (check_phase, multi - 1) \
                    and stalled_at(phase, self._last_outer_loss):
                return state, True
        return state, False

    def _log_phase(self, state: SMLState, d_time: int, phase: int) -> None:
        if not self.cfg.log_norms:
            return
        self.logger.log(kind="phase", d_time=d_time, phase=phase,
                        inner_loss=self._last_inner_loss,
                        outer_loss=self._last_outer_loss,
                        **self.engine.diagnostics(state),
                        **self.engine.sampler_stats)

    def _flush_evals(self, force: bool = True) -> None:
        """Resolve the pending in-training evals and log them in dispatch
        order. With ``force=False`` (at a period's end) nothing happens
        until the newest one's work has finished on the card; the records
        and their order are the same either way."""
        if not self._pending_evals:
            return
        done = self._pending_evals_done
        if not force and done is not None and not done.query():
            return
        pending, self._pending_evals = self._pending_evals, []
        self._pending_evals_done = None
        metrics = self.engine.resolve_evals(
            [d for kind, _, d in pending if kind != "__stacked__"])
        stacked = self.engine.resolve_stacked_evals(
            [d for kind, _, d in pending if kind == "__stacked__"])
        it, it_s = iter(metrics), iter(stacked)
        for kind, epoch, _ in pending:
            if kind == "__stacked__":
                # a fused period's in-program evals: the unfused path's
                # per-epoch records, in its order
                for k2, e2, m2 in next(it_s):
                    self.logger.log(kind=k2, epoch=e2, **_flatten(m2))
            else:
                self.logger.log(kind=kind, epoch=epoch, **_flatten(next(it)))

    def _drain_tests(self) -> None:
        """Resolve the deferred per-period tests, in period order, into the
        report and the log."""
        if not self._pending_tests:
            return
        pending, self._pending_tests = self._pending_tests, []
        metrics = self.engine.resolve_evals([d for _, _, d in pending])
        for (period, n, _), m in zip(pending, metrics):
            self.report.test_counts.append(n)
            for k, mm in m.items():
                self.report.per_period.setdefault(k, []).append(mm["recall"])
                self.report.per_period_ndcg.setdefault(
                    k, []).append(mm["ndcg"])
            self.logger.log(kind="test", period=period, n_test=n,
                            **_flatten(m))
        if self._pending_attr:
            pend, self._pending_attr = self._pending_attr, []
            attrs = self.engine.resolve_attributed([d for _, d in pend])
            for (period, _), rec in zip(pend, attrs):
                self.logger.log(kind="test_attribution", period=period,
                                **rec)

    def finalize(self) -> None:
        """Drain every deferred eval and test into the report and the log.
        :meth:`run` calls it; callers of :meth:`run_period` call it before
        reading ``report``."""
        self._flush_evals()
        self._drain_tests()

    def _preload_eval_sets(self, d_time: int, sd: StageData) -> None:
        """Prefetch-worker hook: upload the period's eval sets early (the
        worker thread starts on device 0, so it selects the engine's)."""
        dev = self.engine.device
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            if sd.now_test is not None:
                self._eval_cache[(d_time, "test")] = \
                    self._make_eval_set(sd.now_test)
            if (sd.val is not None and sd.val is not sd.now_test
                    and (self.cfg.eval_during_inner
                         or self.cfg.eval_during_outer)):
                self._eval_cache[(d_time, "val")] = \
                    self._make_eval_set(sd.val)

    def _record_test(self, state: SMLState, now_test: np.ndarray,
                     period: int) -> None:
        padded = self._eval_cache.pop((period, "test"), None)
        if padded is None:
            padded = self._make_eval_set(now_test)
        n_real = int(now_test.shape[0])
        if self._is_new_user is not None:
            # the attributed evaluation's base sums are the test's: no
            # second scoring pass
            with annotate("evaluate"):
                attr, n = self.engine.evaluate_attributed_deferred(
                    state.mf, padded, self._is_new_user, self._is_new_item)
            self._pending_tests.append((period, n_real, (attr["base"], n)))
            self._pending_attr.append((period, (attr, n)))
        else:
            with annotate("evaluate"):
                sums = self.engine.evaluate_deferred(state.mf, padded)
            self._pending_tests.append((period, n_real, sums))

    # ----------------------------------------------------------------- periods
    def run_period(self, state: SMLState, d_time: int):
        """One period; returns ``(state, still_running)``. Period
        ``cfg.profile_period`` is traced into ``cfg.profile_dir``."""
        trace_dir = (self.cfg.profile_dir
                     if d_time == self.cfg.profile_period else None)
        with maybe_trace(trace_dir, self.engine.device):
            return self._run_period(state, d_time)

    def _run_period(self, state: SMLState, d_time: int):
        t0 = time.time()
        self._track_losses = self.cfg.log_norms or (
            d_time == 0 and self.cfg.saddle_retries > 0)
        state = self.engine.snapshot_last(state)
        sd: StageData = self.feeder.next_train(d_time)
        if sd.set_t is None:
            return state, False
        val = sd.val
        if val is not None and (self.cfg.eval_during_inner
                                or self.cfg.eval_during_outer):
            cached = self._eval_cache.pop((d_time, "val"), None)
            val = cached if cached is not None else self._make_eval_set(val)
        sd = sd._replace(val=val)

        prep_t = self.engine.prep_inner(sd.set_t)
        prep_tt = (self.engine.prep_outer(sd.set_tt)
                   if sd.set_tt is not None else None)

        if sd.now_test is None:
            # branch A: warm-up, with the optional first-period saddle guard
            budget = self.cfg.saddle_retries if d_time == 0 else 0
            fused = self._can_fuse_period(prep_tt)
            state0 = copy_state(state) if budget > 0 else None
            attempt = 0
            while True:
                if fused:
                    state, stalled = self._fused_period(
                        state, prep_t, prep_tt, sd.val, self.cfg.multi_num,
                        d_time, guard=attempt < budget)
                else:
                    state, stalled = self._warmup_phases(
                        state, prep_t, prep_tt, sd.val, d_time,
                        guard=attempt < budget)
                if not stalled:
                    break
                attempt += 1
                self.report.saddle_retries_used += 1
                self._flush_evals()   # the aborted attempt's eval rows
                escalate = (attempt == budget
                            and self.cfg.saddle_escalate_warmstart)
                self.logger.log(kind="saddle_retry", d_time=d_time,
                                attempt=attempt, mode=self.cfg.saddle_mode,
                                escalated=escalate,
                                outer_loss=self._last_outer_loss)
                # re-roll the (Θ init, data stream) pair
                restart = copy_state(state0)
                restart = restart._replace(
                    gen=self.engine.fold_generator(state0.gen, attempt))
                state = self.engine.reinit_theta(restart, salt=attempt,
                                                 warmstart=escalate)
            state = self._refresh(state)
        elif sd.set_tt is None:
            # branch B: tr_stop during the test span
            state = self._inner_block(state, prep_t,
                                      self.cfg.mf_epochs_when_tr_stopped,
                                      sd.val)
            state = self.engine.snapshot_hat(state)
            state = self._refresh(state)
            self._record_test(state, sd.now_test, d_time)
        else:
            # branch C: test and keep training Θ. The test scores the
            # post-refresh tables of phase 0 BEFORE its outer epochs
            # refresh them again.
            state = self._inner_block(state, prep_t, self.cfg.mf_epochs,
                                      sd.val)
            state = self.engine.snapshot_hat(state)
            state = self._refresh(state)
            self._record_test(state, sd.now_test, d_time)
            state = self._outer_block(state, prep_tt, sd.val)
            self._log_phase(state, d_time, 0)
            rest = self.cfg.multi_num - 1
            if rest > 0 and self._can_fuse_period(prep_tt):
                state, _ = self._fused_period(state, prep_t, prep_tt,
                                              sd.val, rest, d_time,
                                              start_phase=1)
            else:
                for phase in range(1, self.cfg.multi_num):
                    state = self._one_phase(state, prep_t, prep_tt, sd.val)
                    self._log_phase(state, d_time, phase)
            state = self._refresh(state)

        self._flush_evals(force=False)
        dt = time.time() - t0
        self.report.period_seconds.append(dt)
        self.logger.log(kind="period", d_time=d_time, seconds=dt)
        return state, True

    def run(self, state: Optional[SMLState] = None,
            max_periods: Optional[int] = None,
            start_pass: int = 0, start_period: int = 0,
            on_period_end=None) -> RunReport:
        """The full sweep. With ``pass_num > 1`` the warm-up span is
        replayed: non-final passes stop at ``multipass_stop_stage``; only
        the final pass runs the test span. ``start_pass``/``start_period``
        resume mid-sweep (skipped periods only advance the feeder's test
        cursor); ``on_period_end(state, pass_id, d_time, driver)`` fires
        after every trained period."""
        if state is None:
            state = self.engine.init_state()
        for pass_id in range(start_pass, self.cfg.pass_num):
            final_pass = pass_id == self.cfg.pass_num - 1
            self.feeder.reinit()
            self._eval_cache.clear()
            d_time = 0
            while max_periods is None or d_time < max_periods:
                if pass_id == start_pass and d_time < start_period:
                    self.feeder.next_train(d_time)   # advance test cursor
                    self._eval_cache.pop((d_time, "test"), None)
                    self._eval_cache.pop((d_time, "val"), None)
                else:
                    state, ok = self.run_period(state, d_time)
                    if not ok:
                        break
                    if on_period_end is not None:
                        on_period_end(state, pass_id, d_time, self)
                d_time += 1
                if not final_pass and d_time >= self._stop_stage:
                    break
        self.final_state = state
        self.engine.release_programs()
        self.finalize()
        self.logger.log(kind="summary", **self.report.summary())
        return self.report

    def close(self) -> None:
        """Drop the engine's phase programs and stop the prefetch worker."""
        self.engine.release_programs()
        if hasattr(self.feeder, "close"):
            self.feeder.close()


def _mean_loss(losses, n_real: int, batch_size: int) -> float:
    """Mean per-batch loss over the REAL batches of an epoch (the skipped
    tail reports 0 and is excluded). Under a mesh each batch's loss is the
    whole batch's (summed over 'data' by the epoch), so every rank reads
    the global mean."""
    nb = max(-(-n_real // batch_size), 1)
    if isinstance(losses, torch.Tensor):
        losses = losses.detach().cpu().numpy()
    return float(np.asarray(losses)[:nb].mean())


def _flatten(metrics: Dict[int, Dict[str, float]]) -> Dict[str, float]:
    return {f"{name}@{k}": v for k, m in metrics.items()
            for name, v in m.items()}


def _load_new_entity_ids(path: str):
    """``test_new_user.npy`` / ``test_new_item.npy`` of the dataset, or
    None when either is absent (no attribution is made then)."""
    try:
        nu = np.load(f"{path}/test_new_user.npy").astype(np.int64)
        ni = np.load(f"{path}/test_new_item.npy").astype(np.int64)
    except FileNotFoundError:
        return None
    return nu, ni
