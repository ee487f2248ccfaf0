"""Stage-wise data feeder (numpy copy of ``sml_tpu/data/feeder.py``).

``PeriodFeeder`` serves the reference's three regimes, with
``t = online_train_start + d_time``:

regime A (warm-up, before online test): ``(set_t, set_tt, None, val)``
regime B (``tr_stop`` during the test span): ``(set_t, None, now_test, val)``
regime C (test periods, the default):     ``(set_t, set_tt, now_test, val)``

* ``set_t``: period-t pool for the inner step. ``mf_sample='all'`` reads the
  presampled eval-format ``test/t`` rows, ``'alone'`` the raw ``train/t``
  rows.
* ``set_tt``: the period-(t+1) pool for the outer step, chosen by
  ``tr_sample_type`` the same way.
* ``now_test``: ``test/<online_test_start + k>``, k = test periods served.
* ``val``: ``test/(t+1)``, for metric-only evals.

``StreamingPeriods`` serves the baselines and the pretrainer.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from sml_tpu_torch.config import DataSpec
from sml_tpu_torch.data.formats import (DatasetInfo, load_info, load_test,
                                        load_train, row_count)


class StageData(NamedTuple):
    set_t: Optional[np.ndarray]      # inner-training pool for period t
    set_tt: Optional[np.ndarray]     # outer-training pool for period t+1
    now_test: Optional[np.ndarray]   # eval rows of the current test period
    val: Optional[np.ndarray]        # metric-only validation rows


class PeriodFeeder:
    def __init__(self, spec: DataSpec, mf_sample: str = "all",
                 tr_sample_type: str = "alone", tr_stop: bool = False):
        self.spec = spec
        self.mf_sample = mf_sample
        self.tr_sample_type = tr_sample_type
        self.tr_stop = tr_stop
        self.info: DatasetInfo = load_info(spec.path)
        self.test_count = 0

    @property
    def n_users(self) -> int:
        return self.info.n_users

    @property
    def n_items(self) -> int:
        return self.info.n_items

    def reinit(self) -> None:
        """Reset the test cursor (multi-pass runs)."""
        self.test_count = 0

    def shape_bounds(self) -> dict:
        """Sweep-wide maximum row counts per stream, from npy headers only:
        the padding floors that give every period of a stream one shape."""
        p = self.spec.path
        first = self.spec.online_train_start
        last = self.spec.num_periods - 1

        def src(sample: str) -> str:
            return "train" if sample == "alone" else "test"

        def max_rows(kind: str, periods) -> int:
            counts = [row_count(p, kind, t) for t in periods]
            return max((c for c in counts if c is not None), default=0)

        set_t_max = max_rows(src(self.mf_sample), range(first, last))
        set_tt_max = max_rows(src(self.tr_sample_type),
                              range(first + 1, last + 1))
        eval_max = max_rows("test", range(first, last + 1))
        return {"set_t": set_t_max, "set_tt": set_tt_max, "eval": eval_max}

    def _pool(self, period: int, sample: str) -> np.ndarray:
        if sample == "alone":
            return load_train(self.spec.path, period)
        if sample == "all":
            rows = load_test(self.spec.path, period)
            if rows is None:
                raise FileNotFoundError(
                    f"mf_sample='all' needs presampled test/{period}.npy")
            return rows
        raise ValueError(f"unknown sample type {sample!r}")

    def next_train(self, d_time: int) -> StageData:
        t = self.spec.online_train_start + d_time
        if t + 1 >= self.spec.num_periods:
            return StageData(None, None, None, None)

        set_t = self._pool(t, self.mf_sample)

        if t + 1 < self.spec.online_test_start:           # regime A
            set_tt = self._pool(t + 1, self.tr_sample_type)
            val = load_test(self.spec.path, t + 1)
            return StageData(set_t, set_tt, None, val)

        if self.tr_stop:                                   # regime B
            now_test = load_test(
                self.spec.path, self.spec.online_test_start + self.test_count)
            self.test_count += 1
            return StageData(set_t, None, now_test, now_test)

        set_tt = self._pool(t + 1, self.tr_sample_type)   # regime C
        val = load_test(self.spec.path, t + 1)
        now_test = load_test(
            self.spec.path, self.spec.online_test_start + self.test_count)
        self.test_count += 1
        return StageData(set_t, set_tt, now_test, val)


class StreamingPeriods:
    """Baseline feeder: ``get_next(p, mode)`` -> (train_pool, test_rows).

    ``mode='not_only_new'`` concatenates ``train/0..p-1`` (full retrain);
    ``'only_new'`` returns just ``train/(p-1)`` (fine-tune). Returns
    ``(None, None)`` past the end. ``test_new_user``/``test_new_item`` hold
    the dataset's new-entity ids (empty when it ships none)."""

    def __init__(self, spec: DataSpec):
        self.spec = spec
        self.info = load_info(spec.path)
        p = spec.path
        try:
            self.test_new_user = np.load(
                f"{p}/test_new_user.npy").astype(np.int64)
            self.test_new_item = np.load(
                f"{p}/test_new_item.npy").astype(np.int64)
        except FileNotFoundError:
            self.test_new_user = np.zeros(0, dtype=np.int64)
            self.test_new_item = np.zeros(0, dtype=np.int64)

    def get_next(self, period: int, mode: str = "not_only_new"):
        try:
            if mode == "not_only_new":
                parts = [load_train(self.spec.path, i) for i in range(period)]
                if not parts:
                    return None, None
                train = np.concatenate(parts, axis=0)
            else:
                train = load_train(self.spec.path, period - 1)
        except FileNotFoundError:
            return None, None
        test = load_test(self.spec.path, period)
        if test is None:
            return None, None
        return train, test
