"""Raw interaction-log ingestion -> the period-file dataset contract
(counterpart of ``sml_tpu/data/ingest.py``; the same files for the same
log and spec).

The path from a raw log to a ready-to-train dataset directory:

1. read ``(user, item, timestamp)`` events (CSV or arrays),
2. densify ids in first-appearance order (so id < table capacity always
   holds and tables can be pre-allocated, matching ``information.npy``),
3. split into periods by equal-count quantiles or fixed time windows,
4. attach sampled negatives to every test-span interaction
   (``attach_negatives``, the native sampler),
5. emit ``information.npy``, ``train/<p>.npy``, ``test/<p>.npy`` and the
   new-entity id files used by hit attribution.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from sml_tpu_torch.data.formats import (DatasetInfo, attach_negatives,
                                        write_dataset)


@dataclass(frozen=True)
class IngestSpec:
    n_periods: int
    first_test_period: int
    neg_num: int = 999
    # 'count' = equal interactions per period; 'time' = equal time windows
    split: str = "count"
    seed: int = 0


def densify_ids(values: np.ndarray) -> tuple:
    """Map raw ids to dense 0..K-1 in first-appearance order.

    Fully vectorized (no per-value Python): ``np.unique`` gives each value's
    slot in sorted-unique space plus the first-occurrence position; ranking
    those positions converts sorted order to first-appearance order.
    """
    uniq, first_pos, inverse = np.unique(values, return_index=True,
                                         return_inverse=True)
    rank = np.argsort(first_pos, kind="stable")
    order = uniq[rank]
    new_id = np.empty(uniq.shape[0], dtype=np.int64)
    new_id[rank] = np.arange(uniq.shape[0])
    return new_id[inverse], order


def ingest_events(users: np.ndarray, items: np.ndarray,
                  timestamps: np.ndarray, out_path: str,
                  spec: IngestSpec) -> DatasetInfo:
    """Build a dataset directory from raw events; returns its info."""
    order = np.argsort(timestamps, kind="stable")
    users = np.asarray(users)[order]
    items = np.asarray(items)[order]
    timestamps = np.asarray(timestamps)[order]

    dense_u, user_vocab = densify_ids(users)
    dense_i, item_vocab = densify_ids(items)
    n = dense_u.shape[0]

    if spec.split == "count":
        bounds = np.linspace(0, n, spec.n_periods + 1).astype(np.int64)
        period_of = np.zeros(n, dtype=np.int64)
        for p in range(spec.n_periods):
            period_of[bounds[p]:bounds[p + 1]] = p
    elif spec.split == "time":
        lo, hi = timestamps[0], timestamps[-1]
        edges = np.linspace(lo, hi, spec.n_periods + 1)
        period_of = np.clip(np.searchsorted(edges, timestamps, side="right")
                            - 1, 0, spec.n_periods - 1)
    else:
        raise ValueError(f"unknown split {spec.split!r}")

    periods = []
    for p in range(spec.n_periods):
        m = period_of == p
        periods.append(np.stack([dense_u[m], dense_i[m]], axis=1))

    test_files = {}
    for p in range(spec.first_test_period, spec.n_periods):
        hist = np.concatenate(periods[:p + 1], axis=0)
        catalog = np.unique(hist[:, 1])
        test_files[p] = attach_negatives(periods[p], hist, catalog,
                                         spec.neg_num,
                                         seed=spec.seed * 1000 + p)

    # "New" entities = first appearance falls inside the test span. Dense ids
    # are first-appearance ordered, so the first event of dense id k is the
    # k-th entry of unique's return_index over the dense stream.
    def new_ids(dense):
        first_idx = np.unique(dense, return_index=True)[1]
        return np.flatnonzero(period_of[first_idx] >= spec.first_test_period)

    info = DatasetInfo(n_interactions=n, n_users=int(user_vocab.shape[0]),
                       n_items=int(item_vocab.shape[0]))
    write_dataset(out_path, periods, test_files, info,
                  new_user_ids=new_ids(dense_u).astype(np.int64),
                  new_item_ids=new_ids(dense_i).astype(np.int64))
    np.save(os.path.join(out_path, "user_vocab.npy"), user_vocab)
    np.save(os.path.join(out_path, "item_vocab.npy"), item_vocab)
    return info


def ingest_csv(csv_path: str, out_path: str, spec: IngestSpec,
               user_col: int = 0, item_col: int = 1, time_col: int = 2,
               delimiter: str = ",", skip_header: int = 1) -> DatasetInfo:
    """Ingest a CSV log with (user, item, timestamp) columns.

    A one-character delimiter goes through the native C++ log parser (which
    raises on a malformed line); any other delimiter through
    ``np.genfromtxt``, as in the JAX package.
    """
    from sml_tpu_torch.data.native import parse_csv_log_native
    parsed = parse_csv_log_native(csv_path, user_col=user_col,
                                  item_col=item_col, time_col=time_col,
                                  delimiter=delimiter,
                                  skip_header=skip_header)
    if parsed is not None:
        users, items, times = parsed
        return ingest_events(users, items, times, out_path, spec)
    raw = np.genfromtxt(csv_path, delimiter=delimiter,
                        skip_header=skip_header)
    if raw.ndim == 1:
        raw = raw.reshape(1, -1)
    return ingest_events(raw[:, user_col].astype(np.int64),
                         raw[:, item_col].astype(np.int64),
                         raw[:, time_col], out_path, spec)
