"""On-disk dataset format (numpy copy of ``sml_tpu/data/formats.py``).

* ``<path>/information.npy``: ``[n_interactions, n_users, n_items]``
* ``<path>/train/<p>.npy``:   ``(N, 2)`` int rows ``[user, item]``
* ``<path>/test/<p>.npy``:    ``(M, 2 + neg)`` int rows ``[user, pos, negs...]``
* optional ``<path>/test_new_user.npy`` / ``test_new_item.npy``

Plain ``.npy`` files, so one dataset serves both packages.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class DatasetInfo:
    n_interactions: int
    n_users: int
    n_items: int


def load_info(path: str) -> DatasetInfo:
    info = np.load(os.path.join(path, "information.npy"))
    return DatasetInfo(int(info[0]), int(info[1]), int(info[2]))


def load_train(path: str, period: int) -> np.ndarray:
    """Load one period's raw interactions ``(N, 2)``."""
    a = np.load(os.path.join(path, "train", f"{period}.npy"))
    return np.asarray(a, dtype=np.int64)


def row_count(path: str, kind: str, period: int) -> Optional[int]:
    """Row count of ``<path>/<kind>/<period>.npy`` from the npy header
    alone (no data read): the sweep-wide shape scan behind uniform
    padding."""
    f = os.path.join(path, kind, f"{period}.npy")
    if not os.path.exists(f):
        return None
    with open(f, "rb") as fh:
        version = np.lib.format.read_magic(fh)
        reader = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                  else np.lib.format.read_array_header_2_0)
        shape, _, _ = reader(fh)
    return int(shape[0])


def load_test(path: str, period: int) -> Optional[np.ndarray]:
    """Load one period's eval rows ``(M, 2 + neg)``; None if absent."""
    f = os.path.join(path, "test", f"{period}.npy")
    if not os.path.exists(f):
        return None
    return np.asarray(np.load(f), dtype=np.int64)


def write_dataset(path: str,
                  train_periods: Sequence[np.ndarray],
                  test_periods: Dict[int, np.ndarray],
                  info: DatasetInfo,
                  new_user_ids: Optional[np.ndarray] = None,
                  new_item_ids: Optional[np.ndarray] = None) -> None:
    """Write a dataset in the reference layout."""
    os.makedirs(os.path.join(path, "train"), exist_ok=True)
    os.makedirs(os.path.join(path, "test"), exist_ok=True)
    np.save(os.path.join(path, "information.npy"),
            np.array([info.n_interactions, info.n_users, info.n_items],
                     dtype=np.int64))
    for p, arr in enumerate(train_periods):
        np.save(os.path.join(path, "train", f"{p}.npy"),
                np.asarray(arr, dtype=np.int64))
    for p, arr in test_periods.items():
        np.save(os.path.join(path, "test", f"{p}.npy"),
                np.asarray(arr, dtype=np.int64))
    if new_user_ids is not None:
        np.save(os.path.join(path, "test_new_user.npy"),
                np.asarray(new_user_ids, dtype=np.int64))
    if new_item_ids is not None:
        np.save(os.path.join(path, "test_new_item.npy"),
                np.asarray(new_item_ids, dtype=np.int64))


def attach_negatives(interactions: np.ndarray, history: np.ndarray,
                     catalog: np.ndarray, neg_num: int,
                     seed: int = 0) -> np.ndarray:
    """Attach ``neg_num`` distinct negatives to each ``[user, item]`` row:
    drawn from the seen-item ``catalog``, excluding the user's whole
    ``history`` (all known (u, i) pairs), distinct within a row. The rows
    come from the native sampler (:mod:`sml_tpu_torch.data.native`), as in
    the JAX package, so both packages give the same rows for the same
    inputs and seed."""
    from sml_tpu_torch.data.native import build_eval_rows_native
    return build_eval_rows_native(interactions, history, catalog, neg_num,
                                  seed=seed)
