"""Locked merge-one-key-into-a-results-JSON helper (counterpart of
``sml_tpu/utils/results.py``).

Measurement scripts (``scripts/scale_engine_run.py --out``) may run as
concurrent processes that add their results to one shared JSON file; an
unlocked read-modify-write would silently drop a process's key. The file
is written as the JAX package writes it, so either package's scripts can
add to the other's results.
"""

from __future__ import annotations

import fcntl
import json
import os


def record(path: str, key: str, value) -> None:
    """Merge ``{key: value}`` into the JSON object at ``path`` under an
    exclusive flock and replace the file atomically."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    lock_path = path + ".lock"
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        data = {}
        if os.path.exists(path):
            with open(path) as fh:
                data = json.load(fh)
        data[key] = value
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(data, fh, indent=2)
        os.replace(tmp, path)
