"""Period-boundary checkpoints in the JAX package's framework-free layout
(counterpart of ``sml_tpu/utils/checkpoint.py``).

One ``ckpt_<step>.npz`` per checkpoint plus ``manifest.json`` naming the
latest, both written atomically (tmp + rename). Leaves are keyed by path:
``mf/user_emb``, ``theta/user/fc1_w``, ``last_user``, ``hat_item``, …;
bfloat16 leaves are stored as their uint16 bits, with the true dtype names
recorded under ``__dtypes__``. So a checkpoint that ``sml_tpu`` wrote loads
here (:func:`state_from_checkpoint`), and the port writes the same keys.

The port's state holds the serving leaves (tables, Θ, snapshots); the
optimizer states and the PRNG key that ``sml_tpu`` also stores are read by
the training slice.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from sml_tpu_torch.device import resolve_device
from sml_tpu_torch.models.mf import MFParams
from sml_tpu_torch.models.transfer import TOWER_FIELDS, theta_from_numpy
from sml_tpu_torch.train.engine import SMLState

SNAPSHOTS = ("last_user", "last_item", "hat_user", "hat_item")


def flatten_state(state: SMLState) -> Dict[str, torch.Tensor]:
    """``{path: tensor}`` under the JAX package's key names."""
    flat = {f"mf/{f}": getattr(state.mf, f) for f in MFParams._fields}
    for side in ("user", "item"):
        tower = getattr(state.theta, side)
        for f in TOWER_FIELDS:
            flat[f"theta/{side}/{f}"] = getattr(tower, f).detach()
    for f in SNAPSHOTS:
        flat[f] = getattr(state, f)
    return flat


def _to_numpy(t: torch.Tensor):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), None


def _to_tensor(arr: np.ndarray, dtype_name: Optional[str]) -> torch.Tensor:
    if dtype_name is None:
        return torch.from_numpy(np.ascontiguousarray(arr))
    if dtype_name != "bfloat16":
        raise ValueError(f"unsupported stored dtype {dtype_name!r}")
    bits = np.ascontiguousarray(arr).view(np.int16)
    return torch.from_numpy(bits).view(torch.bfloat16)


def save_checkpoint(directory: str, step: int, state: SMLState,
                    extra: Optional[Dict[str, Any]] = None,
                    keep: int = 3) -> str:
    """Atomically write ``state`` as checkpoint ``step``."""
    os.makedirs(directory, exist_ok=True)
    flat, ext = {}, {}
    for key, t in flatten_state(state).items():
        flat[key], name = _to_numpy(t)
        if name is not None:
            ext[key] = name
    if ext:
        flat["__dtypes__"] = np.asarray(json.dumps(ext))
    path = os.path.join(directory, f"ckpt_{step:06d}.npz")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **flat)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    manifest = {"step": step, "file": os.path.basename(path),
                "extra": extra or {}}
    mtmp = path + ".manifest.tmp"
    with open(mtmp, "w") as fh:
        json.dump(manifest, fh)
    os.replace(mtmp, os.path.join(directory, "manifest.json"))
    ckpts = sorted(f for f in os.listdir(directory)
                   if f.startswith("ckpt_") and f.endswith(".npz"))
    for old in ckpts[:-keep]:
        os.unlink(os.path.join(directory, old))
    return path


def latest_step(directory: str) -> Optional[int]:
    mf = os.path.join(directory, "manifest.json")
    if not os.path.exists(mf):
        return None
    with open(mf) as fh:
        return int(json.load(fh)["step"])


def state_from_checkpoint(directory: str, device="cuda",
                          step: Optional[int] = None) -> SMLState:
    """The port's :class:`SMLState` from checkpoint ``step`` (default: the
    latest) that ``sml_tpu`` (or this package) wrote, on ``device``;
    snapshot dtypes are kept."""
    dev = resolve_device(device)
    with open(os.path.join(directory, "manifest.json")) as fh:
        manifest = json.load(fh)
    fname = manifest["file"] if step is None else f"ckpt_{step:06d}.npz"
    with np.load(os.path.join(directory, fname)) as data:
        ext = (json.loads(str(data["__dtypes__"]))
               if "__dtypes__" in data.files else {})

        def leaf(key):
            return _to_tensor(data[key], ext.get(key)).to(dev)

        mf = MFParams(*(leaf(f"mf/{f}") for f in MFParams._fields))
        theta = theta_from_numpy(
            {side: {f: leaf(f"theta/{side}/{f}") for f in TOWER_FIELDS}
             for side in ("user", "item")}, device=dev)
        return SMLState(mf=mf, theta=theta, **{f: leaf(f) for f in SNAPSHOTS})
