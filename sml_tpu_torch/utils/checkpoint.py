"""Period-boundary checkpoints in the JAX package's framework-free layout
(counterpart of ``sml_tpu/utils/checkpoint.py``).

One ``ckpt_<step>.npz`` per checkpoint plus ``manifest.json`` naming the
latest, both written atomically (tmp + rename). Leaves are keyed by path:
``mf/user_emb``, ``theta/user/fc1_w`` (the tower's own field names for
every transfer kind), ``last_user``, ``hat_item``,
``mf_opt/1/count``, ``mf_opt/1/mu/user_emb``, ``tr_opt/1/nu/item/fc2_b``,
``key``; bfloat16 leaves are stored as their uint16 bits, with the true
dtype names under ``__dtypes__``. So a checkpoint that ``sml_tpu`` wrote
loads here (:func:`state_from_checkpoint`), and one the port wrote restores
in ``sml_tpu`` (``restore_checkpoint`` reads the keys of its template).

The random streams differ: ``sml_tpu`` stores its PRNG key (two uint32
words) under ``key``; the port stores its generator's state under
``torch_generator_state``, an extra key ``sml_tpu`` never reads, and under
``key`` two words digested from that state. Resuming a port checkpoint on a
device of the same kind restores the generator exactly; resuming one that
``sml_tpu`` wrote (or one from another kind of device) seeds the port's
generator from the ``key`` words, which starts a new stream.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from sml_tpu_torch.device import resolve_device
from sml_tpu_torch.models.mf import MFParams
from sml_tpu_torch.models.transfer import theta_from_numpy, theta_leaves
from sml_tpu_torch.train.engine import SMLState
from sml_tpu_torch.train.optim import AdamState

SNAPSHOTS = ("last_user", "last_item", "hat_user", "hat_item")
GENERATOR_KEY = "torch_generator_state"


def _key_words(gen: torch.Generator) -> torch.Tensor:
    """Two uint32 words (held in int64) digested from the generator's
    state, written under ``key`` for ``sml_tpu``'s restore."""
    digest = hashlib.blake2b(gen.get_state().numpy().tobytes(),
                             digest_size=8).digest()
    return torch.tensor([int.from_bytes(digest[:4], "little"),
                         int.from_bytes(digest[4:], "little")],
                        dtype=torch.int64)


def flatten_state(state: SMLState) -> Dict[str, torch.Tensor]:
    """``{path: tensor}`` under the JAX package's key names, plus the
    port's generator state."""
    flat = {f"mf/{f}": getattr(state.mf, f) for f in MFParams._fields}
    for name, p in theta_leaves(state.theta).items():
        flat[f"theta/{name}"] = p.detach()
    for f in SNAPSHOTS:
        flat[f] = getattr(state, f)
    for opt in ("mf_opt", "tr_opt"):
        ost: AdamState = getattr(state, opt)
        flat[f"{opt}/1/count"] = torch.tensor(ost.count, dtype=torch.int32)
        for part in ("mu", "nu"):
            for name, t in getattr(ost, part).items():
                flat[f"{opt}/1/{part}/{name}"] = t
    flat["key"] = _key_words(state.gen)
    flat[GENERATOR_KEY] = state.gen.get_state()
    return flat


def _to_numpy(key: str, t: torch.Tensor):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    if key == "key":
        return t.numpy().astype(np.uint32), None
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
        flat[key], name = _to_numpy(key, t)
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


def read_manifest(directory: str) -> Dict[str, Any]:
    with open(os.path.join(directory, "manifest.json")) as fh:
        return json.load(fh)


def _generator(data, dev: torch.device) -> torch.Generator:
    gen = torch.Generator(device=dev)
    if GENERATOR_KEY in data.files:
        saved = torch.from_numpy(np.ascontiguousarray(data[GENERATOR_KEY]))
        # a CPU generator's state and a CUDA generator's differ in size:
        # only a state saved on the same kind of device restores
        if saved.numel() == gen.get_state().numel():
            gen.set_state(saved)
            return gen
    words = np.asarray(data["key"]).astype(np.uint64)
    return gen.manual_seed(int((words[0] << np.uint64(32)) | words[1])
                           & ((1 << 63) - 1))


def state_from_checkpoint(directory: str, device="cuda",
                          step: Optional[int] = None) -> SMLState:
    """The port's :class:`SMLState` from checkpoint ``step`` (default: the
    latest) that ``sml_tpu`` or the port wrote, on ``device``: tables, Θ,
    snapshots (dtypes kept), both Adam states and the run's generator."""
    dev = resolve_device(device)
    manifest = read_manifest(directory)
    fname = manifest["file"] if step is None else f"ckpt_{step:06d}.npz"
    with np.load(os.path.join(directory, fname)) as data:
        ext = (json.loads(str(data["__dtypes__"]))
               if "__dtypes__" in data.files else {})

        def leaf(key):
            return _to_tensor(data[key], ext.get(key)).to(dev)

        def opt_state(opt: str, names) -> AdamState:
            return AdamState(
                int(data[f"{opt}/1/count"]),
                {n: leaf(f"{opt}/1/mu/{n}").contiguous() for n in names},
                {n: leaf(f"{opt}/1/nu/{n}").contiguous() for n in names})

        mf = MFParams(*(leaf(f"mf/{f}") for f in MFParams._fields))
        # Θ's tower fields (so its kind) are the keys under theta/<side>/
        theta = theta_from_numpy(
            {side: {k.split("/")[2]: leaf(k) for k in data.files
                    if k.startswith(f"theta/{side}/")}
             for side in ("user", "item")}, device=dev)
        return SMLState(
            mf=mf, theta=theta, **{f: leaf(f) for f in SNAPSHOTS},
            mf_opt=opt_state("mf_opt", MFParams._fields),
            tr_opt=opt_state("tr_opt", theta_leaves(theta)),
            gen=_generator(data, dev))
