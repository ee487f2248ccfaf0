"""Build and load the port's CUDA kernels.

At first use, every ``csrc/*.cu`` is compiled for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) by its own ``nvcc`` process,
all started together, and the objects are linked into one shared library
under ``<repo>/build/kernels/`` (listed in ``.gitignore``), named by a hash
of the sources and flags so an edited source rebuilds. ptxas's report of
each kernel's registers and shared memory is kept beside it
(:func:`build_log`). The library has a plain C interface and loads
through ``ctypes``: pointers and the stream travel as ``c_void_p``. Every C entry point returns ``cudaGetLastError()``
after its launch; :func:`check` raises on a non-zero code.

Nothing here runs at import time: this module is imported on hosts without
``nvcc`` or a GPU, where only the plain PyTorch versions run.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "--resource-usage")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
# C signatures: name -> argtypes (every entry returns int, a cudaError_t)
SIGNATURES = {
    # last, hat, in_bf16, conv1_w, conv1_b, conv2_w, conv2_b, fc1_w, fc1_b,
    # fc2_w, fc2_b, out, n, d, c1, c2, h, stream
    "sml_transfer_rows": [_P, _P, _I] + [_P] * 9 + [_I] * 5 + [_P],
    # d -> K1's dynamic shared memory per block, bytes
    "sml_transfer_smem_bytes": [_I],
    # ue, items_t, in_bf16, sstar, maskp, rank, B, d, ipad, rows_per_block,
    # items_on_x, stream
    "sml_masked_rank": [_P, _P, _I, _P, _P, _P] + [_I] * 5 + [_P],
    # ue, items, in_bf16, sstar, maskp, rank, B, d, ipad, stream
    "sml_masked_rank_gather": [_P, _P, _I, _P, _P, _P] + [_I] * 3 + [_P],
    # ue_t, n_users, users, users_stride, users_is64, cand, cand_stride0,
    # cand_stride1, cand_is64, table, n_items, out, B, C, stream
    "sml_candidate_scores": [_P, _I, _P, _L, _I, _P, _L, _L, _I, _P, _I, _P,
                             _I, _I, _P],
    # ue, tgt, maskm, table, rank, B, ipad, stream
    "sml_dense_mask_rank": [_P] * 5 + [_I] * 2 + [_P],
    # leaves (n_leaves rows of int64 p, mu, nu, n), n_leaves, lr, b1, b2,
    # eps, bc1, bc2 (one f32 each on the card), stream
    "sml_decay_adam": [ctypes.POINTER(_L), _I] + [_F] * 4 + [_P] * 3,
    # parent stream, body stream, pred (one bool on the card), capture mode
    "sml_if_begin": [_P, _P, _P, _I],
    # body stream
    "sml_if_end": [_P],
}


def find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME, "
                           "/usr/local/cuda and PATH): the CUDA kernels "
                           "cannot be built on this host")
    return found


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsml_kernels_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        units = sorted(CSRC.glob("*.cu"))
        objs = [tmp / (u.stem + ".o") for u in units]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(u),
                                   "-o", str(o)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for u, o in zip(units, objs)]
        failed, logs = [], []
        for u, p in zip(units, procs):
            log, _ = p.communicate()
            logs.append(log)
            if p.returncode != 0:
                failed.append(f"{u.name} (rc {p.returncode}):\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        so_tmp = tmp / out.name
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o",
                               str(so_tmp), *map(str, objs)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        out.with_suffix(".log").write_text("".join(logs))
        os.replace(so_tmp, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    path = library_path()
    if not path.exists():
        _compile(path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.sml_error_string.argtypes = [ctypes.c_int]
    lib.sml_error_string.restype = ctypes.c_char_p
    return lib


def build_log() -> str:
    """ptxas's resource report for every kernel of the built library."""
    load_library()
    return library_path().with_suffix(".log").read_text()


def check(code: int, kernel: str) -> None:
    if code != 0:
        msg = load_library().sml_error_string(code).decode()
        raise RuntimeError(f"{kernel} failed to launch: CUDA error {code} "
                           f"({msg})")


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


# the kernel wrappers that count their launches, in the order they were
# defined (a CUDA-graph capture reads them: ``train/graphs.py``)
COUNTED = []


def counted(wrapper):
    """Register a kernel wrapper that adds one to ``wrapper.launches``
    where it launches its kernel, and nowhere else; starts the count at 0."""
    wrapper.launches = 0
    COUNTED.append(wrapper)
    return wrapper
