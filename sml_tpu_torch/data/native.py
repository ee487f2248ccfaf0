"""ctypes bindings for the host-side data kernels (counterpart of
``sml_tpu/data/native.py``).

The C++ source is the port's own copy, ``sml_tpu_torch/native/sampler.cpp``
(byte for byte the JAX package's ``native/sampler.cpp``), so both packages
draw the same negatives and parse logs the same way for the same inputs
and seeds. At first use it is compiled with
``g++ -O3 -march=native -shared -fPIC`` into ``<repo>/build/host/``
(listed in ``.gitignore``), named by a hash of the source and the flags so
an edited source rebuilds; nothing is written next to the source.

No fallback: where ``g++`` is missing or the build fails, the call raises,
naming the compiler and its output. The one route that does not reach the
library is the reference's own: a log whose delimiter is not one character
is parsed by ``np.genfromtxt`` in :func:`sml_tpu_torch.data.ingest.ingest_csv`
(the C parser splits on one byte), as in the JAX package.
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

import numpy as np

SRC = Path(__file__).resolve().parent.parent / "native" / "sampler.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "host"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_P64 = ctypes.POINTER(ctypes.c_int64)


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libsml_sampler_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the native data kernels "
                           f"({SRC.name}) cannot be built on this host")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SRC)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed to build {SRC.name} (rc "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the library, with the
    ctypes signatures of its four C entry points."""
    path = library_path()
    if not path.exists():
        _compile(path)
    lib = ctypes.CDLL(str(path))
    lib.sml_build_eval_rows.restype = ctypes.c_int
    lib.sml_build_eval_rows.argtypes = [
        _P64, _P64, ctypes.c_int64, _P64, _P64, ctypes.c_int64,
        _P64, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64, _P64]
    lib.sml_sample_negatives.restype = ctypes.c_int
    lib.sml_sample_negatives.argtypes = [
        _P64, ctypes.c_int64, _P64, _P64, ctypes.c_int64,
        _P64, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64, _P64]
    lib.sml_count_csv_rows.restype = ctypes.c_int64
    lib.sml_count_csv_rows.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64]
    lib.sml_parse_csv_log.restype = ctypes.c_int64
    lib.sml_parse_csv_log.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_char, ctypes.c_int64, _P64, _P64,
        ctypes.POINTER(ctypes.c_double)]
    return lib


def _c64(a: np.ndarray):
    return a.ctypes.data_as(_P64)


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def build_eval_rows_native(interactions: np.ndarray, history: np.ndarray,
                           catalog: np.ndarray, neg_num: int,
                           seed: int = 0) -> np.ndarray:
    """``[user, pos, neg_num distinct negatives]`` per interaction: the
    negatives are drawn from ``catalog`` and exclude every item of the
    user's ``history``. ``interactions`` (N, 2) ``[user, pos]``,
    ``history`` (H, 2) all known (user, item) pairs, ``catalog`` (C,)."""
    lib = load_library()
    inter = _i64(interactions)
    hist = _i64(history)
    cat = _i64(catalog)
    out = np.empty((inter.shape[0], 2 + neg_num), dtype=np.int64)
    u, i = _i64(inter[:, 0]), _i64(inter[:, 1])
    hu, hi = _i64(hist[:, 0]), _i64(hist[:, 1])
    rc = lib.sml_build_eval_rows(
        _c64(u), _c64(i), inter.shape[0], _c64(hu), _c64(hi), hist.shape[0],
        _c64(cat), cat.shape[0], neg_num, seed, _c64(out))
    if rc != 0:
        raise ValueError(
            "catalog too small to draw the requested distinct negatives")
    return out


def sample_negatives_native(users: np.ndarray, history: np.ndarray,
                            pool: np.ndarray, tries: int = 16,
                            seed: int = 0) -> np.ndarray:
    """One negative per user from ``pool``, rejecting the user's
    positives (up to ``tries`` draws)."""
    lib = load_library()
    u = _i64(users)
    hist = _i64(history)
    p = _i64(pool)
    out = np.empty(u.shape[0], dtype=np.int64)
    hu, hi = _i64(hist[:, 0]), _i64(hist[:, 1])
    lib.sml_sample_negatives(_c64(u), u.shape[0], _c64(hu), _c64(hi),
                             hist.shape[0], _c64(p), p.shape[0], tries, seed,
                             _c64(out))
    return out


def parse_csv_log_native(path: str, user_col: int = 0, item_col: int = 1,
                         time_col: int = 2, delimiter: str = ",",
                         skip_header: int = 1):
    """``(users int64, items int64, times float64)`` of a delimited log,
    or None for a delimiter that is not one character (the caller parses
    those with numpy, as the JAX package does). ``#`` lines are skipped.
    Raises ValueError on a malformed line (a missing column, or a number
    that does not parse or has trailing garbage), naming it 1-based."""
    if len(delimiter) != 1:
        return None
    lib = load_library()
    with open(path, "rb") as fh:
        buf = fh.read()
    n = lib.sml_count_csv_rows(buf, len(buf), skip_header)
    users = np.empty(n, dtype=np.int64)
    items = np.empty(n, dtype=np.int64)
    times = np.empty(n, dtype=np.float64)
    rc = lib.sml_parse_csv_log(
        buf, len(buf), user_col, item_col, time_col,
        delimiter.encode()[:1], skip_header, _c64(users), _c64(items),
        times.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc < 0:
        raise ValueError(
            f"malformed log line {-(rc + 1) + 1} (1-based) in {path}")
    return users[:rc], items[:rc], times[:rc]
