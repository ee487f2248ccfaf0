"""Memory checks of the port's hand-written kernels and captured programs.

One target per kernel (K1, K2, K3, P1, P2, P3) and one for the captured
programs. A target makes one small call per case, on the edge cases each
kernel has (widths off its vector width, tails of row tiles, masks that
overflow K2/P3's 512-id warp list, out-of-range ids, 1 and 8 Adam leaves,
bias corrections read through device pointers), makes each call
``REPEATS`` times on the same inputs (the results must be bit-equal:
a race that loses now and then shows as a difference), and holds the
result against the kernel's plain PyTorch version. The program target
runs the ragged fused sweep of ``tests/test_torch_cuda.py``'s
``test_one_capture_serves_a_ragged_sweep`` (one capture a program,
replays with skipped step slots, the saddle retry, ``close()``) against
the unfused sweep, bit for bit.

    python -m sml_tpu_torch.scripts.sanitize --target k1 [--device cpu]
    python -m sml_tpu_torch.scripts.sanitize --target k1 --fence tail
    compute-sanitizer --tool memcheck --error-exitcode 1 \\
        python -m sml_tpu_torch.scripts.sanitize --target k1
    python -m sml_tpu_torch.scripts.sanitize --all [--tools memcheck|none]

Two checkers hold the targets on the card, each target in a process of
its own:

* **fence** (``--fence tail|head``): every allocation the process makes
  comes from ``csrc/tools/fence_alloc.cu``, a PyTorch pluggable allocator
  that gives each tensor pages of its own against a page that is never
  mapped (after its end, or before its start), and fills them with 0xFF
  first. A read or write past a tensor's edge faults (an illegal address,
  which ends the process); a read of bytes nothing wrote reads NaN or -1
  and fails the comparison. Kernel targets only: a CUDA-graph capture
  needs the caching allocator's private pools.
* **compute-sanitizer** (in ``--all``; ``--tools`` picks them, ``none``
  runs none): the tools (memcheck, racecheck, synccheck, initcheck over
  the kernel targets, under ``PYTORCH_NO_CUDA_MEMORY_CACHING=1`` so that
  each tensor is an allocation of its own; memcheck and initcheck over
  the program target, with the caching allocator). It is found beside
  ``nvcc`` (``_build.find_nvcc``); missing, this script raises. A line
  is ``clean`` only where the target ran to its end and the tool counted
  0 errors. A tool that reports the device unsupported gives
  ``unsupported`` where the target never started and ``failed`` where
  the target's process failed (``sanitizer_status``); the tool's message
  stays on the line.

``--all`` compares ptxas's registers and spills of every kernel with a
build without ``-lineinfo`` (``lineinfo``), proves the fence on this
machine (``fence-probe``: K3's C entry called on a fenced table with a
length past its end, or a start before it, must die of an illegal
address), then runs every (target, fence) and (target, tool) in
subprocesses, ``JOBS`` at a time, and
prints one JSON line each (status, errors, seconds, the tool's own
summary line), then a summary line. It exits 1 on any line that is not
``clean`` (or ``caught``, for a probe): an error, a failed run, a tool
that could not run, a fence that did not catch its probe.

``--device cpu`` runs the targets through their plain versions (the
wrappers' CPU route against the plain functions), with no checker.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import copy
import ctypes
import hashlib
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

from sml_tpu_torch import _build
from sml_tpu_torch.device import resolve_device
from sml_tpu_torch.ops.edge_cases import (k2_edge_rows, p2_out_of_range,
                                          p3_edge_rows)

SEED = 2000
REPEATS = 3
KERNEL_TOOLS = ("memcheck", "racecheck", "synccheck", "initcheck")
PROGRAM_TOOLS = ("memcheck", "initcheck")
FENCES = ("tail", "head")
TIMEOUT_S = 300     # per checked process
JOBS = 6            # processes at once (the card's machine has 8 cores)
FENCE_SOURCE = _build.CSRC / "tools" / "fence_alloc.cu"
# the message an illegal address gives, in PyTorch's error text
ILLEGAL_ADDRESS = "illegal memory access"

# K1 (transfer_rows_kernel): its row tiles (64 rows to d=128, 32 to 256, 16
# to 512) and weight streams (bulk copies where d % 4 == 0, cp.async with
# zero fill otherwise: d=62), on a row count that leaves a tail tile
K1_ROWS, K1_WIDTHS = 1000, (64, 62, 256, 512)
K1_C1, K1_C2, K1_H = 10, 5, 512
K1_TOL = 1e-4
# K2 and P3 at the Yelp item count; rows of a batch that is not a multiple
# of 8
N_ITEMS, EDGE_ROWS, DIM = 20_000, 1021, 64
# K3: leaf sizes off the 4-element vector width, one leaf and eight
K3_ONE = (1001,)
K3_EIGHT = (1, 3, 37, 1001, 4099, 449, 20_001, 13)
# P1: a width that pads (40 -> 48), a row count off both row tiles
P1_ROWS, P1_ITEMS, P1_D = 300, 5000, 40
# P2: the probe's 1024 x 1001 call on strided int64 ids, odd B and C
P2_USERS, P2_ITEMS = 3000, 2000


class Target(NamedTuple):
    name: str
    kind: str                   # "kernel" or "program"
    covers: Tuple[str, ...]     # the wrappers (and nodes) it launches
    run: Callable               # run(device, repeats) -> dict


def _bytes(t: torch.Tensor) -> bytes:
    return t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes()


def repeated(call: Callable, repeats: int):
    """``call()`` ``repeats`` times; its outputs (a tensor or a tuple of
    them) must be bit-equal every time. Returns the first."""
    outs = []
    for _ in range(repeats):
        out = call()
        outs.append(out if isinstance(out, tuple) else (out,))
    first = [_bytes(t) for t in outs[0]]
    for k, out in enumerate(outs[1:], 1):
        if [_bytes(t) for t in out] != first:
            raise RuntimeError(f"repeat {k} of the same call on the same "
                               "inputs gave other bits")
    return outs[0] if len(outs[0]) > 1 else outs[0][0]


def _ints(g, lo, hi, shape, dtype):
    """Integer values in [lo, hi) as ``dtype``: sums of their products are
    exact in f32, so a kernel and its plain version agree exactly."""
    return torch.randint(lo, hi, shape, generator=g).to(dtype)


def _launched(wrapper, before: int, calls: int, device) -> None:
    if device.type == "cuda" and wrapper.launches - before != calls:
        raise RuntimeError(f"{wrapper.__name__} launched "
                           f"{wrapper.launches - before} times for {calls} "
                           "calls")


# --- K1 ---------------------------------------------------------------------

def target_k1(device, repeats: int) -> dict:
    from sml_tpu_torch.config import TransferConfig
    from sml_tpu_torch.models.transfer import init_transfer
    from sml_tpu_torch.ops import transfer_kernel as tk
    g = torch.Generator().manual_seed(SEED)
    before, calls, worst = tk.transfer_rows_cuda.launches, 0, 0.0
    cases = []
    for d in K1_WIDTHS:
        cfg = TransferConfig(latent_dim=d, conv1_channels=K1_C1,
                             conv2_channels=K1_C2, fc_hidden=K1_H)
        theta = init_transfer(torch.Generator().manual_seed(SEED + d), cfg,
                              device="cpu")
        tower = copy.deepcopy(theta.user).to(device)
        for dtype in (torch.float32, torch.bfloat16):
            last = torch.randn(K1_ROWS, d, generator=g).to(dtype)
            hat = torch.randn(K1_ROWS, d, generator=g).to(dtype)
            want = tk.transfer_rows_plain(theta.user, last, hat)
            last_d, hat_d = last.to(device), hat.to(device)
            for into in (False, True):
                def call():
                    out = (torch.empty(K1_ROWS, d, device=device) if into
                           else None)
                    return tk.fused_table_transfer(tower, last_d, hat_d,
                                                   out=out)
                got = repeated(call, repeats)
                calls += repeats
                err = float((got.cpu() - want).abs().max())
                worst = max(worst, err)
                cases.append(f"d={d} {str(dtype)[6:]} out={into}")
                if not err <= K1_TOL:
                    raise RuntimeError(f"K1 d={d} {dtype} out={into}: max "
                                       f"error {err} > {K1_TOL}")
    _launched(tk.transfer_rows_cuda, before, calls, device)
    return {"cases": cases, "max_abs_err": worst, "calls": calls}


# --- K2 ---------------------------------------------------------------------

def _eval_batch(g, n_rows: int, n_items: int, n_neg: int = 999):
    """Users, targets and ``n_neg`` random negatives per row."""
    tgt = torch.randint(0, n_items, (n_rows,), generator=g)
    neg = torch.randint(0, n_items, (n_rows, n_neg), generator=g)
    return tgt, neg


def target_k2(device, repeats: int) -> dict:
    from sml_tpu_torch.ops import eval_kernel as ek
    g = torch.Generator().manual_seed(SEED + 2)
    ipad = ek.pad_items(N_ITEMS)
    tgt, neg = _eval_batch(g, EDGE_ROWS, N_ITEMS)
    masks = ek.build_packed_mask(neg, N_ITEMS)
    k2_edge_rows(masks, N_ITEMS)
    before, calls, cases = ek.masked_rank_cuda.launches, 0, []
    for dtype in (torch.float32, torch.bfloat16):
        items = torch.zeros(ipad, DIM, dtype=dtype)
        items[:N_ITEMS] = _ints(g, -3, 4, (N_ITEMS, DIM), dtype)
        ue = _ints(g, -3, 4, (EDGE_ROWS, DIM), dtype)
        sstar = (ue.float() * items[tgt].float()).sum(1)
        want = ek.masked_rank_plain(ue, items.T, sstar, masks)
        args = [t.to(device) for t in (ue, items, sstar, masks)]
        got = repeated(lambda: ek.masked_rank(*args), repeats)
        calls += repeats
        cases.append(str(dtype)[6:])
        if not torch.equal(got.cpu(), want):
            raise RuntimeError(f"K2 {dtype}: "
                               f"{int((got.cpu() != want).sum())} ranks "
                               "differ from the plain version")
    _launched(ek.masked_rank_cuda, before, calls, device)
    return {"cases": cases, "rows": EDGE_ROWS, "calls": calls,
            "bits_row1": N_ITEMS, "max_abs_err": 0}


# --- K3 ---------------------------------------------------------------------

def target_k3(device, repeats: int) -> dict:
    from sml_tpu_torch.ops import adam_kernel as ak
    from sml_tpu_torch.train.optim import (ADAM_B1, ADAM_B2, ADAM_EPS,
                                           BiasTable)
    g = torch.Generator().manual_seed(SEED + 3)
    bias = BiasTable(4, device)
    bias.fill(6)
    bc1, bc2 = bias.at(8, ADAM_B1, ADAM_B2)
    kw = dict(lr=0.01, b1=ADAM_B1, b2=ADAM_B2, eps=ADAM_EPS)
    before, calls, cases, worst = ak.decay_adam_cuda.launches, 0, [], 0.0
    for sizes in (K3_ONE, K3_EIGHT):
        init = [(torch.randn(n, generator=g),
                 0.1 * torch.randn(n, generator=g),
                 torch.rand(n, generator=g)) for n in sizes]
        want = [tuple(t.to(device, copy=True) for t in leaf)
                for leaf in init]
        for leaf in want:
            ak.decay_adam_plain(*leaf, bc1, bc2, **kw)

        def call():
            leaves = [tuple(t.to(device, copy=True) for t in leaf)
                      for leaf in init]
            ak.fused_decay_adam_multi(leaves, bc1, bc2, **kw)
            return tuple(t for leaf in leaves for t in leaf)
        got = repeated(call, repeats)
        calls += repeats
        cases.append(f"{len(sizes)} leaves {sizes}")
        for k, (w, t) in enumerate(zip((t for leaf in want for t in leaf),
                                       got)):
            part = ("p", "mu", "nu")[k % 3]
            if part == "p":
                rel = float(((t - w).abs() / w.abs().clamp_min(1e-30)).max())
                worst = max(worst, float((t - w).abs().max()))
                ok = rel <= 1e-6
            else:
                ok = torch.equal(t, w)
            if not ok:
                raise RuntimeError(f"K3 {len(sizes)} leaves: leaf {k // 3} "
                                   f"{part} differs from the plain version")
    _launched(ak.decay_adam_cuda, before, calls, device)
    return {"cases": cases, "calls": calls, "max_abs_err": worst,
            "bias": "BiasTable"}


# --- P1 ---------------------------------------------------------------------

def target_p1(device, repeats: int) -> dict:
    from sml_tpu_torch.ops import eval_kernel as ek
    g = torch.Generator().manual_seed(SEED + 4)
    ipad = ek.pad_items(P1_ITEMS)
    tgt, neg = _eval_batch(g, P1_ROWS, P1_ITEMS, 200)
    masks = ek.build_packed_mask(neg, P1_ITEMS)
    # no bit; one bit; one whole 4096-item mask block; every item
    masks[0] = 0
    masks[1] = 0
    masks[1, 0] = 1
    masks[2] = 0
    masks[2, :ek.LANES] = -1
    masks[3] = ek.build_packed_mask(torch.arange(P1_ITEMS)[None],
                                    P1_ITEMS)[0]
    before, calls, cases = ek.masked_rank_variant_cuda.launches, 0, []
    for dtype in (torch.float32, torch.bfloat16):
        items_t = torch.zeros(P1_D, ipad, dtype=dtype)
        items_t[:, :P1_ITEMS] = _ints(g, -3, 4, (P1_D, P1_ITEMS), dtype)
        ue = _ints(g, -3, 4, (P1_ROWS, P1_D), dtype)
        sstar = (ue.float() * items_t[:, tgt].T.float()).sum(1)
        want = ek.masked_rank_plain(ue, items_t, sstar, masks)
        args = [t.to(device) for t in (ue, items_t, sstar, masks)]
        for rows in ek.VARIANT_ROWS_PER_BLOCK:
            for order in ek.VARIANT_ORDERS:
                got = repeated(lambda: ek.masked_rank_variant(
                    *args, rows_per_block=rows, order=order), repeats)
                calls += repeats
                cases.append(f"{str(dtype)[6:]} {rows} {order}")
                if not torch.equal(got.cpu(), want):
                    raise RuntimeError(f"P1 {dtype} {rows} {order}: ranks "
                                       "differ from the plain version")
    _launched(ek.masked_rank_variant_cuda, before, calls, device)
    return {"cases": cases, "d": P1_D, "calls": calls, "max_abs_err": 0}


# --- P2 ---------------------------------------------------------------------

def target_p2(device, repeats: int) -> dict:
    from sml_tpu_torch.ops import probe_kernels as pk
    g = torch.Generator().manual_seed(SEED + 5)
    ue_t = _ints(g, -2, 3, (P2_USERS, DIM), torch.bfloat16)
    table = _ints(g, -2, 3, (P2_ITEMS, DIM), torch.bfloat16)
    before, calls, cases = pk.candidate_scores_cuda.launches, 0, []
    for name, B, C, dtype, strided, bad in (
            ("probe int64 strided", 1024, 1001, torch.int64, True, False),
            ("int32", 333, 1001, torch.int32, False, False),
            ("odd int32", 7, 13, torch.int32, False, False),
            ("out-of-range int64 strided", 1024, 1001, torch.int64, True,
             True)):
        rows = torch.randint(0, P2_ITEMS, (B, 1 + C), generator=g)
        rows[:, 0] %= P2_USERS
        if bad:
            p2_out_of_range(g, rows[:, 0], rows[:, 1:], P2_USERS, P2_ITEMS)
        rows = rows.to(dtype)
        users, cand = ((rows[:, 0], rows[:, 1:]) if strided else
                       (rows[:, 0].contiguous(), rows[:, 1:].contiguous()))
        want = pk.candidate_scores_plain(ue_t, users, cand, table)
        args = [t.to(device) for t in (ue_t, table, rows)]
        d_rows = args[2]
        d_users, d_cand = ((d_rows[:, 0], d_rows[:, 1:]) if strided else
                           (d_rows[:, 0].contiguous(),
                            d_rows[:, 1:].contiguous()))
        got = repeated(lambda: pk.candidate_scores(args[0], d_users, d_cand,
                                                   args[1]), repeats).cpu()
        calls += repeats
        cases.append(f"{name} B={B} C={C}")
        nan = want.isnan()
        if not (torch.equal(got.isnan(), nan)
                and torch.equal(got[~nan], want[~nan])):
            raise RuntimeError(f"P2 {name}: scores differ from the plain "
                               "version")
    _launched(pk.candidate_scores_cuda, before, calls, device)
    return {"cases": cases, "calls": calls, "max_abs_err": 0}


# --- P3 ---------------------------------------------------------------------

def target_p3(device, repeats: int) -> dict:
    from sml_tpu_torch.ops import eval_kernel as ek
    from sml_tpu_torch.ops import probe_kernels as pk
    g = torch.Generator().manual_seed(SEED + 6)
    ipad = ek.pad_items(N_ITEMS)
    table = torch.zeros(ipad, DIM, dtype=torch.bfloat16)
    table[:N_ITEMS] = _ints(g, -2, 3, (N_ITEMS, DIM), torch.bfloat16)
    ue = _ints(g, -2, 3, (EDGE_ROWS, DIM), torch.bfloat16)
    tgt = torch.randint(0, N_ITEMS, (EDGE_ROWS,), generator=g,
                        dtype=torch.int32)
    maskm = (torch.rand(EDGE_ROWS, ipad, generator=g) < 0.05).to(torch.int8)
    p3_edge_rows(maskm, tgt, N_ITEMS, ipad)
    want = pk.dense_mask_rank_plain(table, ue, tgt, maskm)
    args = [t.to(device) for t in (table, ue, tgt, maskm)]
    before = pk.dense_mask_rank_cuda.launches
    got = repeated(lambda: pk.dense_mask_rank(*args), repeats)
    if not torch.equal(got.cpu(), want):
        raise RuntimeError(f"P3: {int((got.cpu() != want).sum())} ranks "
                           "differ from the plain version")
    _launched(pk.dense_mask_rank_cuda, before, repeats, device)
    return {"cases": ["edge batch"], "rows": EDGE_ROWS, "calls": repeats,
            "max_abs_err": 0}


# --- the captured programs ---------------------------------------------------

def target_program(device, repeats: int) -> dict:
    """The ragged sweep with evals, norms and the saddle retry, fused (on
    the card: one capture a program, replays with skipped slots) against
    unfused, each driver closed; ``repeats`` is not used (the sweep runs
    each of its periods' programs many times)."""
    from sml_tpu_torch.ops import adam_kernel as ak
    from sml_tpu_torch.ops import eval_kernel as ek
    from sml_tpu_torch.ops import transfer_kernel as tk
    from sml_tpu_torch.scripts import program_stress as ps
    wrappers = (tk.transfer_rows_cuda, ek.masked_rank_cuda,
                ak.decay_adam_cuda)
    with tempfile.TemporaryDirectory(prefix="sml_sanitize_") as root:
        spec = ps.ragged_dataset(Path(root))
        before = [w.launches for w in wrappers]
        fused = ps.run_sweep(spec, ps.SADDLE, True, device)
        launched = [w.launches - b for w, b in zip(wrappers, before)]
        unfused = ps.run_sweep(spec, ps.SADDLE, False, device)
    bad = ps.sweep_differences(fused, unfused)
    if bad:
        raise RuntimeError(f"the fused ragged sweep differs from the unfused "
                           f"one in {bad}")
    stats = fused["stats"]
    if device.type == "cuda":
        # the phase program and branch C's inner and outer epoch programs
        if [stats[k] for k in ("programs", "captures", "warmups")] != \
                [3, 3, 1] or stats["if_nodes"] == 0:
            raise RuntimeError(f"the fused sweep made {stats}, not three "
                               "programs, a capture each and one warm-up "
                               "with IF nodes")
        if min(launched) == 0:
            raise RuntimeError(f"the fused sweep launched K1/K2/K3 "
                               f"{launched} times")
    return {"cases": ["ragged sweep with the saddle retry"],
            "graph_stats": stats, "launches": launched,
            "saddle_retries_used": fused["retries"]}


TARGETS: Dict[str, Target] = {t.name: t for t in (
    Target("k1", "kernel", ("transfer_rows_cuda",), target_k1),
    Target("k2", "kernel", ("masked_rank_cuda",), target_k2),
    Target("k3", "kernel", ("decay_adam_cuda",), target_k3),
    Target("p1", "kernel", ("masked_rank_variant_cuda",), target_p1),
    Target("p2", "kernel", ("candidate_scores_cuda",), target_p2),
    Target("p3", "kernel", ("dense_mask_rank_cuda",), target_p3),
    Target("program", "program", ("sml_if_begin", "sml_if_end"),
           target_program),
)}


# --- the fence ---------------------------------------------------------------

def fence_library() -> Path:
    """Build (once per source hash) the guard-page allocator."""
    h = hashlib.sha256(FENCE_SOURCE.read_bytes()).hexdigest()[:16]
    path = _build.BUILD_DIR / f"libsml_fence_{h}.so"
    if not path.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        run = subprocess.run(
            [_build.find_nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O2",
             "-Xcompiler", "-fPIC", "-shared", str(FENCE_SOURCE), "-o",
             str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        if run.returncode != 0:
            raise RuntimeError(f"nvcc failed on {FENCE_SOURCE.name}:\n"
                               f"{run.stdout}")
        os.replace(tmp, path)
    return path


def install_fence(mode: str) -> ctypes.CDLL:
    """Route every CUDA allocation of this process through the fence
    (before any CUDA tensor exists)."""
    if mode not in FENCES:
        raise ValueError(f"--fence takes one of {FENCES}, got {mode!r}")
    path = fence_library()
    os.environ["SML_FENCE"] = mode
    alloc = torch.cuda.memory.CUDAPluggableAllocator(
        str(path), "sml_fence_malloc", "sml_fence_free")
    torch.cuda.memory.change_current_allocator(alloc)
    lib = ctypes.CDLL(str(path))
    lib.sml_fence_stats.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    return lib


def fence_stats(lib: ctypes.CDLL) -> dict:
    out = (ctypes.c_longlong * 4)()
    lib.sml_fence_stats(out)
    return {"allocations": out[0], "live": out[1], "failed": out[2],
            "mode": ("tail", "head")[out[3]] if out[3] >= 0 else None}


def fence_probe(mode: str) -> None:
    """K3's C entry over a fenced 1,000-element table with 4,096 elements
    more than it holds (tail) or starting 16 KB before it (head): the
    fence must end this with an illegal address."""
    n = 1000
    leaf = [torch.zeros(n, device="cuda") for _ in range(3)]
    bc = torch.ones(2, device="cuda")
    ptrs = [t.data_ptr() - (16384 if mode == "head" else 0) for t in leaf]
    table = (ctypes.c_int64 * 4)(*ptrs, n + 4096)
    lib = _build.load_library()
    rc = lib.sml_decay_adam(table, 1, 0.01, 0.9, 0.999, 1e-8, bc.data_ptr(),
                            bc[1:].data_ptr(),
                            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "decay_adam_kernel")
    torch.cuda.synchronize()


# --- -lineinfo leaves the code as it was -------------------------------------

def ptxas_usage(log: str) -> Dict[str, Tuple[int, ...]]:
    """Registers and spill store / load bytes per kernel in a ptxas
    report (``--resource-usage``)."""
    out = {}
    for entry in log.split("Compiling entry function '")[1:]:
        found = [re.search(p, entry) for p in (r"Used (\d+) registers",
                                               r"(\d+) bytes spill stores",
                                               r"(\d+) bytes spill loads")]
        if all(found):
            out[entry.split("'")[0]] = tuple(int(m.group(1)) for m in found)
    return out


def lineinfo_check() -> dict:
    """Every kernel's registers and spills in the library's build log
    against a build of the same sources without ``-lineinfo``."""
    flags = [f for f in _build.NVCC_FLAGS if f != "-lineinfo"]
    nvcc = _build.find_nvcc()
    _build.load_library()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        procs = [subprocess.Popen([nvcc, *flags, "-c", str(u), "-o",
                                   str(Path(tmp) / (u.stem + ".o"))],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for u in sorted(_build.CSRC.glob("*.cu"))]
        without = "".join(p.communicate()[0] for p in procs)
    got, want = ptxas_usage(_build.build_log()), ptxas_usage(without)
    changed = {k: {"lineinfo": got.get(k), "without": v}
               for k, v in want.items() if got.get(k) != v}
    return {"check": "lineinfo", "kernels": len(want),
            "status": "clean" if want and not changed else "errors",
            "changed": changed}


# --- compute-sanitizer -------------------------------------------------------

def find_sanitizer() -> str:
    """``compute-sanitizer`` of the toolkit whose ``nvcc`` builds the
    kernels; raises where there is none."""
    nvcc = Path(_build.find_nvcc())
    for cand in (nvcc.parent / "compute-sanitizer",
                 nvcc.parent.parent / "compute-sanitizer" /
                 "compute-sanitizer"):
        if cand.exists():
            return str(cand)
    raise RuntimeError(f"compute-sanitizer not found beside {nvcc} (looked "
                       f"in {nvcc.parent} and "
                       f"{nvcc.parent.parent / 'compute-sanitizer'}); the "
                       "sanitizer checks cannot run on this host")


_SUMMARY = re.compile(r"(ERROR SUMMARY: (\d+) error|RACECHECK SUMMARY: "
                      r"\d+ hazards? displayed \((\d+) errors?)")


def read_sanitizer(text: str) -> dict:
    """The tool's own summary line and error count, and whether it ran
    at all on this device."""
    lines = [ln.strip(" =") for ln in text.splitlines()]
    summary = [ln for ln in lines if "SUMMARY" in ln]
    unsupported = [ln for ln in lines if "Device not supported" in ln]
    errors = None
    if summary:
        m = _SUMMARY.search(summary[-1])
        if m:
            errors = int(m.group(2) or m.group(3))
    return {"summary": summary[-1] if summary else None,
            "errors": errors,
            "unsupported": unsupported[0] if unsupported else None}


def sanitizer_status(rc, read: dict, result, err: str) -> str:
    """The verdict on one target under one tool: ``clean`` (the target
    ran to its end and the tool counted 0 errors); where the tool refused
    the device, ``unsupported`` if the target never started (no result,
    no Python traceback) and ``failed`` if its process failed; else
    ``errors`` where the tool counted errors, and ``failed``."""
    ran = result is not None and result.get("ok")
    if ran and rc == 0 and read["errors"] == 0:
        return "clean"
    if read["unsupported"]:
        return ("unsupported" if result is None and "Traceback" not in err
                else "failed")
    return "errors" if read["errors"] else "failed"


# --- running checks in subprocesses ------------------------------------------

def _child(args: List[str]) -> List[str]:
    return [sys.executable, "-m", "sml_tpu_torch.scripts.sanitize", *args]


def _last_json(text: str):
    for line in reversed(text.splitlines()):
        if line.startswith("{"):
            try:
                return json.loads(line)
            except ValueError:
                return None
    return None


def _tail(text: str, n: int = 3) -> str:
    return " | ".join(ln.strip() for ln in text.strip().splitlines()[-n:])


def run_check(check: str, target: str, mode: str, sanitizer: str) -> dict:
    """One (target, fence or tool) in a subprocess; its JSON line."""
    env = dict(os.environ)
    if check == "sanitizer":
        cmd = [sanitizer, "--tool", mode, "--error-exitcode", "1",
               *_child(["--target", target])]
        if TARGETS[target].kind == "kernel":
            env["PYTORCH_NO_CUDA_MEMORY_CACHING"] = "1"
    elif check == "fence":
        cmd = _child(["--target", target, "--fence", mode])
    else:
        cmd = _child(["--fence-probe", mode])
    t0 = time.perf_counter()
    # a session of its own, so that a timeout ends the tool and its child
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=TIMEOUT_S)
        rc = proc.returncode
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        rc = None
    line = {"check": check, "target": target, "mode": mode, "rc": rc,
            "seconds": round(time.perf_counter() - t0, 3)}
    result = _last_json(out)
    if check == "sanitizer":
        read = read_sanitizer(out + "\n" + err)
        line.update(errors=read["errors"], summary=read["summary"],
                    unsupported=read["unsupported"])
        status = sanitizer_status(rc, read, result, err)
    elif check == "fence":
        status = "clean" if rc == 0 and result and result.get("ok") else (
            "errors" if ILLEGAL_ADDRESS in err else "failed")
        line["errors"] = 0 if status == "clean" else None
    else:
        status = "caught" if rc not in (0, None) and ILLEGAL_ADDRESS in err \
            else "missed"
    line["status"] = status
    if result is not None:
        line["result"] = {k: v for k, v in result.items()
                          if k in ("cases", "calls", "fence", "max_abs_err",
                                   "graph_stats")}
    if status not in ("clean", "caught"):
        line["stderr"] = _tail(err, 6)
    return line


def run_all(tools=KERNEL_TOOLS) -> int:
    sanitizer = find_sanitizer() if tools else None
    # build once here, not in every child at once
    _build.load_library()
    fence_library()
    checks = [("fence-probe", "-", m) for m in FENCES]
    checks += [("fence", t.name, m) for t in TARGETS.values()
               if t.kind == "kernel" for m in FENCES]
    checks += [("sanitizer", t.name, tool) for t in TARGETS.values()
               for tool in (KERNEL_TOOLS if t.kind == "kernel"
                            else PROGRAM_TOOLS) if tool in tools]
    t0, lines = time.perf_counter(), []
    with concurrent.futures.ThreadPoolExecutor(JOBS) as pool:
        futures = [pool.submit(lineinfo_check)]
        futures += [pool.submit(run_check, c, t, m, sanitizer)
                    for c, t, m in checks]
        for f in futures:
            line = f.result()
            lines.append(line)
            print(json.dumps(line), flush=True)
    counts: Dict[str, int] = {}
    for line in lines:
        counts[line["status"]] = counts.get(line["status"], 0) + 1
    bad = [ln for ln in lines if ln["status"] not in ("clean", "caught")]
    print(json.dumps({"sanitize": "summary", "checks": len(lines),
                      "tools": list(tools), "status": counts,
                      "failed": len(bad),
                      "seconds": round(time.perf_counter() - t0, 3)}),
          flush=True)
    return 1 if bad else 0


def run_target(name: str, device, repeats: int, fence=None) -> dict:
    """One target in this process; raises on a disagreement."""
    target = TARGETS[name]
    t0 = time.perf_counter()
    out = target.run(device, repeats)
    if device.type == "cuda":
        torch.cuda.synchronize()
    out.update(target=name, ok=True, device=str(device),
               seconds=round(time.perf_counter() - t0, 3))
    if fence is not None:
        out["fence"] = fence_stats(fence)
        if out["fence"]["failed"]:
            raise RuntimeError(f"the fence allocator failed "
                               f"{out['fence']['failed']} times")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--target", choices=sorted(TARGETS))
    ap.add_argument("--all", action="store_true",
                    help="every (target, fence) and (target, tool) in "
                    "subprocesses")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fence", choices=FENCES, default=None)
    ap.add_argument("--fence-probe", choices=FENCES, default=None)
    ap.add_argument("--tools", default=",".join(KERNEL_TOOLS),
                    help="with --all: the compute-sanitizer tools to run "
                    "(comma-separated), or 'none'")
    args = ap.parse_args(argv)
    if args.all:
        tools = [] if args.tools == "none" else args.tools.split(",")
        if not set(tools) <= set(KERNEL_TOOLS):
            ap.error(f"--tools takes some of {KERNEL_TOOLS}, or 'none'")
        resolve_device("cuda")
        return run_all(tools)
    if args.fence_probe:
        resolve_device("cuda")
        install_fence(args.fence_probe)
        fence_probe(args.fence_probe)
        print(json.dumps({"fence_probe": args.fence_probe,
                          "caught": False}))
        return 1
    if args.target is None:
        ap.error("give --target, --all or --fence-probe")
    device = resolve_device(args.device)
    fence = None
    if args.fence:
        if device.type != "cuda" or TARGETS[args.target].kind != "kernel":
            ap.error("--fence runs a kernel target on the card")
        fence = install_fence(args.fence)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    print(json.dumps(run_target(args.target, device, REPEATS, fence)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
