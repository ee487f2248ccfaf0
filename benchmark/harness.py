"""What every cell shares: the manifest and the files a cell is made of,
the run's clocks and caches, the profiler window and its reduction to
device time, the per-layer metric readers, and the result line.

Nothing here imports the program; the drivers (``drivers/<kind>.py``) do.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from bisect import bisect_right
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# what the process may not hold once the window has closed, compared by
# whole top-level module names
FORBIDDEN = ("jax", "jaxlib", "flax", "sml_tpu")


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    """The workload entry ``name`` with its configuration, traffic mix and
    correctness limits loaded (``configs/<config>.json`` from the
    configuration's ``file``, ``traffic/<traffic>.json``,
    ``limits/<workload>.json``)."""
    man = manifest()
    work = {w["name"]: w for w in man["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    return {
        "workload": w,
        "config": load_json(ROOT / conf["file"]),
        "traffic": load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        "limits": load_json(BENCH / "limits" / f"{name}.json"),
        "end_to_end": [m for m in man["end_to_end"]
                       if name in m.get("workloads", [name])],
        "per_layer": [m for m in man["per_layer"]
                      if name in m.get("workloads", [name])],
    }


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (``build/`` is not committed): only a cell's first run there builds.
    The port's own kernel library lives in ``build/kernels``."""
    base = ROOT / "build" / "bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(base / sub)


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as fh:
        fields = fh.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as fh:
        return float(fh.read().split()[0]) - start


def forbidden_loaded() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


# ------------------------------------------------------------- tracing
class Trace:
    """``torch.profiler`` over the measured window (CPU and CUDA
    activities), started after the card is idle and stopped after it has
    finished the window's work. :meth:`digest` reduces it to device time."""

    def __init__(self, torch, device):
        self.torch, self.device = torch, device
        self.prof = None

    def __enter__(self):
        torch = self.torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            # the port's CUPTI settings for traces over CUDA graphs with IF
            # nodes: CUPTI torn down after each trace
            os.environ["TEARDOWN_CUPTI"] = "1"
            os.environ.pop("DISABLE_CUPTI_LAZY_REINIT", None)
            torch.cuda.synchronize(self.device)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        return False

    def events(self):
        """``(device_events, host_events)``: device operations as ``(name,
        start_us, end_us, correlation)``, host events (runtime calls and
        user spans) as ``(name, start_us, end_us, correlation, thread)``."""
        dev, host = [], []
        cuda = self.torch.autograd.DeviceType.CUDA
        for e in self.prof.profiler.kineto_results.events():
            s = e.start_ns() / 1e3
            row = (e.name(), s, s + e.duration_ns() / 1e3)
            if e.device_type() == cuda:
                # a record_function span is mirrored on the device's
                # timeline as an annotation: no operation
                if not (e.is_user_annotation()
                        or e.name().startswith("bench.")):
                    dev.append(row + (e.linked_correlation_id()
                                      or e.correlation_id(),))
            else:
                host.append(row + (e.correlation_id(), e.start_thread_id()))
        return dev, host


def union(intervals) -> List[List[float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def digest(trace: Trace, spans=()) -> dict:
    """Device time of the traced window: ``busy_s`` (the union of the
    device operations' intervals), ``ops`` (seconds by name),
    ``span_device_s`` (for each host span name in ``spans``, the union of
    the device operations launched by runtime calls made inside its
    spans, on its thread: a CUDA graph's kernels belong to its launch) and
    the idle gaps between device operations, each named by the innermost
    of ``spans`` the host was in at the gap's middle."""
    import numpy as np
    dev, host = trace.events()
    merged = union((s, e) for _, s, e, _ in dev)
    busy = sum(e - s for s, e in merged)
    ops: Dict[str, float] = {}
    by_corr: Dict[int, list] = {}
    for name, s, e, c in dev:
        ops[name] = ops.get(name, 0.0) + (e - s) / 1e6
        if c:
            by_corr.setdefault(c, []).append((s, e))
    span_rows = sorted((h for h in host if h[0] in spans),
                       key=lambda h: h[1])
    runtime = sorted((s, c, t) for name, s, e, c, t in host
                     if c and c in by_corr and name not in spans)
    starts = [r[0] for r in runtime]
    span_device_s = {}
    for name in spans:
        corr = set()
        for n, s, e, _, t in span_rows:
            if n != name:
                continue
            for k in range(bisect_right(starts, s), len(runtime)):
                rs, c, rt = runtime[k]
                if rs > e:
                    break
                if rt == t:
                    corr.add(c)
        if corr:
            span_device_s[name] = sum(
                b - a for a, b in union(iv for c in corr
                                        for iv in by_corr[c])) / 1e6
    # gaps under 20 us are launch and dependency latencies between
    # back-to-back operations: summed under one name
    gaps: Dict[str, float] = {}
    if len(merged) > 1:
        m = np.asarray(merged)
        lo, hi = m[:-1, 1], m[1:, 0]
        width = hi - lo
        short = width < 20.0
        gaps["between operations (<20 us)"] = float(width[short].sum()) / 1e6
        mid = ((lo + hi) / 2)[~short]
        wide = width[~short]
        best = np.full(mid.shape, np.inf)
        who = np.full(mid.shape, -1)
        for k, name in enumerate(spans):
            iv = np.asarray([(h[1], h[2]) for h in span_rows
                             if h[0] == name]).reshape(-1, 2)
            if not len(iv):
                continue
            at = np.searchsorted(iv[:, 0], mid, side="right") - 1
            ok = at >= 0
            inside = np.zeros(mid.shape, dtype=bool)
            inside[ok] = mid[ok] <= iv[at[ok], 1]
            dur = np.where(inside, (iv[:, 1] - iv[:, 0])[np.maximum(at, 0)],
                           np.inf)
            take = dur < best
            best[take], who[take] = dur[take], k
        for k in np.unique(who):
            what = spans[k] if k >= 0 else "outside the spans"
            gaps[what] = float(wide[who == k].sum()) / 1e6
    return {"busy_s": busy / 1e6, "window_s": trace.window_s, "ops": ops,
            "span_device_s": span_device_s, "idle_gaps": gaps,
            "device_events": len(dev)}


def breakdown(dig: dict) -> dict:
    top = sorted(dig["ops"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(dig["idle_gaps"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:200], s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in gaps]}


def ops_matching(dig: dict, parts) -> float:
    """Device seconds of the operations whose name holds one of ``parts``."""
    return sum(s for n, s in dig["ops"].items()
               if any(p in n for p in parts))


# ------------------------------------------------------------- metrics
def read_metric(name: str, ctx: dict) -> Optional[float]:
    """The per-layer metric ``name`` from ``metrics/<name>.py``'s
    ``read(ctx)``; None when it finds nothing to read."""
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_')}",
        BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    value = mod.read(ctx)
    if value is None or not math.isfinite(value):
        return None
    return float(value)


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, tuple], device: dict,
                checks: Dict[str, tuple], trace_breakdown=None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed),
           "metrics": {k: {"value": v, "unit": u}
                       for k, (v, u) in metrics.items()},
           "device": device}
    if trace_breakdown is not None:
        out["breakdown"] = trace_breakdown
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return json.dumps(out)


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """``(correct, checks)``: every number at or under its limit (a
    missing or non-finite number fails)."""
    checks, ok = {}, True
    for name, lim in limits.items():
        v = numbers.get(name)
        checks[name] = (v, lim)
        if v is None or not math.isfinite(v) or v > lim:
            ok = False
    return ok, checks
