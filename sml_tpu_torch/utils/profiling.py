"""Profiler hooks (counterpart of ``sml_tpu/utils/profiling.py``).

Per-period timing goes through :mod:`sml_tpu_torch.utils.logging`; traces
come from ``torch.profiler`` through :func:`maybe_trace`, one Chrome trace
(``.json``, viewable in Perfetto or ``chrome://tracing``) per traced block.
:func:`annotate` names a region inside a trace, and opens nothing while no
trace is being taken.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

# maybe_trace blocks now open (annotate is a no-op while this is 0)
_open_traces = 0


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str],
                device="cpu") -> Iterator[Optional[str]]:
    """Trace the enclosed block when ``trace_dir`` is given, else start
    nothing (and yield None).

    The trace holds the host's activity, and the card's kernels and copies
    when ``device`` is a CUDA device; the device is synchronised before the
    profiler stops, so work launched inside the block is in the trace. The
    block gets the trace file's path, ``<trace_dir>/trace_<ns>.json``,
    which is written when the block ends without an exception."""
    if not trace_dir:
        yield None
        return
    dev = torch.device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
        cupti_teardown()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"trace_{time.time_ns()}.json")
    global _open_traces
    with torch.profiler.profile(activities=activities) as prof:
        _open_traces += 1
        try:
            yield path
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        finally:
            _open_traces -= 1
    prof.export_chrome_trace(path)


def cupti_teardown() -> None:
    """Have the profiler tear CUPTI down at the end of each trace (the
    ``TEARDOWN_CUPTI`` setting of PyTorch's Kineto): a CUDA graph with
    conditional nodes (the fused programs, ``train/graphs.py``) captured
    while an earlier trace's CUPTI stays attached crashes the process when
    a later trace sees it launched (torch 2.11, CUDA 12.8 on an H100).
    A value the caller set stays."""
    os.environ.setdefault("TEARDOWN_CUPTI", "1")


def annotate(name: str):
    """A named region inside a :func:`maybe_trace` block (a span in the
    timeline); outside one, an empty context that records nothing."""
    if _open_traces:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()
