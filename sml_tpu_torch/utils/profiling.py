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
        cupti_settings()
        # CUPTI must not start over work still running on the card (see
        # cupti_settings)
        torch.cuda.synchronize(dev)
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


def cupti_settings() -> None:
    """The CUPTI settings of PyTorch's Kineto that a trace of the card
    needs here: CUPTI torn down at the end of each trace
    (``TEARDOWN_CUPTI=1``) and re-initialised lazily at the next
    (``DISABLE_CUPTI_LAZY_REINIT`` unset); :func:`maybe_trace` also waits
    for the card before its profiler starts.

    Why (torch 2.11, CUDA 12.8, an H100): a replay of a CUDA graph with
    conditional (IF) nodes, the fused programs of ``train/graphs.py``,
    inside a trace died of a segmentation fault in ``cudaGraphLaunch``
    when earlier traces had run in the process. The smallest sequence
    that crashed: two traced blocks with work on the card (an eval set
    made, then an attributed evaluation), a fused program captured and
    replayed untraced, then replayed in a third trace entered while those
    replays still ran. It crashed with every setting of the two variables
    (teardown on or off, lazy re-initialisation on or off) as long as the
    trace started over running work; waiting for the card first cured it
    with teardown on, and with teardown off (CUPTI left attached while the
    program is captured) or lazy re-initialisation off it still crashed.
    The traces keep every kernel, those of the graph's IF-node bodies
    too."""
    os.environ["TEARDOWN_CUPTI"] = "1"
    os.environ.pop("DISABLE_CUPTI_LAZY_REINIT", None)


def annotate(name: str):
    """A named region inside a :func:`maybe_trace` block (a span in the
    timeline); outside one, an empty context that records nothing."""
    if _open_traces:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()
