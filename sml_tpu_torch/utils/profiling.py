"""Profiler hooks and the port's span recorder (counterpart of
``sml_tpu/utils/profiling.py``).

Per-period timing goes through :mod:`sml_tpu_torch.utils.logging`; traces
come from ``torch.profiler`` through :func:`maybe_trace`, one Chrome trace
(``.json``, viewable in Perfetto or ``chrome://tracing``) per traced block.

:func:`annotate` names a region of the program, a span. The spans are kept
by one :class:`Recorder`:

* A span records while a torch profiler is on in the calling thread
  (:func:`maybe_trace`, a benchmark's window, any
  ``torch.profiler.profile``), and inside a task that :func:`carry` wrapped
  on a thread that was recording then. ``torch.profiler`` records only the
  thread that started it, so without the carry a worker's spans (the
  prefetch worker's eval sets) would be lost.
* Each span is kept in memory: its name, its thread, its start and end on
  ``time.time_ns()`` (the clock Kineto stamps host events on, so the spans
  line up with a trace's device operations) and the span it ran under.
  Where the thread's profiler is on, the span also opens
  ``torch.profiler.record_function``, so the trace shows it beside the
  device's operations.
* :func:`summary` gives per name the count, the total and the self seconds;
  :func:`reset` empties the table.
* With nothing recording, :func:`annotate` makes one check and returns a
  shared empty context. A span inside a CUDA-graph capture opens once, when
  the body is captured; a replay runs no Python and opens none.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional

import torch

# whether a torch profiler is on in the calling thread (~64 ns)
_profiler_on = torch._C._autograd._profiler_enabled


class Span(NamedTuple):
    """One recorded span; ``traced``: it opened a ``record_function``, so
    the profiler's own trace holds it."""
    name: str
    thread: int
    thread_name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    traced: bool


class _ThreadState(threading.local):
    def __init__(self):
        # this thread's open spans, innermost last; inside a task that a
        # recording thread queued, that thread's span it ran under
        self.open: List[int] = []
        self.carried = False
        self.root: Optional[int] = None


class _Open:
    """One span while it is open (:func:`annotate`)."""
    __slots__ = ("rec", "name", "id", "parent", "start", "rf")

    def __init__(self, rec: "Recorder", name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        st = rec._thread
        self.id = next(rec._ids)
        self.parent = st.open[-1] if st.open else st.root
        st.open.append(self.id)
        self.start = time.time_ns()
        self.rf = None
        if _profiler_on():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        end = time.time_ns()
        self.rec._thread.open.pop()
        th = threading.current_thread()
        self.rec._add(Span(self.name, th.native_id, th.name, self.start, end,
                           self.id, self.parent, self.rf is not None))
        return False


class Recorder:
    """The spans of a process (:func:`annotate` uses one), kept in memory
    until :meth:`reset`."""

    def __init__(self):
        self._cond = threading.Condition()
        self._spans: List[Span] = []
        self._ids = itertools.count(1)
        self._queued = 0
        self._thread = _ThreadState()

    def recording(self) -> bool:
        """Whether the calling thread records spans."""
        return _profiler_on() or self._thread.carried

    def carry(self, fn: Callable) -> Callable:
        """``fn`` as a task for another thread that records its spans, as
        children of the caller's open span, when the caller records now;
        else ``fn`` itself. A wrapped task counts as queued until it has
        run (:meth:`wait_queued`), so it must be run."""
        if not self.recording():
            return fn
        st = self._thread
        parent = st.open[-1] if st.open else st.root
        with self._cond:
            self._queued += 1

        def task(*args, **kwargs):
            st = self._thread
            saved = st.carried, st.root
            st.carried, st.root = True, parent
            try:
                return fn(*args, **kwargs)
            finally:
                st.carried, st.root = saved
                with self._cond:
                    self._queued -= 1
                    self._cond.notify_all()
        return task

    def wait_queued(self) -> None:
        """Wait until every task :meth:`carry` wrapped has run."""
        with self._cond:
            self._cond.wait_for(lambda: self._queued == 0)

    def _add(self, span: Span) -> None:
        with self._cond:
            self._spans.append(span)

    def spans(self) -> List[Span]:
        with self._cond:
            return list(self._spans)

    def reset(self) -> None:
        with self._cond:
            self._spans.clear()


def summarize(spans: List[Span]) -> Dict[str, Dict[str, float]]:
    """Per span name: ``count``, ``total_s`` and ``self_s``, the total less
    the part of each span its children on its own thread cover (a child on
    another thread, a queued task's, runs beside it and takes nothing)."""
    kids: Dict[int, List[Span]] = {}
    for s in spans:
        if s.parent is not None:
            kids.setdefault(s.parent, []).append(s)
    out: Dict[str, Dict[str, float]] = {}
    for s in spans:
        cover, reach = 0, s.start_ns
        for c in sorted((c for c in kids.get(s.id, ())
                         if c.thread == s.thread), key=lambda c: c.start_ns):
            lo, hi = max(c.start_ns, reach), min(c.end_ns, s.end_ns)
            if hi > lo:
                cover += hi - lo
                reach = hi
        row = out.setdefault(s.name, {"count": 0, "total_s": 0.0,
                                      "self_s": 0.0})
        row["count"] += 1
        row["total_s"] += (s.end_ns - s.start_ns) / 1e9
        row["self_s"] += (s.end_ns - s.start_ns - cover) / 1e9
    return out


_RECORDER = Recorder()
_NULL = contextlib.nullcontext()


def annotate(name: str):
    """A span named ``name`` where the calling thread records (see the
    module's docstring); elsewhere a shared empty context."""
    if _RECORDER.recording():
        return _Open(_RECORDER, name)
    return _NULL


def carry(fn: Callable) -> Callable:
    """``fn`` as a task that records its spans on the thread that runs it
    when the caller records now (:meth:`Recorder.carry`)."""
    return _RECORDER.carry(fn)


def summary() -> Dict[str, Dict[str, float]]:
    """The recorded spans by name: ``count``, ``total_s``, ``self_s``."""
    return summarize(_RECORDER.spans())


def reset() -> None:
    """Forget every recorded span."""
    _RECORDER.reset()


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str],
                device="cpu") -> Iterator[Optional[str]]:
    """Trace the enclosed block when ``trace_dir`` is given, else start
    nothing (and yield None).

    The trace holds the host's activity, and the card's kernels and copies
    when ``device`` is a CUDA device; the device is synchronised before the
    profiler stops, so work launched inside the block is in the trace. The
    block gets the trace file's path, ``<trace_dir>/trace_<ns>.json``,
    which is written when the block ends without an exception, once the
    tasks it queued with :func:`carry` have run: their spans, which the
    profiler does not see, are added to it on their threads' rows."""
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
    since = time.time_ns()
    with torch.profiler.profile(activities=activities) as prof:
        yield path
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    _RECORDER.wait_queued()
    prof.export_chrome_trace(path)
    _add_spans(path, [s for s in _RECORDER.spans()
                      if not s.traced and s.start_ns >= since])


def _add_spans(path: str, spans: List[Span]) -> None:
    """Write ``spans`` into the Chrome trace at ``path`` as complete
    events on their threads' rows, at the file's own time base."""
    if not spans:
        return
    with open(path) as fh:
        trace = json.load(fh)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = trace.setdefault("traceEvents", [])
    for tid, tname in {s.thread: s.thread_name for s in spans}.items():
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": tname}})
    for s in spans:
        events.append({"ph": "X", "cat": "user_annotation", "name": s.name,
                       "pid": pid, "tid": s.thread,
                       "ts": (s.start_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"span": s.id, "parent": s.parent}})
    with open(path, "w") as fh:
        json.dump(trace, fh)


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
