"""CUDA graphs for the fused programs: the port's counterpart of the JAX
package's one-dispatch XLA programs (``sml_tpu/train/engine.py``
``_build_phase`` / ``_build_period``, and the jitted plain MF epoch of
``sml_tpu/train/pretrain.py`` and ``baselines.py``).

A :class:`Program` is a body on fixed buffers: the caller copies each
run's state and inputs into the program's own buffers, then the body runs.
On the card the site's first body runs eagerly on a side stream (the
warm-up), the program's next run captures it as one CUDA graph
(:class:`CapturedCall`), and every run from then on is a replay, so a
whole SML phase (hundreds of steps, ~400 kernels each) costs the host one
``cudaGraphLaunch``. On the CPU the body runs eagerly: its plain version.
The rules it keeps:

* Capture runs on a side stream with ``capture_error_mode="thread_local"``:
  the prefetch worker (``data/prefetch.py``) keeps uploading the next
  period's data on its own thread and the default stream meanwhile.
* The capture stream must have run the same work eagerly first (cuBLAS
  workspaces, the autograd engine's streams): :func:`run_on` runs a call
  eagerly on a stream, ordered after the current stream's work and before
  what comes after it. The warm-up is a real run, so nothing is trained
  twice.
* Values that change from run to run are device operands, never captured
  host values: the Adam bias corrections (``optim.BiasTable``), the
  sampler's pool size and bloom mask, and which step slots run
  (:class:`SlotTable`). A step slot runs under :func:`step_if`: captured,
  the step is the body of a CUDA-graph IF node on the slot's device
  predicate, so one graph serves every run whatever its row counts (the
  counterpart of the ``lax.cond`` in the JAX package's ``scan_epoch``);
  eagerly, the host's copy of the predicate decides. PyTorch 2.11 has no
  binding for conditional nodes, so ``csrc/graph_if.cu`` makes them with
  the CUDA runtime: the body is captured on a side stream of the capture
  into the node's body graph, its allocations from a memory pool of its
  own (the graph's pool only takes the capture stream's).
* The program owns a generator, registered with the graph
  (``CUDAGraph.register_generator_state``) and captured in place of the
  caller's: a replay takes the caller's generator state in and hands the
  advanced state back (``get_state`` / ``set_state``), so a replay draws
  what the eager body would draw from the caller's generator, and any
  generator (a saddle retry's new stream) replays the same graph. A
  replay advances the generator by every offset the capture reserved, the
  skipped slots' too; the eager epochs skip ahead by as much
  (``train/steps.py``), as the JAX package splits ``nb_max`` keys.
* A replay runs on the current stream, ordered with everything else there.
* Launch counts stay honest: the kernel wrappers count Python calls
  (``<wrapper>.launches``), so a capture would count launches that never
  ran and a replay none that did. A capture records the launches of each
  wrapper in ``_build.COUNTED`` (every wrapper joins it where it is
  defined), those inside each IF node apart, and takes them back; a
  replay adds the launches outside the IF nodes and those of each IF node
  whose slot the host marked taken.
* A capture that fails, or a torch without IF nodes, raises; nothing runs
  the body eagerly instead.
"""

from __future__ import annotations

import contextlib
import time
import weakref
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from sml_tpu_torch import _build

# the captures in progress (a :class:`_Capture` each, innermost last)
_CAPTURES: List["_Capture"] = []
_THREAD_LOCAL = 1          # cudaStreamCaptureModeThreadLocal


class _Capture:
    """What a capture in progress keeps for its IF nodes: the stream their
    bodies are captured on, the memory pool their allocations come from
    (the graph's own pool takes the capture stream's), how often it was
    opened, and the launches recorded inside each body with its slot."""

    def __init__(self, device: torch.device):
        for name in ("_cuda_beginAllocateCurrentStreamToPool",
                     "_cuda_endAllocateToPool", "_cuda_releasePool"):
            if not hasattr(torch._C, name):
                raise RuntimeError(
                    f"this PyTorch has no torch._C.{name} (torch "
                    f"{torch.__version__}); the fused programs' IF nodes "
                    "need it")
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.opened = 0
        self.conditional = []

    def release(self) -> None:
        for _ in range(self.opened):
            torch._C._cuda_releasePool(self.device.index, self.pool)
        self.opened = 0


def _copy_to_device(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` from host memory, ordered on the current stream:
    pinned on the card, so the previous replay may still read ``dst`` and
    the host goes on."""
    if dst.is_cuda:
        dst.copy_(src.pin_memory(), non_blocking=True)
    else:
        dst.copy_(src)


class SlotTable:
    """Which step slots of an epoch run: a ``(slots,)`` bool tensor on the
    device, whose elements a captured step's IF node reads, and the host's
    copy, which the eager runs and the launch accounting read. :meth:`fill`
    marks slots ``[0, taken)``."""

    def __init__(self, slots: int, device):
        self.host = np.zeros(slots, dtype=bool)
        self.dev = torch.zeros(slots, dtype=torch.bool, device=device)

    def fill(self, taken: int) -> None:
        self.host[:] = np.arange(self.host.shape[0]) < taken
        _copy_to_device(self.dev, torch.from_numpy(self.host))


@contextlib.contextmanager
def step_if(slots: SlotTable, b: int):
    """Run a step slot's body where slot ``b`` is taken: yields whether to
    run it. Captured (the slots on a capturing stream, inside a
    :class:`CapturedCall`), the body is recorded on the capture's body
    stream into an IF node on ``slots.dev[b]`` (``csrc/graph_if.cu``;
    yields True) and its launches are set apart for the replays whose host
    slot is taken; eagerly, yields the host's flag. Nothing the body
    allocates may be read after it: a skipped body writes nothing."""
    if not (slots.dev.is_cuda and torch.cuda.is_current_stream_capturing()):
        yield bool(slots.host[b])
        return
    if not _CAPTURES:
        raise RuntimeError("a step slot is captured outside a CapturedCall")
    cap = _CAPTURES[-1]
    lib = _build.load_library()
    parent = torch.cuda.current_stream(cap.device)
    _build.check(lib.sml_if_begin(parent.cuda_stream, cap.stream.cuda_stream,
                                  slots.dev[b].data_ptr(), _THREAD_LOCAL),
                 "sml_if_begin")
    wrappers = list(_build.COUNTED)
    before = [w.launches for w in wrappers]
    try:
        with torch.cuda.stream(cap.stream):
            torch._C._cuda_beginAllocateCurrentStreamToPool(
                cap.device.index, cap.pool)
            cap.opened += 1
            try:
                yield True
            finally:
                torch._C._cuda_endAllocateToPool(cap.device.index, cap.pool)
    finally:
        _build.check(lib.sml_if_end(cap.stream.cuda_stream), "sml_if_end")
    inside = []
    for w, n in zip(wrappers, before):
        if w.launches != n:
            inside.append((w, w.launches - n))
        w.launches = n
    if inside:
        cap.conditional.append((slots, b, inside))


def run_on(stream: torch.cuda.Stream, fn: Callable):
    """``fn()`` eagerly on ``stream``: the stream waits for the current
    stream's work, and the current stream waits for ``fn``'s."""
    cur = torch.cuda.current_stream(stream.device)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        out = fn()
    cur.wait_stream(stream)
    return out


class CapturedCall:
    """``fn()`` captured as one CUDA graph on ``stream`` (which has run
    ``fn``'s work before), replayed by :meth:`replay`. ``generators``: the
    CUDA generators ``fn`` draws from, registered with the graph. ``fn``'s
    host side effects happen once, at capture; its device work happens at
    each replay."""

    def __init__(self, fn: Callable, stream: torch.cuda.Stream,
                 generators: Sequence[torch.Generator] = ()):
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError(
                "this PyTorch cannot register a generator with a CUDA graph "
                f"(torch {torch.__version__}); the fused programs need it")
        self.graph = torch.cuda.CUDAGraph()
        self.generators = tuple(generators)
        for gen in self.generators:
            self.graph.register_generator_state(gen)
        wrappers = list(_build.COUNTED)
        before = [w.launches for w in wrappers]
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        self.capture = _Capture(stream.device)
        # the IF bodies' pool goes with the graph (its references to the
        # pool's memory die first: the graph is this object's)
        weakref.finalize(self, self.capture.release)
        _CAPTURES.append(self.capture)
        try:
            with torch.cuda.graph(self.graph, stream=stream,
                                  capture_error_mode="thread_local"):
                fn()
        finally:
            _CAPTURES.pop()
        # nothing ran: the launches belong to the replays
        self.launches = []
        for w, b in zip(wrappers, before):
            if w.launches != b:
                self.launches.append((w, w.launches - b))
            w.launches = b

    def replay(self, sources: Sequence[torch.Generator] = ()) -> None:
        """One replay; ``sources[i]`` (when given) hands its state to the
        ``i``-th registered generator before it and takes the advanced
        state back after it."""
        for own, src in zip(self.generators, sources):
            own.set_state(src.get_state())
        self.graph.replay()
        for own, src in zip(self.generators, sources):
            src.set_state(own.get_state())
        for w, n in self.launches:
            w.launches += n
        for slots, b, inside in self.capture.conditional:
            if slots.host[b]:
                for w, n in inside:
                    w.launches += n



def new_stats() -> Dict[str, float]:
    """The counts a :class:`GraphSite` keeps: programs made, eager warm-up
    runs on the capture stream, captures, replays, and the host seconds
    spent in warm-ups and captures."""
    return {"programs": 0, "warmups": 0, "captures": 0, "replays": 0,
            "warmup_s": 0.0, "capture_s": 0.0}


class GraphSite:
    """Where programs run on one device: the capture stream (made on first
    use), whether it has run a body eagerly (its warm-up, once per site)
    and the site's :func:`new_stats` counts."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stats = new_stats()
        self._stream = None
        self.warm = False

    def stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream


class Program:
    """A body on fixed buffers (:meth:`body`, drawing from the generator it
    is given). :meth:`launch` runs it once: eagerly on the CPU; on the
    card eagerly on the site's stream while the site is cold (the
    warm-up), then captured once with the program's own generator, then
    replayed. Subclasses copy each run's state and inputs into their
    buffers before :meth:`launch`."""

    def __init__(self, site: GraphSite):
        self.site = site
        self.own = torch.Generator(device=site.device)
        self.call: Optional[CapturedCall] = None
        site.stats["programs"] += 1

    def body(self, gen: torch.Generator) -> None:
        raise NotImplementedError

    def launch(self, gen: torch.Generator) -> None:
        site, stats = self.site, self.site.stats
        if site.device.type != "cuda":
            self.body(gen)
            return
        if self.call is None and not site.warm:
            t0 = time.perf_counter()
            run_on(site.stream(), lambda: self.body(gen))
            site.warm = True
            stats["warmups"] += 1
            stats["warmup_s"] += time.perf_counter() - t0
            return
        if self.call is None:
            t0 = time.perf_counter()
            self.call = CapturedCall(lambda: self.body(self.own),
                                     site.stream(), generators=(self.own,))
            stats["captures"] += 1
            stats["capture_s"] += time.perf_counter() - t0
        self.call.replay(sources=(gen,))
        stats["replays"] += 1


def shape_key(*tensors) -> tuple:
    """The shapes and dtypes of ``tensors`` (None where one is absent): a
    program serves every run whose inputs have them."""
    return tuple(None if t is None else (tuple(t.shape), t.dtype)
                 for t in tensors)


def load_into(dst: Sequence[torch.Tensor],
              src: Sequence[torch.Tensor]) -> None:
    """Copy each ``src`` tensor into its ``dst`` buffer (on the current
    stream), except where it already is that buffer."""
    with torch.no_grad():
        for d, s in zip(dst, src):
            if d.shape != s.shape:
                raise ValueError(f"a program buffer is {tuple(d.shape)}, "
                                 f"its input {tuple(s.shape)}")
            if d.data_ptr() != s.data_ptr():
                d.copy_(s)
