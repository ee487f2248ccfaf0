"""CUDA graphs for the fused phase and period programs: the port's
counterpart of the JAX package's one-dispatch XLA programs
(``sml_tpu/train/engine.py`` ``_build_phase`` / ``_build_period``).

A :class:`CapturedCall` captures a callable once as a CUDA graph and
replays it, so a whole SML phase (hundreds of steps, ~400 kernels each)
costs the host one ``cudaGraphLaunch``. The rules it keeps:

* Capture runs on a side stream with ``capture_error_mode="thread_local"``:
  the prefetch worker (``data/prefetch.py``) keeps uploading the next
  period's data on its own thread and the default stream meanwhile.
* The capture stream must have run the same work eagerly first (cuBLAS
  workspaces, the autograd engine's streams): :func:`run_on` runs a call
  eagerly on a stream, ordered after the current stream's work and before
  what comes after it. The engine's warm-up is a real phase, so nothing is
  trained twice.
* Random generators the callable draws from are registered with the graph
  (``CUDAGraph.register_generator_state``): a replay draws what the eager
  call would draw from the generator's position at that time, and advances
  it as far.
* A replay runs on the current stream, ordered with everything else there.
* Launch counts stay honest: the kernel wrappers count Python calls
  (``<wrapper>.launches``), so a capture would count launches that never
  ran and a replay none that did. A capture records the launches of each
  wrapper in ``_build.COUNTED`` (every wrapper joins it where it is
  defined) and takes them back; every replay adds them.
* A capture that fails raises; nothing runs the call eagerly instead.

The stream, the capture and the replay are CUDA-only; on the CPU the
engine runs the same phase function eagerly (``train/engine.py``).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from sml_tpu_torch import _build


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
    CUDA generators ``fn`` draws from. ``fn``'s host side effects happen
    once, at capture; its device work happens at each replay."""

    def __init__(self, fn: Callable, stream: torch.cuda.Stream,
                 generators: Sequence[torch.Generator] = ()):
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError(
                "this PyTorch cannot register a generator with a CUDA graph "
                f"(torch {torch.__version__}); the fused programs need it")
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)
        wrappers = list(_build.COUNTED)
        before = [w.launches for w in wrappers]
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        with torch.cuda.graph(self.graph, stream=stream,
                              capture_error_mode="thread_local"):
            self.result = fn()
        # nothing ran: the launches belong to the replays
        self.launches = []
        for w, b in zip(wrappers, before):
            if w.launches != b:
                self.launches.append((w, w.launches - b))
            w.launches = b

    def replay(self) -> None:
        self.graph.replay()
        for w, n in self.launches:
            w.launches += n
