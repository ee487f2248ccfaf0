"""Period prefetch: overlap host-side period IO with device training
(counterpart of ``sml_tpu/data/prefetch.py``).

While the device trains period t, one worker thread reads period t+1's
``.npy`` files and assembles its ``StageData``, so ``next_train`` returns at
once at the period boundary. The optional ``on_prefetch(d_time, sd)`` hook
runs in the worker right after a period is read; the driver uses it to pad
and upload the period's eval sets early. Those uploads go to PyTorch's
default stream of the worker (the same default stream the training thread
uses), so they are ordered with the training work without extra events.
A read queued while the training thread records spans records its own
spans on the worker (``utils/profiling.carry``).

Periods must be requested in strictly increasing ``d_time`` order between
``reinit()`` calls: the inner feeder's test cursor advances on every read,
so once t+1 is prefetched, serving any other period next would read the
wrong test file; the wrapper raises instead.
"""

from __future__ import annotations

import logging
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

from sml_tpu_torch.utils.profiling import carry

_log = logging.getLogger(__name__)


class PrefetchingFeeder:
    def __init__(self, inner):
        self._inner = inner
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="sml-prefetch")
        self._pending: Optional[Future] = None
        self._pending_time: Optional[int] = None
        self.on_prefetch = None

    @property
    def n_users(self) -> int:
        return self._inner.n_users

    @property
    def n_items(self) -> int:
        return self._inner.n_items

    @property
    def info(self):
        return self._inner.info

    def shape_bounds(self) -> dict:
        return self._inner.shape_bounds()

    def reinit(self) -> None:
        self._cancel()
        self._inner.reinit()

    def _cancel(self) -> None:
        if self._pending is not None:
            # the worker only reads period files: wait for it, and let a
            # failed read surface when that period is requested again
            self._pending.exception()
        self._pending = None
        self._pending_time = None

    def next_train(self, d_time: int):
        if self._pending is not None and self._pending_time == d_time:
            fut, self._pending, self._pending_time = self._pending, None, None
            sd = fut.result()
        elif self._pending is not None:
            raise RuntimeError(
                f"PrefetchingFeeder: period {self._pending_time} was "
                f"prefetched but {d_time} was requested; consume periods "
                f"sequentially or call reinit()")
        else:
            sd = self._inner.next_train(d_time)
        if sd.set_t is not None:
            self._pending_time = d_time + 1
            self._pending = self._pool.submit(carry(self._fetch),
                                              d_time + 1)
        return sd

    def _fetch(self, d_time: int):
        sd = self._inner.next_train(d_time)
        hook = self.on_prefetch
        if hook is not None and sd.set_t is not None:
            try:
                hook(d_time, sd)
            except Exception:
                # the hook only warms a cache that the main thread fills
                # itself on a miss; report, do not fail the read
                _log.exception("on_prefetch hook failed for period %d",
                               d_time)
        return sd

    def close(self) -> None:
        self._cancel()
        self._pool.shutdown(wait=True)
