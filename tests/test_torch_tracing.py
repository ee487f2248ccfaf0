"""The port's span recorder (``utils/profiling.py``) on the CPU.

* Inside a plain ``torch.profiler.profile`` on the main thread (not
  ``maybe_trace``), a branch-C period records its spans: the period, the
  branch, the eager phase 0, the steps, the pools' preparation.
* The next period's eval set is hashed on the prefetch worker, and that
  span is recorded there with the main-thread span that queued it as its
  parent (``torch.profiler`` itself records only its own thread).
* The recorded spans share the trace's clock: the ``period`` span starts
  where the profiler's event of that name does.
* ``summary()``'s self time is the total less what the children on the
  span's own thread cover.
* One ``recommend`` call records each of its five spans once.
"""

import threading

import numpy as np
import pytest
import torch

from sml_tpu_torch.config import SMLConfig, TransferConfig
from sml_tpu_torch.eval.full_ranking import recommend
from sml_tpu_torch.models.mf import MFParams
from sml_tpu_torch.train.driver import SMLDriver
from sml_tpu_torch.utils import profiling
from sml_tpu_torch.utils.profiling import Span, summarize

MAIN = threading.main_thread().native_id


@pytest.fixture(scope="module")
def traced_period(synthetic_dataset):
    """Period 0 (branch A) untraced, then period 1 (the first branch C)
    inside a plain profiler: ``(spans, kineto events)``, the spans taken
    once the prefetch of period 2 has run."""
    dspec, _, _ = synthetic_dataset
    cfg = SMLConfig(latent_dim=8, multi_num=2, saddle_retries=0,
                    mf_batch_size=64, tr_batch_size=64, eval_batch_size=64,
                    transfer=TransferConfig(latent_dim=8, fc_hidden=32))
    drv = SMLDriver(cfg, dspec, device="cpu")
    try:
        state = drv.engine.adopt(drv.engine.init_state())
        state, ok = drv.run_period(state, 0)
        assert ok
        profiling.reset()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            state, ok = drv.run_period(state, 1)
        assert ok
    finally:
        drv.close()          # waits for period 2's prefetch
    spans = profiling._RECORDER.spans()
    profiling.reset()
    return spans, list(prof.profiler.kineto_results.events())


def test_plain_profiler_records_a_branch_c_period(traced_period):
    spans, _ = traced_period
    names = {s.name for s in spans}
    assert {"period", "branch_c", "phase0", "outer_step",
            "prep_outer"} <= names
    assert "branch_a" not in names
    by_id = {s.id: s for s in spans}
    phase0 = [s for s in spans if s.name == "phase0"]
    assert len(phase0) == 1 and by_id[phase0[0].parent].name == "branch_c"
    # the main thread's spans are in the profiler's trace too
    assert all(s.traced for s in spans if s.thread == MAIN)


def test_next_eval_set_is_hashed_on_the_worker(traced_period):
    spans, _ = traced_period
    by_id = {s.id: s for s in spans}
    worker = [s for s in spans if s.name == "eval_set_hash"
              and s.thread != MAIN]
    assert len(worker) == 1 and not worker[0].traced
    assert worker[0].thread_name.startswith("sml-prefetch")
    # its parent chain reaches the main-thread span that queued the read
    up = by_id[worker[0].parent]
    while up.thread != MAIN:
        up = by_id[up.parent]
    assert up.name == "period"
    assert summarize(spans)["eval_set_hash"]["count"] >= 1


def test_spans_share_the_traces_clock(traced_period):
    spans, events = traced_period
    (period,) = [s for s in spans if s.name == "period"]
    (event,) = [e for e in events if e.name() == "period"]
    assert abs(event.start_ns() - period.start_ns) < 1_000_000


def test_self_time_is_the_total_less_the_childrens_cover():
    def span(i, name, start, end, parent=None, thread=1):
        return Span(name, thread, "t", start, end, i, parent, False)
    nest = [span(1, "a", 0, 100),
            span(2, "b", 10, 30, 1), span(3, "b", 50, 60, 1),
            span(4, "c", 20, 25, 2),
            # a child on another thread runs beside its parent: no cover
            span(5, "w", 40, 90, 1, thread=2),
            # children that overlap are covered once
            span(6, "a", 200, 300), span(7, "d", 210, 260, 6),
            span(8, "d", 240, 280, 6)]
    got = summarize(nest)
    assert got["a"]["count"] == 2
    assert got["a"]["total_s"] == pytest.approx(200e-9)
    assert got["a"]["self_s"] == pytest.approx((100 - 30) * 1e-9
                                               + (100 - 70) * 1e-9)
    assert got["b"]["self_s"] == pytest.approx((20 - 5 + 10) * 1e-9)
    assert got["c"]["self_s"] == got["c"]["total_s"]
    assert got["w"]["self_s"] == pytest.approx(50e-9)


def test_recommend_records_its_five_spans_once():
    g = torch.Generator().manual_seed(3)
    mf = MFParams(torch.randn(40, 8, generator=g),
                  torch.randn(90, 8, generator=g),
                  torch.zeros(40, 1), torch.zeros(90, 1))
    profiling.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        recommend(mf, torch.from_numpy(np.array([3, 7, 11])), 5)
    got = profiling.summary()
    profiling.reset()
    assert {k: v["count"] for k, v in got.items()} == {
        "recommend": 1, "recommend_upload": 1, "recommend_gather": 1,
        "recommend_score": 1, "recommend_select": 1}
    assert got["recommend"]["self_s"] < got["recommend"]["total_s"]
