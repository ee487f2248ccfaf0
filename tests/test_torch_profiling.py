"""``sml --profile-dir`` on the CPU (``utils/profiling.py``).

* With the flag, the CLI writes one Chrome trace of period
  ``profile_period`` (0), and it holds a span for each engine call the
  driver annotates: ``refresh``, ``make_eval_set``, ``evaluate``,
  ``inner_epoch`` and ``outer_epoch``, and the engine's own spans inside
  ``make_eval_set`` (``eval_set_hash``, ``eval_set_pad_upload``).
* A traced period after period 0 also holds the spans the prefetch
  worker recorded for the next period (``eval_set_hash``), on the
  worker's own thread row, which ``torch.profiler`` does not record.
* Without it, no profiler starts, no span is opened and none is recorded.
"""

import json
import os

import torch

from sml_tpu_torch import cli
from sml_tpu_torch.config import SMLConfig, TransferConfig
from sml_tpu_torch.train.driver import SMLDriver
from sml_tpu_torch.utils import profiling

SPANS = {"refresh", "make_eval_set", "evaluate", "inner_epoch",
         "outer_epoch", "eval_set_hash", "eval_set_pad_upload"}


def _argv(dspec, *extra):
    return ["--device", "cpu", "sml", "--data-root", dspec.root,
            "--data-name", dspec.name, "--num-periods", "8",
            "--online-train-start", "3", "--online-test-start", "5",
            "--multi-num", "1", "--latent", "8", "--mf-sample", "alone",
            "--saddle-retries", "0", "--eval-during-outer", *extra]


def _count_calls(monkeypatch):
    """Profilers started and spans opened (``record_function`` calls)."""
    calls = {"profile": 0, "annotate": 0}
    real_profile = torch.profiler.profile
    real_record = torch.profiler.record_function

    def profile(*a, **kw):
        calls["profile"] += 1
        return real_profile(*a, **kw)

    def record_function(name, *a, **kw):
        calls["annotate"] += 1
        return real_record(name, *a, **kw)
    monkeypatch.setattr(torch.profiler, "profile", profile)
    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    return calls


def test_profile_dir_writes_one_trace_with_spans(synthetic_dataset,
                                                 tmp_path, monkeypatch):
    dspec, _, _ = synthetic_dataset
    calls = _count_calls(monkeypatch)
    prof = tmp_path / "prof"
    assert cli.main(_argv(dspec, "--profile-dir", str(prof))) == 0
    assert calls["profile"] == 1 and calls["annotate"] > 0
    traces = os.listdir(prof)
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(prof / traces[0]) as fh:
        events = json.load(fh)["traceEvents"]
    spans = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert SPANS <= spans
    # the CPU operators of the traced period are in it too
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_later_traced_period_holds_the_workers_spans(synthetic_dataset,
                                                     tmp_path):
    dspec, _, _ = synthetic_dataset
    prof = tmp_path / "prof"
    cfg = SMLConfig(latent_dim=8, multi_num=1, saddle_retries=0,
                    mf_batch_size=64, tr_batch_size=64, eval_batch_size=64,
                    transfer=TransferConfig(latent_dim=8, fc_hidden=32),
                    profile_dir=str(prof), profile_period=1)
    drv = SMLDriver(cfg, dspec, device="cpu")
    try:
        state = drv.engine.adopt(drv.engine.init_state())
        for d in (0, 1):
            state, ok = drv.run_period(state, d)
            assert ok
    finally:
        drv.close()
    (trace,) = os.listdir(prof)
    with open(prof / trace) as fh:
        events = json.load(fh)["traceEvents"]
    main = os.getpid()
    (period,) = [e for e in events if e.get("name") == "period"]
    assert period["tid"] == main
    hashed = [e for e in events if e.get("name") == "eval_set_hash"
              and e.get("ph") == "X" and e["tid"] != main]
    assert len(hashed) == 1
    # on the file's own time base, after the traced period began
    assert hashed[0]["ts"] > period["ts"]
    assert any(e.get("ph") == "M" and e["tid"] == hashed[0]["tid"]
               and e["args"]["name"].startswith("sml-prefetch")
               for e in events)


def test_no_profile_dir_starts_nothing(synthetic_dataset, tmp_path,
                                       monkeypatch):
    dspec, _, _ = synthetic_dataset
    calls = _count_calls(monkeypatch)
    profiling.reset()
    assert cli.main(_argv(dspec)) == 0
    assert calls == {"profile": 0, "annotate": 0}
    assert profiling.summary() == {}
    with profiling.maybe_trace(None) as path:
        assert path is None
    assert calls["profile"] == 0
    assert not list(tmp_path.iterdir())
