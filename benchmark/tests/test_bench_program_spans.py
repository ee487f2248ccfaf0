"""The per-layer metrics that read the program's own spans
(``sml_tpu_torch.utils.profiling.summary()``) in a traced run at the tiny
shapes of ``data/``: each is in the line with a finite value, and the
per-layer metrics the same run read before the program had spans still
read. On the CPU the phase programs run eagerly, so nothing is replayed
and ``replay_launch_ms.sweep`` has nothing to read; on a card it does."""

import json
import math

import pytest

from bench_tiny import DATA, run_cell

SPANS = {"yelp5m1m.sweep": {"eager_phase_ms.sweep", "prep_ms.sweep",
                            "eval_hash_ms.sweep"},
         "c5.serve": {"serve_host_ms.serve"}}
# what a traced CPU run read before the program recorded spans
BEFORE = {"yelp5m1m.sweep": {"data_ms.sweep", "test_ms.sweep", "sweep_mfu"},
          "c5.serve": {"serve_mfu"}}


def _finite(out, names):
    for n in names:
        assert n in out["metrics"], n
        assert math.isfinite(out["metrics"][n]["value"]), n
        assert out["metrics"][n]["value"] > 0, n


@pytest.mark.parametrize("workload,kind", [("yelp5m1m.sweep", "sweep"),
                                           ("c5.serve", "serve")])
def test_program_span_metrics_read_on_the_cpu(capsys, workload, kind):
    from sml_tpu_torch.utils import profiling
    profiling.reset()
    out = run_cell(capsys, workload, kind, seed=2 ** 31 + 4321, trace=1)
    profiling.reset()
    assert out["correct"] is True
    _finite(out, SPANS[workload] | BEFORE[workload])
    assert "replay_launch_ms.sweep" not in out["metrics"]


def test_untraced_run_records_no_span(capsys):
    from sml_tpu_torch.utils import profiling
    profiling.reset()
    out = run_cell(capsys, "c5.serve", "serve", seed=2 ** 31 + 4322)
    assert out["correct"] is True and profiling.summary() == {}


@pytest.mark.cuda
def test_program_span_metrics_read_on_the_card(cuda_card, capsys):
    """The fused sweep on a card replays its captured programs in the
    window: ``replay_launch_ms.sweep`` reads the replays' launches."""
    import run
    from sml_tpu_torch.utils import profiling
    profiling.reset()
    assert run.main(["--workload", "yelp5m1m.sweep", "--seed", "2147487001",
                     "--seconds", "0.5", "--trace", "1",
                     "--config-file", str(DATA / "sweep_config.json"),
                     "--traffic-file", str(DATA / "sweep_traffic.json")]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    summary = profiling.summary()
    profiling.reset()
    assert out["correct"] is True
    _finite(out, SPANS["yelp5m1m.sweep"] | {"replay_launch_ms.sweep",
                                             "data_ms.sweep", "test_ms.sweep",
                                             "replay_ms.sweep", "sweep_mfu",
                                             "device_idle_pct.sweep"})
    assert summary["graph_launch"]["count"] > 0
