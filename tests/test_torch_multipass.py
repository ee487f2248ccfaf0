"""The multipass loop, resume in the final pass and the news (Adressa)
protocol on the port, held to the JAX package's own tests of them:

* ``tests/test_attribution_multipass.py:112-123``: an explicit
  ``multipass_stop_stage`` (pass 0 stops after one warm-up period, the
  final pass reports every test period once);
* ``tests/test_resume.py:25``: a crash in the middle of the final pass of
  a two-pass run, resumed from the checkpoint's extra as the CLI does,
  reports exactly what the uninterrupted run reports;
* ``tests/test_adressa_protocol.py:47-76``: the derived stop stage 26, the
  ``adressa_sml`` preset through the first three news test periods, and
  the news baseline's early stop after exactly 11 of 40 epochs.

The conftest dataset is the JAX package's; the news dataset is written by
the port's ``generate_synthetic_dataset`` and checked equal to the JAX
package's, so both packages run on the same files.
"""

import json
import os

import numpy as np
import pytest
import torch

from sml_tpu.data.synthetic import SyntheticSpec as JaxSyntheticSpec
from sml_tpu.data.synthetic import generate_synthetic_dataset as jax_synth
from sml_tpu_torch.config import (BaselineConfig, SMLConfig, TransferConfig,
                                  adressa_data, adressa_sml, yelp_data)
from sml_tpu_torch.data.synthetic import (SyntheticSpec,
                                          generate_synthetic_dataset)
from sml_tpu_torch.train.baselines import BaselineDriver
from sml_tpu_torch.train.driver import RunReport, SMLDriver
from sml_tpu_torch.utils import checkpoint as ckpt
from sml_tpu_torch.utils.logging import MetricsLogger

SMALL = dict(multi_num=1, mf_batch_size=256, tr_batch_size=128,
             eval_batch_size=256, latent_dim=8)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # thousands of steps on tensors of a few hundred rows: one intra-op
    # thread runs them several times faster than a pool of them
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg(**kw):
    return SMLConfig(transfer=TransferConfig(latent_dim=8, fc_hidden=32),
                     **SMALL, **kw)


def _kinds(path):
    with open(path) as fh:
        return [json.loads(line)["kind"] for line in fh]


def test_multipass_explicit_stop_stage(synthetic_dataset, tmp_path):
    dspec, _, _ = synthetic_dataset
    log = str(tmp_path / "m.jsonl")
    logger = MetricsLogger(log)
    report = SMLDriver(_cfg(pass_num=2, multipass_stop_stage=1), dspec,
                       logger=logger, device="cpu").run()
    logger.close()
    # pass 0 stops after one warm-up period (no tests); the final pass
    # reports the three test periods exactly once
    assert len(report.test_counts) == 3
    kinds = _kinds(log)
    assert kinds.count("period") == 1 + 4
    assert kinds.count("test") == 3 and kinds[-1] == "summary"


def test_multipass_resume_in_final_pass(synthetic_dataset, tmp_path):
    dspec, _, _ = synthetic_dataset
    cfg = _cfg(mf_sample="alone", pass_num=2)
    report_a = SMLDriver(cfg, dspec, device="cpu").run()
    assert len(report_a.test_counts) == 3

    class Crash(Exception):
        pass

    ck = str(tmp_path / "ck")

    def save_and_maybe_crash(st, pass_id, d_time, drv):
        drv.finalize()
        ckpt.save_checkpoint(ck, pass_id * 100 + d_time, st,
                             extra={"pass_id": pass_id, "period": d_time,
                                    "report": drv.report.to_dict()})
        if pass_id == 1 and d_time == 1:   # after the first test period
            raise Crash()

    driver_b = SMLDriver(cfg, dspec, device="cpu")
    with pytest.raises(Crash):
        driver_b.run(on_period_end=save_and_maybe_crash)
    driver_b.close()
    assert len(driver_b.report.test_counts) == 1

    driver_c = SMLDriver(cfg, dspec, device="cpu")
    extra = ckpt.read_manifest(ck)["extra"]
    driver_c.report = RunReport.from_dict(extra["report"])
    report_c = driver_c.run(ckpt.state_from_checkpoint(ck, device="cpu"),
                            start_pass=int(extra["pass_id"]),
                            start_period=int(extra["period"]) + 1)
    assert report_c.test_counts == report_a.test_counts
    for k, vals in report_a.per_period.items():
        np.testing.assert_array_equal(report_c.per_period[k], vals)
    sa, sc = report_a.summary(), report_c.summary()
    for key, v in sa.items():
        if key != "total_seconds":
            assert sc[key] == v, (key, sc[key], v)


@pytest.fixture(scope="module")
def news_dataset(tmp_path_factory):
    """The JAX test's news dataset, written by the port and checked equal
    to the JAX package's."""
    root = str(tmp_path_factory.mktemp("adressa"))
    kw = dict(n_users=150, n_items=400, n_periods=63,
              interactions_per_period=220, first_test_period=21, neg_num=30,
              new_entity_rate=0.01, latent_dim=4, drift=0.05, seed=5)
    generate_synthetic_dataset(f"{root}/news", SyntheticSpec(**kw))
    jax_synth(f"{root}/jax_news", JaxSyntheticSpec(**kw))
    for d, _, files in os.walk(f"{root}/news"):
        for f in files:
            mine = np.load(os.path.join(d, f))
            ref = np.load(os.path.join(d.replace("/news", "/jax_news"), f))
            assert mine.dtype == ref.dtype
            np.testing.assert_array_equal(mine, ref)
    return root


def test_news_multipass_stop_stage_derived(news_dataset):
    """Yelp derives the reference's hardcoded 19; news derives 26."""
    cfg = adressa_sml().replace(
        latent_dim=8, transfer=TransferConfig(latent_dim=8),
        prefetch_periods=False)
    drv = SMLDriver(cfg, adressa_data(news_dataset), device="cpu")
    assert drv._stop_stage == 26
    yspec = yelp_data("/x")
    assert yspec.online_test_start - yspec.online_train_start - 1 == 19


def test_adressa_sml_preset_runs_through_test_span(news_dataset):
    cfg = adressa_sml().replace(
        latent_dim=8, transfer=TransferConfig(latent_dim=8),
        mf_batch_size=64, tr_batch_size=64, eval_batch_size=64,
        prefetch_periods=False)
    report = SMLDriver(cfg, adressa_data(news_dataset),
                       device="cpu").run(max_periods=29)
    # d_time 26-28 test periods 48-50
    assert len(report.test_counts) == 3
    for k in (5, 10, 20):
        assert len(report.per_period[k]) == 3
        assert all(0.0 <= v <= 1.0 for v in report.per_period[k])
    assert max(report.per_period[20]) > 0.2


def test_news_baseline_early_stop_active(news_dataset):
    """With lr=0 the metric never improves, so the news rule (evaluate
    every 5 epochs, stop once more than 5 epochs pass without a new best)
    stops after exactly 11 of the 40 epochs."""
    def steps_done(pool_init_type, early_stop):
        cfg = BaselineConfig(method="fine", lr=0.0, epochs=40, batch_size=64,
                             pool_init_type=pool_init_type,
                             early_stop=early_stop, start_period=48,
                             latent_dim=8, eval_batch_size=64)
        drv = BaselineDriver(cfg, adressa_data(news_dataset), device="cpu")
        drv.run(max_periods=1)
        return drv.opt.count

    free = steps_done(0, False)
    news = steps_done(1, False)
    forced = steps_done(0, True)
    assert news < free
    assert news == forced
    assert news == 11 * (free // 40)
