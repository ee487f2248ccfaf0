"""``python -m sml_tpu_torch.scripts.multicard_check`` on 2 CPU ranks: the
collectives, the dry run and the R-process CLI against one process all
agree, and the script prints one JSON document and exits 0; without a
card its default device raises."""

import contextlib
import io
import json

import pytest
import torch

from sml_tpu_torch.scripts import multicard_check


def test_two_cpu_ranks_agree():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = multicard_check.main(["--ranks", "2", "--device", "cpu"])
    report = json.loads(buf.getvalue())
    assert rc == 0 and report["failed"] == []
    assert report["collectives"]["transport"] == "gloo"
    assert report["dryrun"]["mesh"] == {"data": 1, "model": 2}
    cli = report["cli"]
    assert cli["sml"]["table_max_abs_err"] <= multicard_check.TABLE_ATOL
    assert cli["sml"]["hit_diff"] <= multicard_check.HIT_TOL
    assert cli["rank_shard"]["same_text"]


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        multicard_check.main(["--ranks", "2"])
