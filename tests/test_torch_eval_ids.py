"""Eval rows with ids outside the tables raise one named ``ValueError``.

A user id outside ``[0, n_users)`` or a candidate id outside ``[0,
n_items)`` used to reach the port's indexing (``build_packed_mask``'s
scatter, the gather and matmul pickers; on the card a device-side assert
that ends the process), while the JAX package clamps or drops it and
returns a rank that means nothing. Every place that uploads eval rows now
checks them on the host first (``eval.evaluator.check_eval_ids``):
``SMLEngine.make_eval_set``, ``BaselineDriver``'s eval and the
pretrainer's test rows. Each bad id below raises the same error, naming
the row and the id, through all three, under every scoring mode; rows in
range still equal the JAX evaluator.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sml_tpu.eval import evaluator as JEV
from sml_tpu.models.mf import MFParams as JaxMF
from sml_tpu.ops import batching as JB
from sml_tpu.ops import eval_kernel as JE
from sml_tpu_torch.config import (BaselineConfig, DataSpec, PretrainConfig,
                                  SMLConfig)
from sml_tpu_torch.data.formats import load_test
from sml_tpu_torch.data.synthetic import (SyntheticSpec,
                                          generate_synthetic_dataset)
from sml_tpu_torch.models.mf import MFParams
from sml_tpu_torch.ops.eval_kernel import pad_items
from sml_tpu_torch.train.baselines import BaselineDriver
from sml_tpu_torch.train.engine import SMLEngine
from sml_tpu_torch.train.pretrain import pretrain_mf

USERS, ITEMS, PERIODS, TEST_PERIOD, NEG = 300, 700, 4, 3, 99
MODES = ("masked", "masked_bf16", "gather", "matmul", "auto")
# (name, column, id): below the catalog, in the mask's padding [I, I_pad),
# past the padding, and a user id past the user table
BAD = (("minus_one", 7, -1),
       ("in_padding", 7, ITEMS + 3),
       ("past_padding", 7, pad_items(ITEMS) + 5),
       ("user", 0, USERS))
BAD_ROW = 3
TOPKS = (5, 10, 20)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # many small tensors: one intra-op thread runs them faster than a
    # pool, and a pool slows to a crawl on a CPU shared with other workers
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_ids")
    generate_synthetic_dataset(str(root / "good"), SyntheticSpec(
        n_users=USERS, n_items=ITEMS, n_periods=PERIODS,
        interactions_per_period=400, first_test_period=2, neg_num=NEG,
        seed=7))
    return root


def _spec(root, name):
    return DataSpec(root=str(root), name=name, num_periods=PERIODS,
                    online_train_start=1, online_test_start=TEST_PERIOD,
                    eval_neg_num=NEG)


def _bad_dataset(root, name, col, value):
    """A copy of the good dataset whose test rows of ``TEST_PERIOD`` hold
    ``value`` at ``(BAD_ROW, col)``; returns those rows."""
    if not (root / name).exists():
        shutil.copytree(root / "good", root / name)
        rows = load_test(str(root / name), TEST_PERIOD)
        rows[BAD_ROW, col] = value
        np.save(root / name / "test" / f"{TEST_PERIOD}.npy", rows)
    return load_test(str(root / name), TEST_PERIOD)


def _message(fn) -> str:
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


@pytest.mark.parametrize("bad", BAD, ids=[b[0] for b in BAD])
@pytest.mark.parametrize("mode", MODES)
def test_bad_id_raises_the_same_error_everywhere(dataset, mode, bad):
    name, col, value = bad
    rows = _bad_dataset(dataset, name, col, value)
    spec = _spec(dataset, name)
    engine = SMLEngine(SMLConfig(eval_scoring=mode, latent_dim=8), USERS,
                       ITEMS, device="cpu")
    baseline = BaselineDriver(
        BaselineConfig(method="fine", latent_dim=8, eval_scoring=mode,
                       start_period=TEST_PERIOD), spec, device="cpu")
    messages = {
        "engine": _message(lambda: engine.make_eval_set(rows,
                                                        build_mask=True)),
        "engine_evaluate": _message(lambda: engine.evaluate(
            engine.init_state().mf, rows)),
        "baseline": _message(lambda: baseline.evaluate(rows)),
        "baseline_period": _message(
            lambda: baseline.run_one_period(TEST_PERIOD)),
        "pretrain": _message(lambda: pretrain_mf(
            PretrainConfig(eval_scoring=mode, latent_dim=8, max_epochs=1),
            spec, pretrain_period=TEST_PERIOD, device="cpu")),
    }
    what = "user" if col == 0 else "candidate"
    want = (f"eval row {BAD_ROW}: {what} id {value} (column {col}) is "
            f"outside [0, {USERS if col == 0 else ITEMS})")
    assert set(messages.values()) == {want}, messages
    # nothing was cached or uploaded for the bad rows
    assert not engine._upload_cache


@pytest.mark.parametrize("mode", MODES)
def test_in_range_rows_equal_the_jax_evaluator(dataset, mode):
    """The good dataset's test rows through the port's engine (the check,
    the upload and its mask, then ``evaluate``) and through the JAX
    evaluator on the same integer-valued tables: hits equal, NDCG to
    1e-4 (f32 sums in another order)."""
    rows = load_test(str(dataset / "good"), TEST_PERIOD).astype(np.int32)
    rng = np.random.default_rng(5)
    ue = rng.integers(-2, 3, (USERS, 16)).astype(np.float32)
    ie = rng.integers(-2, 3, (ITEMS, 16)).astype(np.float32)
    cfg = SMLConfig(eval_scoring=mode, latent_dim=16, eval_batch_size=64)
    engine = SMLEngine(cfg, USERS, ITEMS, device="cpu")
    tmf = MFParams(torch.from_numpy(ue), torch.from_numpy(ie),
                   torch.zeros(USERS, 1), torch.zeros(ITEMS, 1))
    padded = engine.make_eval_set(rows, build_mask=True)
    assert (padded.cand_mask is not None) == mode.startswith("masked")
    got = engine.evaluate(tmf, padded)

    jp = JB.pad_rows(rows, 64)
    jcm = (JE.build_packed_mask(jp.rows[:, 2:], ITEMS)
           if mode.startswith("masked") else None)
    jmf = JaxMF(jnp.asarray(ue), jnp.asarray(ie), jnp.zeros((USERS, 1)),
                jnp.zeros((ITEMS, 1)))
    want = jax.jit(JEV.make_eval_fn(TOPKS, 64, scoring=mode))(
        jmf, jp.rows, jp.mask, jcm)
    n = rows.shape[0]
    for k in TOPKS:
        assert got[k]["recall"] * n == pytest.approx(float(want[k][0]),
                                                     abs=1e-3), (mode, k)
        assert got[k]["ndcg"] * n == pytest.approx(float(want[k][1]),
                                                   abs=1e-4), (mode, k)
    assert float(want[20][0]) > 0
