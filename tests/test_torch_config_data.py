"""The port's own copies of the config and the dataset format match the
JAX package's field for field and file for file."""

import dataclasses

import numpy as np
import pytest

from sml_tpu import config as JC
from sml_tpu.data import formats as JF
from sml_tpu_torch import config as C
from sml_tpu_torch.data import formats as F


@pytest.mark.parametrize("name", ["DataSpec", "TransferConfig", "SMLConfig"])
def test_config_fields_and_defaults_match(name):
    jcls, tcls = getattr(JC, name), getattr(C, name)

    def fields(cls):
        out = {}
        for f in dataclasses.fields(cls):
            if f.default is not dataclasses.MISSING:
                out[f.name] = f.default
            elif f.default_factory is not dataclasses.MISSING:
                out[f.name] = dataclasses.asdict(f.default_factory())
            else:
                out[f.name] = "<required>"
        return out

    assert fields(tcls) == fields(jcls)


def test_presets_match():
    for name in ("yelp_data", "adressa_data"):
        assert dataclasses.asdict(getattr(C, name)("/d")) == \
            dataclasses.asdict(getattr(JC, name)("/d"))
        assert getattr(C, name)("/d/").path == getattr(JC, name)("/d/").path
    for name in ("yelp_sml", "adressa_sml"):
        assert dataclasses.asdict(getattr(C, name)()) == \
            dataclasses.asdict(getattr(JC, name)())
    assert C.yelp_sml().replace(mf_lr=0.5).mf_lr == 0.5


def test_formats_read_what_jax_writes(tmp_path, rng):
    train = [rng.integers(0, 30, (20, 2)) for _ in range(3)]
    test = {2: rng.integers(0, 30, (7, 6))}
    info = JF.DatasetInfo(60, 30, 30)
    JF.write_dataset(str(tmp_path / "a"), train, test, info,
                     new_user_ids=np.arange(3))
    F.write_dataset(str(tmp_path / "b"), train, test,
                    F.DatasetInfo(60, 30, 30), new_user_ids=np.arange(3))
    for d in ("a", "b"):
        p = str(tmp_path / d)
        assert dataclasses.asdict(F.load_info(p)) == \
            dataclasses.asdict(JF.load_info(p))
        np.testing.assert_array_equal(F.load_test(p, 2), JF.load_test(p, 2))
        assert F.load_test(p, 1) is None
        assert (tmp_path / d / "test_new_user.npy").exists()
    for name in ("information.npy", "train/1.npy", "test/2.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "a" / name),
                                      np.load(tmp_path / "b" / name))


def test_attach_negatives_contract(rng):
    inter = rng.integers(0, 20, (40, 2))
    history = np.concatenate([inter, rng.integers(0, 20, (60, 2))])
    catalog = np.arange(50)
    rows = F.attach_negatives(inter, history, catalog, neg_num=9, seed=3)
    assert rows.shape == (40, 11)
    np.testing.assert_array_equal(rows[:, :2], inter)
    seen = {}
    for u, i in history:
        seen.setdefault(int(u), set()).add(int(i))
    for r in rows:
        negs = r[2:].tolist()
        assert len(set(negs)) == 9
        assert not set(negs) & seen[int(r[0])]
        assert all(0 <= n < 50 for n in negs)
    again = F.attach_negatives(inter, history, catalog, neg_num=9, seed=3)
    np.testing.assert_array_equal(rows, again)
