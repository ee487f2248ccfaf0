"""The port's native host kernels, ``attach_negatives``, ``synth`` and
``ingest`` against the JAX package, on the CPU.

* ``build_eval_rows_native``, ``sample_negatives_native`` and
  ``parse_csv_log_native`` return arrays bit-equal to
  ``sml_tpu.data.native``'s on the same inputs and seeds; the impossible
  catalog and a malformed line raise the same errors; a multi-character
  delimiter goes to ``np.genfromtxt`` in both packages.
* ``attach_negatives`` equals the JAX function, so ``synth`` and
  ``ingest`` (count and time splits, from a CSV or from arrays) write the
  same files, dtypes included.
* The port builds its own copy of ``sampler.cpp`` under ``build/host/`` and
  writes nothing under ``native/``.

Needs ``g++``: the fixture skips where it is absent, as
``tests/test_native.py`` does.
"""

import os
import shutil
from pathlib import Path

import numpy as np
import pytest

from sml_tpu.data import ingest as jax_ingest
from sml_tpu.data import native as jax_native
from sml_tpu.data.formats import attach_negatives as jax_attach
from sml_tpu.data.synthetic import SyntheticSpec as JaxSyntheticSpec
from sml_tpu.data.synthetic import generate_synthetic_dataset as jax_synth
from sml_tpu_torch import cli
from sml_tpu_torch.data import ingest, native
from sml_tpu_torch.data.formats import attach_negatives

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the native kernels cannot build")
    if jax_native.get_lib() is None:
        pytest.skip("the JAX package's native library did not build")
    return native.load_library()


def _setup(rng, n=400, users=60, items=120):
    history = np.unique(np.stack([rng.integers(0, users, n),
                                  rng.integers(0, items, n)], 1), axis=0)
    inter = history[rng.permutation(history.shape[0])[:100]]
    catalog = np.unique(history[:, 1])
    return inter, history, catalog


def _same_tree(a: str, b: str) -> int:
    """Both directories hold the same files, array-equal with equal
    dtypes; returns the file count."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)
    fa, fb = files(a), files(b)
    assert fa == fb
    for f in fa:
        x, y = np.load(os.path.join(a, f)), np.load(os.path.join(b, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    return len(fa)


@pytest.mark.parametrize("seed", [0, 7])
def test_native_entry_points_bit_equal_jax(lib, rng, seed):
    inter, history, catalog = _setup(rng)
    for neg in (1, 20, 50):
        np.testing.assert_array_equal(
            native.build_eval_rows_native(inter, history, catalog, neg,
                                          seed=seed),
            jax_native.build_eval_rows_native(inter, history, catalog, neg,
                                              seed=seed))
    users = rng.integers(0, 60, 500)
    np.testing.assert_array_equal(
        native.sample_negatives_native(users, history, catalog, tries=16,
                                       seed=seed),
        jax_native.sample_negatives_native(users, history, catalog,
                                           tries=16, seed=seed))


def test_impossible_catalog_raises_as_jax(lib):
    history = np.array([[0, 0], [0, 1], [0, 2]], dtype=np.int64)
    inter = np.array([[0, 0]], dtype=np.int64)
    catalog = np.arange(5, dtype=np.int64)
    with pytest.raises(ValueError, match="catalog too small") as jerr:
        jax_native.build_eval_rows_native(inter, history, catalog, 3)
    with pytest.raises(ValueError, match="catalog too small") as terr:
        native.build_eval_rows_native(inter, history, catalog, 3)
    assert str(terr.value) == str(jerr.value)


def _log(path, rng, n=500, header=True, delim=","):
    with open(path, "w") as fh:
        if header:
            fh.write(f"user{delim}item{delim}ts\n")
        fh.write("# a comment line\n")
        for k in range(n):
            fh.write(f"{rng.integers(10 ** 12, 10 ** 12 + 90)}{delim}"
                     f"{rng.integers(0, 40) * 1009}{delim}"
                     f"{rng.uniform(0, 1e6):.3f}\n")
    return str(path)


def test_parse_csv_bit_equal_and_malformed_line(lib, rng, tmp_path):
    path = _log(tmp_path / "log.csv", rng)
    got = native.parse_csv_log_native(path)
    want = jax_native.parse_csv_log_native(path)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    bad = str(tmp_path / "bad.csv")
    with open(bad, "w") as fh:
        fh.write("user,item,ts\n1,2,3\n4,5,6\n7,notanumber,9\n")
    with pytest.raises(ValueError, match="line 4") as jerr:
        jax_native.parse_csv_log_native(bad)
    with pytest.raises(ValueError, match="line 4") as terr:
        native.parse_csv_log_native(bad)
    assert str(terr.value) == str(jerr.value)


def test_multichar_delimiter_goes_to_numpy_in_both(lib, rng, tmp_path):
    path = str(tmp_path / "ml.dat")
    with open(path, "w") as fh:
        for k in range(90):
            fh.write(f"{k % 9}::{k % 23}::{1000 + k}\n")
    assert native.parse_csv_log_native(path, delimiter="::",
                                       skip_header=0) is None
    kw = dict(n_periods=3, first_test_period=1, neg_num=3, seed=2)
    jax_ingest.ingest_csv(path, str(tmp_path / "j"),
                          jax_ingest.IngestSpec(**kw), delimiter="::",
                          skip_header=0)
    ingest.ingest_csv(path, str(tmp_path / "t"), ingest.IngestSpec(**kw),
                      delimiter="::", skip_header=0)
    # information, 3 train, 2 test, 2 new-entity and 2 vocab files
    assert _same_tree(str(tmp_path / "j"), str(tmp_path / "t")) == 10


def test_attach_negatives_equals_jax(lib, rng):
    inter, history, catalog = _setup(rng, n=3000, users=200, items=400)
    for seed in (3, 11):
        np.testing.assert_array_equal(
            attach_negatives(inter, history, catalog, 30, seed=seed),
            jax_attach(inter, history, catalog, 30, seed=seed))


def test_synth_cli_equals_jax(lib, tmp_path):
    kw = dict(n_users=300, n_items=150, n_periods=8,
              interactions_per_period=600, first_test_period=3, neg_num=49,
              seed=7)
    jax_synth(str(tmp_path / "j"), JaxSyntheticSpec(**kw))
    assert cli.main(["--device", "cpu", "synth", "--out",
                     str(tmp_path / "t"), "--users", "300", "--items", "150",
                     "--periods", "8", "--interactions", "600",
                     "--first-test", "3", "--neg-num", "49",
                     "--seed", "7"]) == 0
    # information, 8 train, 5 test and both new-entity id files
    assert _same_tree(str(tmp_path / "j"), str(tmp_path / "t")) == 16


@pytest.mark.parametrize("split", ["count", "time"])
def test_ingest_csv_and_events_equal_jax(lib, rng, tmp_path, split):
    path = _log(tmp_path / "log.csv", rng, n=800)
    kw = dict(n_periods=5, first_test_period=3, neg_num=9, split=split,
              seed=4)
    jax_ingest.ingest_csv(path, str(tmp_path / "jc"),
                          jax_ingest.IngestSpec(**kw))
    assert cli.main(["--device", "cpu", "ingest", "--csv", path, "--out",
                     str(tmp_path / "tc"), "--periods", "5",
                     "--first-test", "3", "--neg-num", "9", "--split",
                     split, "--seed", "4"]) == 0
    # information, 5 train, 2 test, 2 new-entity and 2 vocab files
    assert _same_tree(str(tmp_path / "jc"), str(tmp_path / "tc")) == 12
    users = rng.integers(1000, 1200, 900)
    items = rng.integers(5000, 5100, 900)
    ts = rng.uniform(0, 100, 900)
    jinfo = jax_ingest.ingest_events(users, items, ts, str(tmp_path / "je"),
                                     jax_ingest.IngestSpec(**kw))
    tinfo = ingest.ingest_events(users, items, ts, str(tmp_path / "te"),
                                 ingest.IngestSpec(**kw))
    assert (jinfo.n_interactions, jinfo.n_users, jinfo.n_items) == \
        (tinfo.n_interactions, tinfo.n_users, tinfo.n_items)
    assert _same_tree(str(tmp_path / "je"), str(tmp_path / "te")) == 12
    dense, vocab = ingest.densify_ids(np.array([50, 7, 50, 3, 7, 99]))
    np.testing.assert_array_equal(dense, [0, 1, 0, 2, 1, 3])
    np.testing.assert_array_equal(vocab, [50, 7, 3, 99])


def test_library_builds_under_build_and_never_in_native(lib, tmp_path,
                                                        monkeypatch):
    # the port's copy of the source is the JAX package's, byte for byte
    assert native.SRC.read_bytes() == (ROOT / "native" /
                                       "sampler.cpp").read_bytes()
    assert native.library_path().parent == ROOT / "build" / "host"
    assert native.library_path().exists()
    before = sorted(os.listdir(ROOT / "native"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "host")
    out = native.library_path()
    native._compile(out)
    assert out.exists() and out.parent == tmp_path / "host"
    assert sorted(os.listdir(tmp_path / "host")) == [out.name]
    assert sorted(os.listdir(ROOT / "native")) == before


def test_failed_build_raises_naming_the_compiler(tmp_path, monkeypatch):
    """No fallback: a source that does not compile raises with g++'s
    output."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    bad = tmp_path / "broken.cpp"
    bad.write_text("int f( {\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "host")
    with pytest.raises(RuntimeError, match="g\\+\\+.*failed to build "
                                           "broken.cpp"):
        native._compile(native.library_path())
    assert not list((tmp_path / "host").glob("*.so"))
