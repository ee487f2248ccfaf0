"""The eval-design probes (P1, P2, P3) against the JAX scripts.

``scripts/`` has no ``__init__.py``, so the two JAX scripts load by file
path. P2 and P3 run their Pallas kernels with ``interpret=True``; P1's
script has no such switch, so its test wraps ``pallas_call`` in interpret
mode for the test's duration only. On the CPU the port's wrappers take
their plain versions. Tolerances:

* P2 scores: exact on integer-valued tables (|x| <= 1), out-of-range ids
  included (NaN in the same places); rtol 1e-6 on random bf16-rounded
  tables (each bf16 product is exact in f32; only the order of the 64 f32
  sums differs), with atol 1e-5 for sums that cancel to near zero.
* P3 ranks: exact on integer tables, edge-case masks included; on random
  tables at most 1 row in 64 differs, by 1 (a candidate within f32
  rounding of the target's score).
* P1 ranks and ``build_candidate_mask``: exact.
"""

import functools
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sml_tpu_torch.ops import eval_kernel as EK
from sml_tpu_torch.ops import probe_kernels as PK
from sml_tpu_torch.scripts import eval_kernel_probe as tprobe
from sml_tpu_torch.scripts import eval_variants as tev

ROOT = Path(__file__).resolve().parent.parent
B, D = 64, 64


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jev():
    return _load_script("eval_variants")


@pytest.fixture(scope="module")
def jprobe():
    return _load_script("eval_kernel_probe")


def _tables(rng, n, kind):
    """(n, D) f32 values exactly representable in bf16."""
    if kind == "int":
        return rng.integers(-1, 2, (n, D)).astype(np.float32)
    x = rng.standard_normal((n, D)).astype(np.float32)
    return torch.from_numpy(x).bfloat16().float().numpy()


def _distinct_cands(rng, rows, n_cand, n_items):
    return np.argsort(rng.random((rows, n_items)), axis=1)[:, :n_cand]


def _jax_scores(jev, ue_t, ie_t, users, cand, row_block=32):
    scorer = jev.make_pallas_scorer(ie_t.shape[0], row_block=row_block,
                                    interpret=True)
    return np.asarray(scorer((jnp.asarray(ue_t, jnp.bfloat16),
                              jnp.asarray(ie_t, jnp.bfloat16)),
                             jnp.asarray(users, jnp.int32),
                             jnp.asarray(cand, jnp.int32)))


def _torch_scores(ue_t, ie_t, users, cand):
    ctx = (torch.from_numpy(ue_t).bfloat16(),
           torch.from_numpy(ie_t).bfloat16())
    return tev.make_cuda_scorer(ie_t.shape[0])(ctx, users, cand)


@pytest.mark.parametrize("kind", ["int", "random"])
def test_candidate_scores_match_jax(jev, kind):
    """The probe's call: int64 ``users`` and ``cand`` cut from one rows
    array as strided views (``r[:, 0]``, ``r[:, 1:]``)."""
    rng = np.random.default_rng(11)
    n_users, n_items, C = 90, 300, 17
    ue_t, ie_t = _tables(rng, n_users, kind), _tables(rng, n_items, kind)
    rows = np.concatenate([rng.integers(0, n_users, (B, 1)),
                           rng.integers(0, n_items, (B, C))], axis=1)
    want = _jax_scores(jev, ue_t, ie_t, rows[:, 0], rows[:, 1:])
    r = torch.from_numpy(rows)
    assert r.dtype == torch.int64
    users, cand = r[:, 0], r[:, 1:]
    assert not users.is_contiguous() and not cand.is_contiguous()
    got = _torch_scores(ue_t, ie_t, users, cand)
    assert got.dtype == torch.float32 and got.shape == (B, C)
    if kind == "int":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
    assert PK.candidate_scores_cuda.launches == 0


# an id outside a table of n rows, by name
OUT_OF_RANGE = {"-1": lambda n: -1, "-n": lambda n: -n, "n": lambda n: n,
                "n+5": lambda n: n + 5, "n+7": lambda n: n + 7,
                "-n-1": lambda n: -n - 1}


@pytest.mark.parametrize("where,bad", [
    ("cand", "-1"), ("cand", "-n"), ("cand", "n"), ("cand", "n+5"),
    ("cand", "-n-1"), ("users", "-1"), ("users", "-n"), ("users", "n"),
    ("users", "n+7"), ("users", "-n-1")])
def test_candidate_scores_out_of_range_ids_match_jax(jev, where, bad):
    """Ids outside the tables as the JAX scorer takes them: a candidate id
    in [-I, 0) wraps, any other outside [0, I) scores NaN; a user id in
    [-U, 0) wraps, and every user id is then clamped into [0, U-1].
    Integer tables, exact; NaN in the same places."""
    rng = np.random.default_rng(15)
    n_users, n_items, C = 40, 120, 9
    ue_t, ie_t = _tables(rng, n_users, "int"), _tables(rng, n_items, "int")
    users = rng.integers(0, n_users, B)
    cand = rng.integers(0, n_items, (B, C))
    n = n_items if where == "cand" else n_users
    value = OUT_OF_RANGE[bad](n)
    hit = rng.random(B) < 0.5                 # half the rows take the id
    if where == "cand":
        cand[hit, rng.integers(0, C)] = value
    else:
        users[hit] = value
    want = _jax_scores(jev, ue_t, ie_t, users, cand)
    got = _torch_scores(ue_t, ie_t, torch.from_numpy(users),
                        torch.from_numpy(cand)).numpy()
    np.testing.assert_array_equal(got, want)
    nan_rows = np.isnan(want).any(axis=1)
    if where == "cand" and not -n <= value < n:
        assert (nan_rows == hit).all()
    else:
        assert not nan_rows.any()
    assert PK.candidate_scores_cuda.launches == 0


@pytest.mark.parametrize("kind", ["int", "random"])
def test_dense_mask_rank_matches_jax(jev, kind):
    rng = np.random.default_rng(12)
    ipad, n_items, n_cand = 512, 500, 41
    tab = np.zeros((ipad, D), np.float32)
    tab[:n_items] = _tables(rng, n_items, kind)
    ue = _tables(rng, B, kind)
    cand = _distinct_cands(rng, B, n_cand, n_items)
    maskm = np.zeros((B, ipad), np.int8)
    np.put_along_axis(maskm, cand, 1, axis=1)
    tgt = cand[:, 0].astype(np.int32)          # the target is in the mask
    rank_fn = jev.make_masked_rank_pallas(ipad, row_block=32, item_block=256,
                                          interpret=True)
    want = np.asarray(rank_fn(jnp.asarray(tab, jnp.bfloat16),
                              jnp.asarray(ue), jnp.asarray(tgt),
                              jnp.asarray(maskm)))
    got = PK.dense_mask_rank(torch.from_numpy(tab).bfloat16(),
                             torch.from_numpy(ue), torch.from_numpy(tgt),
                             torch.from_numpy(maskm)).numpy()
    assert got.dtype == np.int32 and (got <= n_cand - 1).all()
    if kind == "int":
        np.testing.assert_array_equal(got, want)
    else:
        diff = np.abs(got.astype(np.int64) - want)
        assert (diff <= 1).all() and int((diff > 0).sum()) <= 1
    assert PK.dense_mask_rank_cuda.launches == 0


@pytest.mark.parametrize("case", ["empty", "full", "one_chunk",
                                  "last_chunk"])
def test_dense_mask_rank_edge_masks_match_jax(jev, case):
    """Masks of one shape per batch, integer tables (exact): no entry set;
    every item set, the target among them; the 16 entries of one 16-byte
    chunk, the target among them; the last chunk (pad items, zero rows)."""
    rng = np.random.default_rng(14)
    ipad, n_items = 512, 500
    tab = np.zeros((ipad, D), np.float32)
    tab[:n_items] = _tables(rng, n_items, "int")
    ue = _tables(rng, B, "int")
    maskm = np.zeros((B, ipad), np.int8)
    tgt = rng.integers(0, n_items, B).astype(np.int32)
    if case == "full":
        maskm[:, :n_items] = 1
    elif case == "one_chunk":
        maskm[:, 160:176] = 1
        tgt = rng.integers(160, 176, B).astype(np.int32)
    elif case == "last_chunk":
        maskm[:, ipad - 16:] = 1
    rank_fn = jev.make_masked_rank_pallas(ipad, row_block=32, item_block=256,
                                          interpret=True)
    want = np.asarray(rank_fn(jnp.asarray(tab, jnp.bfloat16),
                              jnp.asarray(ue), jnp.asarray(tgt),
                              jnp.asarray(maskm)))
    got = PK.dense_mask_rank(torch.from_numpy(tab).bfloat16(),
                             torch.from_numpy(ue), torch.from_numpy(tgt),
                             torch.from_numpy(maskm)).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "empty":
        assert not got.any()
    elif case in ("full", "one_chunk"):
        # the target never outranks itself
        assert (got <= int(maskm[0].sum()) - 1).all() and got.max() > 0
    assert PK.dense_mask_rank_cuda.launches == 0


def test_masked_rank_variants_match_jax(jprobe, monkeypatch):
    from jax.experimental import pallas as jpl
    monkeypatch.setattr(jpl, "pallas_call",
                        functools.partial(jpl.pallas_call, interpret=True))
    ue, items_t, sstar, maskp = tprobe.probe_inputs(B, 4096, D, 99,
                                                    torch.device("cpu"))
    jmask = jnp.asarray(maskp.numpy().view(np.uint32))
    jargs = (jnp.asarray(ue.numpy()), jnp.asarray(items_t.numpy()),
             jnp.asarray(sstar.numpy()), jmask)
    want = {}
    for name, spec in tprobe.VARIANTS.items():
        # the JAX grid needs B to be a multiple of its row block: the
        # variant's layout at rblk 32 (the same function)
        key = (spec["order"], spec["in_dtype"])
        if key not in want:
            run = jax.jit(jprobe.make_variant(**{**spec, "rblk": 32}))
            want[key] = np.asarray(run(*jargs))
        got = tprobe.make_variant(**spec)(ue, items_t, sstar, maskp)
        np.testing.assert_array_equal(got.numpy(), want[key], err_msg=name)
    assert set(tprobe.VARIANTS) == set(jprobe.VARIANTS)
    assert EK.masked_rank_variant_cuda.launches == 0


@pytest.mark.parametrize("in_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("order", EK.VARIANT_ORDERS)
@pytest.mark.parametrize("rows_per_block", EK.VARIANT_ROWS_PER_BLOCK)
def test_masked_rank_variant_layouts_match_jax(jprobe, monkeypatch,
                                               rows_per_block, order,
                                               in_dtype):
    """Each of P1's layouts against the JAX variant at the probe's own row
    block (rblk 256 or 512, so 512 rows), integer tables: exact."""
    from jax.experimental import pallas as jpl
    monkeypatch.setattr(jpl, "pallas_call",
                        functools.partial(jpl.pallas_call, interpret=True))
    rblk = {v: k for k, v in tprobe.ROWS_PER_BLOCK.items()}[rows_per_block]
    ue, items_t, sstar, maskp = tprobe.probe_inputs(512, 4096, D, 99,
                                                    torch.device("cpu"))
    run = jax.jit(jprobe.make_variant(rblk, order, None, in_dtype))
    want = np.asarray(run(jnp.asarray(ue.numpy()),
                          jnp.asarray(items_t.numpy()),
                          jnp.asarray(sstar.numpy()),
                          jnp.asarray(maskp.numpy().view(np.uint32))))
    if in_dtype == "bf16":
        ue, items_t = ue.bfloat16(), items_t.bfloat16()
    got = EK.masked_rank_variant(ue, items_t, sstar, maskp,
                                 rows_per_block=rows_per_block, order=order)
    assert got.dtype == torch.int32 and int(got.sum()) > 0
    np.testing.assert_array_equal(got.numpy(), want)
    assert EK.masked_rank_variant_cuda.launches == 0


@pytest.mark.parametrize("in_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [24, 40])
def test_masked_rank_variant_padded_width_matches_jax(jprobe, monkeypatch, d,
                                                      in_dtype):
    """P1 at widths that are not multiples of 16: the zero columns that the
    card's wrapper adds (``pad_width``) leave every rank of the JAX variant
    at the unpadded width unchanged; integer tables, exact."""
    from jax.experimental import pallas as jpl
    monkeypatch.setattr(jpl, "pallas_call",
                        functools.partial(jpl.pallas_call, interpret=True))
    ue, items_t, sstar, maskp = tprobe.probe_inputs(B, 4096, d, 99,
                                                    torch.device("cpu"))
    run = jax.jit(jprobe.make_variant(32, "ij", None, in_dtype))
    want = np.asarray(run(jnp.asarray(ue.numpy()),
                          jnp.asarray(items_t.numpy()),
                          jnp.asarray(sstar.numpy()),
                          jnp.asarray(maskp.numpy().view(np.uint32))))
    ue_p, items_p = EK.pad_width(ue, items_t)
    assert ue_p.shape[1] == items_p.shape[0] == d + -d % EK.VARIANT_K
    assert not ue_p[:, d:].any() and not items_p[d:].any()
    if in_dtype == "bf16":
        ue_p, items_p = ue_p.bfloat16(), items_p.bfloat16()
    got = EK.masked_rank_plain(ue_p, items_p, sstar, maskp)
    assert int(got.sum()) > 0
    np.testing.assert_array_equal(got.numpy(), want)


def test_build_candidate_mask_matches_jax(jev):
    rng = np.random.default_rng(13)
    n_items, ipad = 700, 1024
    rows = np.concatenate([rng.integers(0, 50, (512, 1)),
                           _distinct_cands(rng, 512, 30, n_items)], axis=1)
    want = np.asarray(jev.build_candidate_mask(jnp.asarray(rows, jnp.int32),
                                               ipad))
    got = tev.build_candidate_mask(torch.from_numpy(rows), ipad)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == 512 * 30


def test_probe_inputs_draw_the_jax_candidates():
    _, rows = tev.probe_inputs(64, 500, 300, 50, torch.device("cpu"))
    rng = np.random.default_rng(3)
    base = rng.integers(0, 300, (64, 1))
    stride = rng.integers(1, (300 - 1) // 51 + 1, (64, 1))
    np.testing.assert_array_equal(rows[:, 1:].numpy(),
                                  (base + stride * np.arange(51)) % 300)


def test_eval_variants_main_on_cpu(capsys):
    res = tev.main(["--device", "cpu", "--rows", "1024", "--users", "500",
                    "--items", "300", "--cands", "50", "--rounds", "1"])
    printed = json.loads(capsys.readouterr().out)
    names = ("v0_gather_f32", "v1_gather_bf16", "v2_matmul_gather",
             "v3_matmul_bf16", "v4_pallas", "v5_masked_xla_f32",
             "v5b_masked_xla_bf16", "v6_masked_pallas")
    for name in names:
        assert "error" not in res[name], res[name]
        assert printed[name]["hit_sum@20"] == res[name]["hit_sum@20"]
    # the f32 variants score exactly alike; P2 agrees with the bf16 gather
    for name in ("v2_matmul_gather", "v5_masked_xla_f32"):
        assert res[name]["max_hit_delta_vs_v0"] <= 2
    assert res["v4_pallas"]["hit_sum@20"] == res["v1_gather_bf16"][
        "hit_sum@20"]
    assert res["v6_masked_pallas"]["hit_sum@20"] == res[
        "v5b_masked_xla_bf16"]["hit_sum@20"]
    assert tev.exit_status(res) == 0


def test_eval_kernel_probe_main_on_cpu(tmp_path):
    out = tmp_path / "probe.json"
    res = tprobe.main(["--device", "cpu", "--rows", "256", "--items", "4096",
                       "--trials", "1", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert set(res["variants"]) == set(tprobe.VARIANTS)
    assert all(v.get("exact_vs_v0") for v in res["variants"].values())
    assert tprobe.exit_status(res) == 0


def _fail(*args, **kwargs):
    raise RuntimeError("kernel failed to launch")


def test_eval_variants_exit_status_on_a_failed_variant(monkeypatch, capsys):
    """A variant that raises is recorded in the printed JSON, the other
    variants still run, and the exit status is 1."""
    monkeypatch.setattr(tev, "candidate_scores", _fail)
    res = tev.main(["--device", "cpu", "--rows", "1024", "--users", "500",
                    "--items", "300", "--cands", "50", "--rounds", "1"])
    printed = json.loads(capsys.readouterr().out)
    assert "kernel failed to launch" in printed["v4_pallas"]["error"]
    assert "error" not in printed["v6_masked_pallas"]
    assert tev.exit_status(res) == tev.exit_status(printed) == 1


def test_eval_kernel_probe_exit_status_on_a_failed_variant(monkeypatch,
                                                           capsys):
    real = tprobe.masked_rank_variant

    def ji_fails(*args, order, **kwargs):
        if order == "ji":
            _fail()
        return real(*args, order=order, **kwargs)

    monkeypatch.setattr(tprobe, "masked_rank_variant", ji_fails)
    res = tprobe.main(["--device", "cpu", "--rows", "256", "--items", "4096",
                       "--trials", "1"])
    printed = json.loads(capsys.readouterr().out)
    assert "kernel failed to launch" in printed["variants"]["v2p"]["error"]
    assert printed["variants"]["v0"]["exact_vs_v0"]
    assert tprobe.exit_status(res) == tprobe.exit_status(printed) == 1
