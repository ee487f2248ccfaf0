"""The serving slice as a whole: a JAX run's checkpoint served by the port.

``sml_tpu``'s ``SMLEngine`` (masked scoring) writes its state with
``save_checkpoint``; the port loads it with ``state_from_checkpoint`` on
the CPU. Both packages then run snapshot ``last`` -> set ``hat`` -> refresh
-> ``make_eval_set(build_mask=True)`` -> ``evaluate`` on the conftest
dataset. Refreshed tables agree to 3e-5 (f32 sums in another order); hit
sums may move by one rank flip. ``rank`` goes through both CLIs on the same
npz: the same item ids, and scores equal to the printed precision.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sml_tpu import cli as jax_cli
from sml_tpu.config import SMLConfig as JaxSMLConfig
from sml_tpu.config import TransferConfig as JaxTransferConfig
from sml_tpu.eval.full_ranking import recommend as jax_recommend
from sml_tpu.models.mf import MFParams as JaxMF
from sml_tpu.models.mf import with_tables as jax_with_tables
from sml_tpu.train.engine import SMLEngine as JaxEngine
from sml_tpu.utils import checkpoint as jax_ckpt
from sml_tpu_torch import cli
from sml_tpu_torch.config import SMLConfig, TransferConfig
from sml_tpu_torch.data.formats import load_test
from sml_tpu_torch.eval.full_ranking import recommend
from sml_tpu_torch.models.mf import MFParams, with_tables
from sml_tpu_torch.train.engine import SMLEngine, SMLState
from sml_tpu_torch.utils import checkpoint as ckpt

D, H = 16, 64


def _cfgs(snapshot_dtype):
    kw = dict(latent_dim=D, eval_scoring="masked", eval_batch_size=64,
              snapshot_dtype=snapshot_dtype)
    return (JaxSMLConfig(transfer=JaxTransferConfig(latent_dim=D,
                                                    fc_hidden=H), **kw),
            SMLConfig(transfer=TransferConfig(latent_dim=D, fc_hidden=H),
                      **kw))


@pytest.mark.parametrize("snapshot_dtype", ["float32", "bfloat16"])
def test_slice_from_jax_checkpoint(tmp_path, synthetic_dataset,
                                   snapshot_dtype):
    dspec, info, _ = synthetic_dataset
    jcfg, tcfg = _cfgs(snapshot_dtype)
    jeng = JaxEngine(jcfg, info.n_users, info.n_items)
    jstate = jeng.init_state()
    jstate = jeng.snapshot_hat(jstate)
    ck = str(tmp_path / "ck")
    jax_ckpt.save_checkpoint(ck, 4, jstate, extra={"period": 4})

    tstate = ckpt.state_from_checkpoint(ck, device="cpu")
    assert tstate.hat_user.dtype == (torch.bfloat16
                                     if snapshot_dtype == "bfloat16"
                                     else torch.float32)
    np.testing.assert_array_equal(tstate.mf.user_emb.numpy(),
                                  np.asarray(jstate.mf.user_emb))
    teng = SMLEngine(tcfg, info.n_users, info.n_items, device="cpu")

    jstate = jeng.snapshot_last(jstate)
    tstate = teng.snapshot_last(tstate)
    # Ŵ_t: the tables as an inner epoch would leave them
    rng = np.random.default_rng(3)
    hat_u = (np.asarray(jstate.mf.user_emb)
             + 0.1 * rng.normal(size=(info.n_users, D))).astype(np.float32)
    hat_i = (np.asarray(jstate.mf.item_emb)
             + 0.1 * rng.normal(size=(info.n_items, D))).astype(np.float32)
    jstate = jeng.snapshot_hat(jstate._replace(mf=jax_with_tables(
        jstate.mf, jnp.asarray(hat_u), jnp.asarray(hat_i))))
    tstate = teng.snapshot_hat(tstate._replace(mf=with_tables(
        tstate.mf, torch.from_numpy(hat_u), torch.from_numpy(hat_i))))
    np.testing.assert_array_equal(
        tstate.last_user.float().numpy(),
        np.asarray(jstate.last_user.astype(jnp.float32)))

    jstate = jeng.refresh(jstate)
    tstate = teng.refresh(tstate)
    for t, j in ((tstate.mf.user_emb, jstate.mf.user_emb),
                 (tstate.mf.item_emb, jstate.mf.item_emb)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=3e-5,
                                   atol=3e-5)

    rows = load_test(dspec.path, dspec.online_test_start)
    jev = jeng.make_eval_set(rows, build_mask=True)
    tev = teng.make_eval_set(rows, build_mask=True)
    np.testing.assert_array_equal(tev.cand_mask.numpy().view(np.uint32),
                                  np.asarray(jev.cand_mask))
    jm = jeng.evaluate(jstate.mf, jev)
    tm = teng.evaluate(tstate.mf, tev)
    n = tev.n_real
    for k in jcfg.topk:
        assert abs(tm[k]["recall"] - jm[k]["recall"]) * n <= 1 + 1e-6, k
        assert abs(tm[k]["ndcg"] - jm[k]["ndcg"]) * n <= 1 + 1e-6, k
    assert tm[20]["recall"] > 0


def test_port_checkpoint_keeps_jax_layout(tmp_path):
    """The port writes the JAX key names and bf16 convention: its file
    restores through ``sml_tpu``'s own reader and round-trips in the
    port."""
    from typing import Any, NamedTuple

    from sml_tpu.models.transfer import TransferParams as JaxTP
    from sml_tpu.models.transfer import init_transfer as jax_init

    class Serving(NamedTuple):      # the leaves both packages hold
        mf: Any
        theta: Any
        last_user: Any
        last_item: Any
        hat_user: Any
        hat_item: Any

    _, tcfg = _cfgs("bfloat16")
    teng = SMLEngine(tcfg, 30, 20, device="cpu")
    state = teng.snapshot_last(teng.init_state())
    d = str(tmp_path / "ck")
    ckpt.save_checkpoint(d, 2, state, extra={"period": 2})
    assert ckpt.latest_step(d) == 2

    def zeros(t):
        return jnp.zeros(tuple(t.shape), jnp.bfloat16
                         if t.dtype == torch.bfloat16 else jnp.float32)

    jt = jax_init(jax.random.PRNGKey(0), JaxTransferConfig(latent_dim=D,
                                                           fc_hidden=H))
    template = Serving(JaxMF(*map(zeros, state.mf)), JaxTP(jt.user, jt.item),
                       *(zeros(getattr(state, f)) for f in ckpt.SNAPSHOTS))
    restored, step, extra = jax_ckpt.restore_checkpoint(d, template)
    assert step == 2 and extra == {"period": 2}
    assert restored.hat_user.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(restored.hat_user.astype(jnp.float32)),
        state.hat_user.float().numpy())
    np.testing.assert_array_equal(np.asarray(restored.theta.user.fc1_w),
                                  state.theta.user.fc1_w.detach().numpy())

    back = ckpt.state_from_checkpoint(d, device="cpu")
    for a, b in zip(ckpt.flatten_state(back).values(),
                    ckpt.flatten_state(state).values()):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_engine_eval_set_cache_is_content_keyed():
    _, tcfg = _cfgs("float32")
    teng = SMLEngine(tcfg, 50, 40, device="cpu")
    rng = np.random.default_rng(4)
    rows = np.concatenate([rng.integers(0, 50, (70, 1)),
                           np.stack([rng.permutation(40)[:11]
                                     for _ in range(70)])], axis=1)
    plain = teng.make_eval_set(rows)
    assert plain.cand_mask is None
    upgraded = teng.make_eval_set(rows, build_mask=True)
    assert upgraded.cand_mask is not None
    assert teng.make_eval_set(rows.copy()) is upgraded
    # one changed element is a different set (every byte is hashed)
    other = rows.copy()
    other[35, 5] = (other[35, 5] + 1) % 40
    assert teng.make_eval_set(other) is not upgraded


def test_training_entry_points_raise_until_ported(synthetic_dataset,
                                                  tmp_path):
    """Training is ported, and what raised until it was ported now runs:
    the six other transfer kinds (an unknown kind raises), attributed
    evaluation and the profiler."""
    from sml_tpu_torch.train.driver import SMLDriver

    dspec, _, _ = synthetic_dataset
    _, tcfg = _cfgs("float32")
    teng = SMLEngine(tcfg.replace(theta_warmstart_steps=2,
                                  theta_warmstart_rows=8), 10, 10,
                     device="cpu")
    state = teng.init_state()
    rows = np.stack([np.arange(10), np.arange(10), np.arange(10)[::-1]], 1)
    state, losses = teng.inner_epoch(teng.snapshot_last(state),
                                     *teng.prep_inner(rows))
    state, losses = teng.outer_epoch(teng.snapshot_hat(state),
                                     *teng.prep_outer(rows))
    assert torch.isfinite(losses).all()
    gru = SMLEngine(tcfg.replace(transfer=TransferConfig(
        latent_dim=D, kind="gru")), 10, 10, device="cpu").init_state()
    assert set(gru.tr_opt.mu) == {f"{s}/{f}" for s in ("user", "item")
                                  for f in ("w_ih", "w_hh", "b_ih", "b_hh")}
    with pytest.raises(ValueError, match="unknown transfer kind"):
        SMLEngine(tcfg.replace(transfer=TransferConfig(kind="lstm")), 10, 10,
                  device="cpu").init_state()
    attr = SMLDriver(tcfg.replace(attributed_eval=True), dspec,
                     device="cpu")
    assert attr._is_new_user is not None
    attr.close()
    prof = SMLDriver(tcfg.replace(profile_dir=str(tmp_path)), dspec,
                     device="cpu")
    assert prof.cfg.profile_dir == str(tmp_path)
    prof.close()


def test_init_state_is_seeded_and_keeps_pretrained():
    _, tcfg = _cfgs("bfloat16")
    a = SMLEngine(tcfg, 12, 9, device="cpu").init_state()
    b = SMLEngine(tcfg, 12, 9, device="cpu").init_state()
    for x, y in zip(ckpt.flatten_state(a).values(),
                    ckpt.flatten_state(b).values()):
        assert torch.equal(x, y)
    assert a.last_user.dtype == torch.bfloat16
    assert not a.last_user.float().any()
    pre = MFParams(torch.ones(12, D), torch.ones(9, D), torch.zeros(12, 1),
                   torch.zeros(9, 1))
    c = SMLEngine(tcfg, 12, 9, device="cpu").init_state(pretrained_mf=pre)
    assert torch.equal(c.mf.user_emb, pre.user_emb)
    assert c.mf.user_emb.data_ptr() != pre.user_emb.data_ptr()
    assert isinstance(c, SMLState)


def test_mf_scoring_and_load_hat_match_jax(rng):
    from sml_tpu.models import mf as jax_mf
    from sml_tpu_torch.models import mf as port_mf

    ue = rng.normal(size=(30, D)).astype(np.float32)
    ie = rng.normal(size=(40, D)).astype(np.float32)
    users, items = rng.integers(0, 30, 16), rng.integers(0, 40, 16)
    cand = rng.integers(0, 40, (16, 9))
    jmf = JaxMF(jnp.asarray(ue), jnp.asarray(ie), jnp.zeros((30, 1)),
                jnp.zeros((40, 1)))
    tmf = MFParams(torch.from_numpy(ue), torch.from_numpy(ie),
                   torch.zeros(30, 1), torch.zeros(40, 1))
    np.testing.assert_allclose(
        port_mf.score_pairs(tmf, torch.from_numpy(users),
                            torch.from_numpy(items)).numpy(),
        np.asarray(jax_mf.score_pairs(jmf, users, items)), rtol=1e-5,
        atol=1e-5)
    np.testing.assert_allclose(
        port_mf.score_candidates(tmf, torch.from_numpy(users),
                                 torch.from_numpy(cand)).numpy(),
        np.asarray(jax_mf.score_candidates(jmf, users, cand)), rtol=1e-5,
        atol=1e-5)

    _, tcfg = _cfgs("bfloat16")
    eng = SMLEngine(tcfg, 30, 40, device="cpu")
    state = eng.init_state(pretrained_mf=tmf)
    zeroed = state._replace(mf=with_tables(state.mf, torch.zeros(30, D),
                                           torch.zeros(40, D)))
    loaded = eng.load_hat_into_mf(zeroed)
    assert loaded.mf.user_emb.dtype == torch.float32
    assert torch.equal(loaded.mf.user_emb, state.hat_user.float())
    assert torch.equal(loaded.mf.item_emb, state.hat_item.float())


def _write_model(path, rng, users=40, items=300, d=8):
    np.savez(path,
             user_emb=rng.normal(size=(users, d)).astype(np.float32),
             item_emb=rng.normal(size=(items, d)).astype(np.float32),
             user_bias=np.zeros((users, 1), np.float32),
             item_bias=np.zeros((items, 1), np.float32))


def _lines(capsys):
    return [json.loads(line)
            for line in capsys.readouterr().out.strip().splitlines()]


@pytest.mark.parametrize("extra", [[], ["--bf16"],
                                   ["--topk-method", "approx99"]])
def test_rank_cli_matches_jax(tmp_path, capsys, rng, extra):
    model = str(tmp_path / "m.npz")
    _write_model(model, rng)
    args = ["rank", "--model", model, "--users", "0,5,39", "-k", "7"]
    assert jax_cli.main(args + extra) == 0
    want = _lines(capsys)
    assert cli.main(["--device", "cpu"] + args + extra) == 0
    got = _lines(capsys)
    assert [r["user"] for r in got] == [r["user"] for r in want]
    for g, w in zip(got, want):
        assert g["items"] == w["items"]
        # printed to 4 decimals: equal up to one unit of the last digit
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0,
                                   atol=1e-4 + 1e-9)
        assert g["scores"] == sorted(g["scores"], reverse=True)


def test_recommend_matches_jax_unrounded(rng):
    ue = rng.normal(size=(50, 16)).astype(np.float32)
    ie = rng.normal(size=(400, 16)).astype(np.float32)
    users = np.asarray([0, 7, 49, 7])
    js, ji = jax_recommend(JaxMF(jnp.asarray(ue), jnp.asarray(ie),
                                 jnp.zeros((50, 1)), jnp.zeros((400, 1))),
                           jnp.asarray(users), 10, topk_method="exact_sort")
    ts, ti = recommend(MFParams(torch.from_numpy(ue), torch.from_numpy(ie),
                                torch.zeros(50, 1), torch.zeros(400, 1)),
                       torch.from_numpy(users), 10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5)


def test_rank_cli_users_file_device_flag_and_bad_ids(tmp_path, capsys, rng):
    model = str(tmp_path / "m.npz")
    _write_model(model, rng)
    users = tmp_path / "users.txt"
    users.write_text("3\n\n4\n")
    # --shard is a no-op on one device
    assert cli.main(["--device", "cpu", "rank", "--model", model,
                     "--users-file", str(users), "-k", "3", "--batch-size",
                     "1", "--shard"]) == 0
    got = _lines(capsys)
    assert [r["user"] for r in got] == [3, 4]
    assert all(len(r["items"]) == 3 for r in got)
    # --device is a top-level option only, as --platform is in sml_tpu
    with pytest.raises(SystemExit):
        cli.main(["rank", "--model", model, "--users", "1",
                  "--device", "cpu"])
    capsys.readouterr()
    assert cli.main(["--device", "cpu", "rank", "--model", model,
                     "--users", "1,40"]) == 2
    assert "out of range" in capsys.readouterr().err


def test_module_entry_point_runs(tmp_path, rng):
    import subprocess
    import sys
    model = str(tmp_path / "m.npz")
    _write_model(model, rng)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "sml_tpu_torch", "--device", "cpu", "rank",
         "--model", model, "--users", "2", "-k", "4"],
        capture_output=True, text=True, cwd=root, timeout=120)
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip())
    assert line["user"] == 2 and len(line["items"]) == 4
