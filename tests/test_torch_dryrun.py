"""``sml_tpu_torch.parallel.dryrun.dryrun_multichip`` on 2 and 4 CPU
ranks (meshes (1, 2) and (2, 2)): one full step against one rank in
'alone', replay and 'all' mode (tables and Θ within 1e-4, equal recall at
999 negatives), the JAX dry run's fused parts (c) ``phase_step`` in 'all'
mode and (d) ``period_step`` with in-program evals against the same
phases unfused on the mesh (bit-equal tables, equal hits and NDCG) and
against one rank (tables and Θ within 1e-4; bit-equal with equal hits on
(1, 2)), and sharded against dense serving (equal id sets, scores within
1e-5); on the CPU no kernel launches."""

import numpy as np
import pytest

from sml_tpu_torch.parallel.dryrun import check_fused_parts, dryrun_multichip


@pytest.mark.parametrize("n,mesh", [(2, (1, 2)), (4, (2, 2))])
def test_dryrun_multichip(n, mesh):
    report = dryrun_multichip(n, device="cpu", timeout_s=180)
    assert report["mesh"] == {"data": mesh[0], "model": mesh[1]}
    for mode in ("alone", "replay", "all"):
        assert max(report[mode]["max_delta"].values()) < 1e-4
        assert len(report[mode]["launches"]) == n
        assert all(v == 0 for r in report[mode]["launches"]
                   for v in r.values())
    assert report["serving"] <= 1e-5
    fused = report["fused"]
    for part in ("c", "d"):
        assert max(fused[part]["max_delta"].values()) < 1e-4
        assert fused[part]["graphs"]["programs"] == 1
        if mesh[0] == 1:
            assert max(fused[part]["max_delta"].values()) == 0.0
            assert fused[part]["vs_one"] == {"hits": 0, "ndcg": 0.0}
    # two phases of one inner and one outer epoch, each with its eval
    assert fused["d"]["records"] == 2 * (1 + 1)
    assert all(v == 0 for r in fused["launches"] for p in r.values()
               for v in p.values())


def test_check_fused_parts_flags_a_divergence():
    def part(user=0.0, recall=0.5, ndcg=0.25):
        m = {20: {"recall": recall, "ndcg": ndcg}}
        return {"user_emb": np.full((2, 2), user, np.float32),
                "item_emb": np.zeros((2, 2), np.float32),
                "theta": {"w": np.zeros(3, np.float32)}, "wall_s": 0.0,
                "graphs": {}, "metrics": m,
                "records": [("inner_eval", 0, m)]}

    def result(c, d, unfused=None, one=None):
        base = {"c": part(), "d": part()}
        return {"c": c, "d": d, "unfused": unfused or base,
                "one": one or base}
    ok = check_fused_parts(result(part(), part()), 64, 1)
    assert ok["c"]["vs_one"] == {"hits": 0, "ndcg": 0.0}
    # tables: within 1e-4 of one rank, bit-equal to the unfused mesh
    with pytest.raises(AssertionError, match=r"\(d\): divergence"):
        check_fused_parts(result(part(), part(user=2e-4)), 64, 2)
    near = part(user=5e-5)
    with pytest.raises(AssertionError, match=r"\(c\): divergence"):
        check_fused_parts(result(near, part()), 64, 2)
    # one hit or an NDCG gap against the unfused mesh fails on any mesh
    for n_data in (1, 2):
        with pytest.raises(AssertionError, match="from the unfused mesh"):
            check_fused_parts(result(part(recall=0.5 + 1 / 64), part()), 64,
                              n_data)
        with pytest.raises(AssertionError, match="from the unfused mesh"):
            check_fused_parts(result(part(), part(ndcg=0.25 + 1e-5)), 64,
                              n_data)
    # against one rank: held on one 'data' rank, reported on several
    off = {"c": part(recall=0.5 + 2 / 64), "d": part()}
    with pytest.raises(AssertionError, match="from one rank"):
        check_fused_parts(result(part(recall=0.5 + 2 / 64), part(),
                                 unfused=off), 64, 1)
    rep = check_fused_parts(result(part(recall=0.5 + 2 / 64), part(),
                                   unfused=off), 64, 2)
    assert rep["c"]["vs_one"]["hits"] == 2.0
