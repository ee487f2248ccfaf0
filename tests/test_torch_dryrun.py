"""``sml_tpu_torch.parallel.dryrun.dryrun_multichip`` on 2 and 4 CPU
ranks (meshes (1, 2) and (2, 2)): one full step against one rank in
'alone', replay and 'all' mode (tables and Θ within 1e-4, equal recall at
999 negatives), and sharded against dense serving (equal id sets, scores
within 1e-5); on the CPU no kernel launches."""

import pytest

from sml_tpu_torch.parallel.dryrun import dryrun_multichip


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
