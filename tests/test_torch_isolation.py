"""The port stands alone: no JAX, no ``sml_tpu``, no quiet CPU fallback.

* every module of ``sml_tpu_torch`` (``parallel/`` included) and
  ``chip_smoke.py`` imports in a fresh interpreter where ``jax``,
  ``jaxlib``, ``optax`` and ``sml_tpu`` cannot be imported;
* no file of the port names them in an import statement (matched exactly:
  ``sml_tpu`` and ``sml_tpu.*``, never the port's own ``sml_tpu_torch``);
* an entry point called without ``device`` raises on a host without a GPU;
* on CPU tensors the kernels' launch counters stay at 0.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "sml_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "sml_tpu")


@pytest.fixture(autouse=True)
def one_thread():
    # the CPU sweeps here are tiny: on torch's pool, shared with the other
    # test workers, they wait on the pool far longer than they compute
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_files():
    # the multi-process tests' rank functions start without JAX as well
    return sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "torch_parallel_workers.py"]


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_forbidden_matcher_is_exact():
    assert _forbidden("sml_tpu") and _forbidden("sml_tpu.ops.metrics")
    assert _forbidden("jax.numpy") and _forbidden("optax")
    assert not _forbidden("sml_tpu_torch") and not _forbidden("jaxtyping")
    assert not _forbidden("sml_tpu_torch.ops.eval_kernel")


def test_port_sources_import_no_jax_or_reference():
    offenders = []
    for f in _port_files():
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{f.relative_to(ROOT)}:{node.lineno} {n}"
                          for n in names if _forbidden(n)]
    assert not offenders, offenders
    assert len(_port_files()) > 15
    # the parallel layer is among the files checked
    names = {str(f.relative_to(PORT)) for f in _port_files()
             if PORT in f.parents}
    assert {f"parallel/{m}.py" for m in ("sharding", "collective",
                                         "multihost", "dryrun")} <= names
    # and the fused programs' CUDA graphs
    assert "train/graphs.py" in names
    # and the memory checks' driver and the programs' stress run
    assert {"scripts/sanitize.py", "scripts/program_stress.py"} <= names
    # and the production-scale run, its serving check and the results file
    assert {"scripts/scale_engine_run.py", "scripts/scale_serve.py",
            "utils/results.py"} <= names
    # and the driver's sweep at production scale
    assert "scripts/scale_sweep.py" in names
    # and the two protocol scripts, what they share and their runner
    assert {"scripts/adressa_run.py", "scripts/yelp_scale_sweep.py",
            "scripts/protocol.py", "scripts/protocol_runs.py"} <= names


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        f"for m in {FORBIDDEN!r}:\n"
        "    sys.modules[m] = None\n"
        "import importlib, pkgutil, sml_tpu_torch, chip_smoke\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    sml_tpu_torch.__path__, 'sml_tpu_torch.')\n"
        "    if not m.name.endswith('__main__')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in\n"
        f"           {FORBIDDEN!r} and sys.modules[m] is not None]\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_entry_points_default_to_cuda_and_raise_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is usable")
    from sml_tpu_torch import cli
    from sml_tpu_torch.config import SMLConfig
    from sml_tpu_torch.device import resolve_device
    from sml_tpu_torch.train.engine import SMLEngine
    from sml_tpu_torch.utils.checkpoint import state_from_checkpoint

    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        SMLEngine(SMLConfig(), 10, 10)
    with pytest.raises(RuntimeError, match="cuda"):
        state_from_checkpoint(str(tmp_path))
    model = tmp_path / "m.npz"
    np.savez(model, user_emb=np.zeros((3, 4), np.float32),
             item_emb=np.zeros((5, 4), np.float32),
             user_bias=np.zeros((3, 1), np.float32),
             item_bias=np.zeros((5, 1), np.float32))
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["rank", "--model", str(model), "--users", "0"])
    # the public constructors default to the card as well
    from sml_tpu_torch.config import TransferConfig
    from sml_tpu_torch.models.mf import init_mf
    from sml_tpu_torch.models.transfer import init_transfer, theta_from_numpy
    from sml_tpu_torch.ops.batching import pad_rows
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="cuda"):
        init_mf(gen, 3, 5, 4)
    with pytest.raises(RuntimeError, match="cuda"):
        init_transfer(gen, TransferConfig(latent_dim=4))
    theta = init_transfer(gen, TransferConfig(latent_dim=4), device="cpu")
    tree = {side: {f: p.detach().numpy()
                   for f, p in getattr(theta, side).named_parameters()}
            for side in ("user", "item")}
    with pytest.raises(RuntimeError, match="cuda"):
        theta_from_numpy(tree)
    with pytest.raises(RuntimeError, match="cuda"):
        pad_rows(np.zeros((3, 4), np.int64), 8)
    # the multi-rank launchers and the dry run, before any rank starts
    from sml_tpu_torch.parallel.dryrun import (dryrun_multichip,
                                               run_cli_world, run_world)
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="cuda"):
        run_world("sml_tpu_torch.parallel.dryrun:check_transport", 2)
    with pytest.raises(RuntimeError, match="cuda"):
        run_cli_world(["rank", "--model", str(model), "--users", "0"], 2)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_cpu_tensors_never_launch_kernels(synthetic_dataset):
    from sml_tpu_torch.config import SMLConfig, TransferConfig
    from sml_tpu_torch.data.formats import load_test
    from sml_tpu_torch.ops import eval_kernel, transfer_kernel
    from sml_tpu_torch.train.engine import SMLEngine

    dspec, info, _ = synthetic_dataset
    before = (transfer_kernel.transfer_rows_cuda.launches,
              eval_kernel.masked_rank_cuda.launches)
    cfg = SMLConfig(latent_dim=8, eval_scoring="masked", eval_batch_size=64,
                    transfer=TransferConfig(latent_dim=8, fc_hidden=32))
    eng = SMLEngine(cfg, info.n_users, info.n_items, device="cpu")
    state = eng.refresh(eng.snapshot_last(eng.init_state()))
    ev = eng.make_eval_set(load_test(dspec.path, dspec.online_test_start),
                           build_mask=True)
    assert ev.cand_mask is not None
    eng.evaluate(state.mf, ev)
    assert (transfer_kernel.transfer_rows_cuda.launches,
            eval_kernel.masked_rank_cuda.launches) == before == (0, 0)


def test_training_entry_points_default_to_cuda_and_raise_without_gpu(
        synthetic_dataset, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is usable")
    from sml_tpu_torch import cli
    from sml_tpu_torch.config import SMLConfig
    from sml_tpu_torch.ops.sampling import build_period_index
    from sml_tpu_torch.train.driver import SMLDriver
    from sml_tpu_torch.train.optim import opt_state_from_numpy

    dspec, _, _ = synthetic_dataset
    args = ["sml", "--data-root", dspec.root, "--data-name", dspec.name,
            "--num-periods", str(dspec.num_periods), "--online-train-start",
            str(dspec.online_train_start), "--online-test-start",
            str(dspec.online_test_start), "--latent", "8"]
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(args)
    with pytest.raises(RuntimeError, match="cuda"):
        SMLDriver(SMLConfig(latent_dim=8), dspec)
    with pytest.raises(RuntimeError, match="cuda"):
        build_period_index(np.zeros((4, 2), np.int64), 3)
    with pytest.raises(RuntimeError, match="cuda"):
        opt_state_from_numpy({"count": 0, "mu": {}, "nu": {}})
    # the same command runs when asked for the CPU
    out = tmp_path / "m.npz"
    assert cli.main(["--device", "cpu"] + args + [
        "--multi-num", "1", "--mf-sample", "alone", "--saddle-retries", "0",
        "--save-model", str(out)]) == 0
    assert out.exists()


def test_pretrain_baseline_and_probes_raise_without_gpu(synthetic_dataset):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is usable")
    from sml_tpu_torch import cli
    from sml_tpu_torch.config import BaselineConfig, PretrainConfig
    from sml_tpu_torch.scripts import (eval_kernel_probe, eval_variants,
                                       scorer_timing)
    from sml_tpu_torch.train.baselines import BaselineDriver
    from sml_tpu_torch.train.pretrain import pretrain_mf

    dspec, _, _ = synthetic_dataset
    with pytest.raises(RuntimeError, match="cuda"):
        pretrain_mf(PretrainConfig(latent_dim=4), dspec, 4)
    with pytest.raises(RuntimeError, match="cuda"):
        BaselineDriver(BaselineConfig(latent_dim=4), dspec)
    with pytest.raises(RuntimeError, match="cuda"):
        eval_variants.main(["--rows", "1024", "--items", "300"])
    with pytest.raises(RuntimeError, match="cuda"):
        eval_kernel_probe.main(["--rows", "256", "--items", "4096"])
    with pytest.raises(RuntimeError, match="cuda"):
        scorer_timing.main(["--rows", "1024", "--items", "300"])
    data = ["--data-root", dspec.root, "--data-name", dspec.name,
            "--num-periods", "8", "--online-train-start", "3",
            "--online-test-start", "5", "--latent", "4"]
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["pretrain", "--out", "unused.npz"] + data)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["baseline"] + data)


def test_kernel_wrappers_take_only_cuda_tensors():
    from sml_tpu_torch.ops import eval_kernel, probe_kernels
    ue = torch.zeros(4, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        probe_kernels.candidate_scores_cuda(
            ue, torch.zeros(4, dtype=torch.int32),
            torch.zeros(4, 3, dtype=torch.int32), ue)
    with pytest.raises(ValueError, match="CUDA"):
        probe_kernels.dense_mask_rank_cuda(
            torch.zeros(16, 64, dtype=torch.bfloat16), ue,
            torch.zeros(4, dtype=torch.int32),
            torch.zeros(4, 16, dtype=torch.int8))
    with pytest.raises(ValueError, match="CUDA"):
        eval_kernel.masked_rank_variant_cuda(
            torch.zeros(4, 8), torch.zeros(8, 4096), torch.zeros(4),
            torch.zeros(4, 128, dtype=torch.int32))
    assert (probe_kernels.candidate_scores_cuda.launches,
            probe_kernels.dense_mask_rank_cuda.launches,
            eval_kernel.masked_rank_variant_cuda.launches) == (0, 0, 0)


def test_cpu_training_never_launches_kernels(synthetic_dataset):
    from sml_tpu_torch.config import SMLConfig, TransferConfig
    from sml_tpu_torch.ops import adam_kernel, eval_kernel, transfer_kernel
    from sml_tpu_torch.train.driver import SMLDriver

    dspec, _, _ = synthetic_dataset
    cfg = SMLConfig(latent_dim=8, multi_num=1, mf_sample="alone",
                    fast_table_adam=True, eval_scoring="masked",
                    eval_batch_size=64, mf_batch_size=64,
                    transfer=TransferConfig(latent_dim=8, fc_hidden=32))
    driver = SMLDriver(cfg, dspec, device="cpu")
    report = driver.run(max_periods=3)
    driver.close()
    assert report.test_counts
    assert (adam_kernel.decay_adam_cuda.launches,
            transfer_kernel.transfer_rows_cuda.launches,
            eval_kernel.masked_rank_cuda.launches) == (0, 0, 0)
