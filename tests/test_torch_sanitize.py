"""The memory checks' driver (``sml_tpu_torch/scripts/sanitize.py``) and
the programs' stress run (``scripts/program_stress.py``) on the CPU.

* the targets cover every counted kernel wrapper (``_build.COUNTED``) and
  the CUDA-graph IF nodes, so a kernel added without a target fails here;
* each target runs through its wrappers' CPU route (the plain versions)
  and agrees with the plain functions, its calls repeated bit-equal;
* one round of the stress run at its tiny size;
* ``compute-sanitizer`` is looked for beside ``nvcc`` and its absence
  raises; the tools' summary lines, ptxas's reports and the checks'
  verdicts are read as the card prints them.
"""

import pytest
import torch

from sml_tpu_torch import _build
# the kernel modules register their wrappers in _build.COUNTED
from sml_tpu_torch.ops import (adam_kernel, eval_kernel,  # noqa: F401
                               probe_kernels, transfer_kernel)
from sml_tpu_torch.scripts import program_stress, sanitize


def test_targets_cover_every_counted_wrapper_and_the_if_nodes():
    counted = {w.__name__ for w in _build.COUNTED}
    assert len(counted) == 6
    covered = {c for t in sanitize.TARGETS.values() for c in t.covers}
    assert counted <= covered, counted - covered
    # the IF nodes' entries, reached only inside a capture
    assert {"sml_if_begin", "sml_if_end"} <= set(_build.SIGNATURES)
    program = [t for t in sanitize.TARGETS.values() if t.kind == "program"]
    assert [t.covers for t in program] == [("sml_if_begin", "sml_if_end")]
    assert {t.name for t in sanitize.TARGETS.values()
            if t.kind == "kernel"} == {"k1", "k2", "k3", "p1", "p2", "p3"}


@pytest.mark.parametrize("name", sorted(sanitize.TARGETS))
def test_target_agrees_with_its_plain_version_on_cpu(name):
    out = sanitize.run_target(name, torch.device("cpu"), repeats=2)
    assert out["ok"] and out["target"] == name and out["cases"]
    assert out.get("max_abs_err", 0) <= sanitize.K1_TOL


def test_repeated_calls_must_give_the_same_bits():
    g = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="other bits"):
        sanitize.repeated(lambda: torch.rand(4, generator=g), 2)
    out = sanitize.repeated(lambda: (torch.ones(3), torch.zeros(2)), 3)
    assert torch.equal(out[0], torch.ones(3))


def test_program_stress_one_round_on_cpu(capsys):
    assert program_stress.main(["--device", "cpu", "--rounds", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert '"ok": true' in lines[0] and '"failed_rounds": 0' in lines[-1]


def _fake_toolkit(tmp_path, with_sanitizer: bool):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    for name in ("nvcc",) + (("compute-sanitizer",) if with_sanitizer
                             else ()):
        exe = bin_dir / name
        exe.write_text("#!/bin/sh\nexit 0\n")
        exe.chmod(0o755)
    return bin_dir


def test_missing_sanitizer_raises(tmp_path, monkeypatch):
    bin_dir = _fake_toolkit(tmp_path, with_sanitizer=False)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert _build.find_nvcc() == str(bin_dir / "nvcc")
    with pytest.raises(RuntimeError, match="compute-sanitizer not found"):
        sanitize.find_sanitizer()
    # --all looks for the tool before it runs anything
    with pytest.raises(RuntimeError, match="compute-sanitizer not found"):
        sanitize.run_all()


def test_sanitizer_found_beside_nvcc(tmp_path, monkeypatch):
    bin_dir = _fake_toolkit(tmp_path, with_sanitizer=True)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert sanitize.find_sanitizer() == str(bin_dir / "compute-sanitizer")


@pytest.mark.parametrize("text,errors,unsupported", [
    ("========= ERROR SUMMARY: 0 errors", 0, False),
    ("========= ERROR SUMMARY: 3 errors", 3, False),
    ("========= RACECHECK SUMMARY: 0 hazards displayed (0 errors, "
     "0 warnings)", 0, False),
    ("========= RACECHECK SUMMARY: 2 hazards displayed (1 error, "
     "1 warning)", 1, False),
    ("========= Error: Device not supported. Please refer to the "
     "\"Supported Devices\" section of the sanitizer documentation\n"
     "========= ERROR SUMMARY: 1 error", 1, True),
])
def test_read_sanitizer_summaries(text, errors, unsupported):
    got = sanitize.read_sanitizer("noise\n" + text + "\n")
    assert got["errors"] == errors
    assert bool(got["unsupported"]) == unsupported
    assert got["summary"] is not None


UNSUPPORTED = ("========= Error: Device not supported. Please refer to the "
               "\"Supported Devices\" section of the sanitizer documentation")
TRACE = ("Traceback (most recent call last):\n"
         "torch.AcceleratorError: CUDA error")


@pytest.mark.parametrize("rc,text,result,err,status", [
    # the target ran to its end, the tool counted nothing
    (0, "ERROR SUMMARY: 0 errors", {"ok": True}, "", "clean"),
    # the tool counted errors in a target that ran
    (1, "ERROR SUMMARY: 2 errors", {"ok": True}, "", "errors"),
    # the tool refused the device and the target's process then died of
    # a CUDA error: a failed run, not a quiet "unsupported"
    (1, UNSUPPORTED + "\nERROR SUMMARY: 3 errors", None, TRACE, "failed"),
    # the tool refused the device before the target started
    (1, UNSUPPORTED, None, "", "unsupported"),
    # the tool counted errors in a target that then failed (an illegal
    # address it reported)
    (1, "ERROR SUMMARY: 1 error", None, TRACE, "errors"),
    # the target failed with no word from the tool
    (1, "ERROR SUMMARY: 0 errors", None, TRACE, "failed"),
    # a timeout
    (None, "", None, "", "failed"),
])
def test_sanitizer_status(rc, text, result, err, status):
    read = sanitize.read_sanitizer(text)
    assert sanitize.sanitizer_status(rc, read, result, err) == status


def test_all_takes_no_tools_or_known_ones():
    with pytest.raises(SystemExit):
        sanitize.main(["--all", "--tools", "memcheck,valgrind"])


def test_ptxas_usage_reads_registers_and_spills():
    log = ("ptxas info    : Compiling entry function '_Z1kPf' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z1kPf\n"
           "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill "
           "loads\n"
           "ptxas info    : Used 40 registers, used 1 barriers\n"
           "ptxas info    : Compiling entry function '_Z1jv' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z1jv\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\n"
           "ptxas info    : Used 255 registers\n")
    assert sanitize.ptxas_usage(log) == {"_Z1kPf": (40, 8, 4),
                                         "_Z1jv": (255, 0, 0)}


def test_lineinfo_only_adds_line_tables():
    assert "-lineinfo" in _build.NVCC_FLAGS
    assert sanitize.FENCE_SOURCE.exists()
    # the fence is not part of the kernel library
    assert sanitize.FENCE_SOURCE not in _build.sources()


def test_fence_takes_a_kernel_target_on_the_card():
    with pytest.raises(SystemExit):
        sanitize.main(["--device", "cpu", "--target", "k3", "--fence",
                       "tail"])
