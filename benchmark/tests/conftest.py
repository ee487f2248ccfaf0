"""Shared fixtures of the benchmark's tests: the package's directory on
``sys.path`` (as ``run.py`` puts it there) and the tiny CPU shapes."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
DATA = Path(__file__).resolve().parent / "data"
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def cuda_card():
    """Skips a test on a host without a CUDA card (decided here, not at
    import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")

