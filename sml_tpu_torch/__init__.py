"""sml_tpu_torch — the SML sequential-retraining recommender in PyTorch/CUDA.

A port of ``sml_tpu`` (the JAX package beside it, which stays the
reference) to PyTorch with hand-written CUDA C++ kernels for NVIDIA Hopper
(``sm_90a``). The module layout mirrors ``sml_tpu`` so each module's
counterpart is found under the same path.

Ported so far: the forward (serving) path that publishes and serves period
*t*'s model — full-table transfer refresh (kernel ``csrc/transfer_kernel.cu``),
masked leave-one-out ranking (kernel ``csrc/eval_kernel.cu``) and
full-catalog top-K ``rank``. Training comes in a later slice.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU they raise instead of falling back. This package imports
neither JAX nor ``sml_tpu``.
"""

__version__ = "0.1.0"

from sml_tpu_torch import config  # noqa: F401
