"""Bucketed padding with masked validity (counterpart of
``sml_tpu/ops/batching.py``).

Row counts are padded up to a *bucket* (a batch multiple with at most
1/``granularity`` slack) and a float ``mask`` marks the real rows, so the
port pads eval sets to exactly the shapes the JAX package does and the
evaluators see the same batches. Training epochs shuffle only the real rows
(:func:`shuffle_real_first`), so batches ``0 .. ceil(n_real/B) - 1`` hold
every real row and the padding stays in the tail: the epoch loop runs
exactly ``ceil(n_real/B)`` optimizer steps (:func:`num_batches`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from sml_tpu_torch.device import resolve_device


def bucket_rows(n: int, multiple: int, granularity: int = 8) -> int:
    """Round ``n`` up to a multiple of ``multiple`` with at most
    ``1/granularity`` relative slack beyond it."""
    n = max(n, 1)
    nb = -(-n // multiple)
    if nb <= granularity:
        return nb * multiple
    step = 1 << max(0, (nb - 1).bit_length() - granularity.bit_length())
    nb_b = -(-nb // step) * step
    return nb_b * multiple


class PaddedRows(NamedTuple):
    rows: torch.Tensor   # (n_pad, C) int32
    mask: torch.Tensor   # (n_pad,) float32, 1.0 for real rows
    n_real: int
    # packed negative-membership mask for the masked eval modes
    # ((n_pad, words) int32 holding uint32 words, ops/eval_kernel.py layout)
    cand_mask: Optional[torch.Tensor] = None


def pad_rows(arr: np.ndarray, batch_size: int, granularity: int = 8,
             pad_to: int = 0, device="cuda") -> PaddedRows:
    """Pad a host int array (N, C) to a bucketed shape and move it to
    ``device``. ``pad_to`` raises the bucket to a caller-chosen floor
    (itself bucketed)."""
    device = resolve_device(device)
    n = arr.shape[0]
    n_pad = bucket_rows(n, batch_size, granularity)
    if pad_to:
        n_pad = max(n_pad, bucket_rows(pad_to, batch_size, granularity))
    out = np.zeros((n_pad, arr.shape[1]), dtype=np.int32)
    out[:n] = arr
    mask = np.zeros((n_pad,), dtype=np.float32)
    mask[:n] = 1.0
    return PaddedRows(torch.from_numpy(out).to(device),
                      torch.from_numpy(mask).to(device), n)


def shuffle_real_first(generator: torch.Generator, rows: torch.Tensor,
                       mask: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A random permutation that keeps the padded rows at the tail: real
    rows get uniform sort keys drawn from ``generator`` (on the rows'
    device), padded rows ``+inf``."""
    r = torch.rand(rows.shape[0], generator=generator, device=rows.device)
    r = torch.where(mask > 0, r, torch.full_like(r, float("inf")))
    order = torch.argsort(r)
    return rows[order], mask[order]


def num_batches(n_real: int, batch_size: int) -> int:
    """``ceil(n_real / batch_size)``, the epoch's optimizer-step count."""
    return (n_real + batch_size - 1) // batch_size
