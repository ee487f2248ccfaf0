"""The precision the reference's float32 products run in."""

from __future__ import annotations

from contextlib import contextmanager

import torch


@contextmanager
def precision(mode: str):
    """float32 products in full f32 (``"f32"``) or in TF32 (``"tf32"``,
    the control's step below the configurations' f32 with TF32 off)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    on = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
