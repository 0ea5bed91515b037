"""The port's upcast of a value it keeps in f32, and its f32 products on the card."""

from __future__ import annotations

import torch


def widen(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32, where the port keeps a bf16 value, a sum or a statistic in f32;
    an f64 ``x`` stays f64, so an f64 run of the port (a reference) stays f64."""
    return x if x.dtype == torch.float64 else x.float()


def exact_f32() -> None:
    """Compute f32 convs and matmuls in f32 on the card, not in TF32.

    PyTorch lets cuDNN run an f32 conv in TF32 by default
    (``torch.backends.cudnn.allow_tf32``): its operands rounded to 10 mantissa
    bits.  The reference's CPU compile, which the tests hold the port to, multiplies
    them exactly, so every training and eval loop turns both flags off first."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
