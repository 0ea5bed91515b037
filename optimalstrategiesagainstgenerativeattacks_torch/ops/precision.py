"""The port's upcast of a value it keeps in f32."""

from __future__ import annotations

import torch


def widen(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32, where the port keeps a bf16 value, a sum or a statistic in f32;
    an f64 ``x`` stays f64, so an f64 run of the port (a reference) stays f64."""
    return x if x.dtype == torch.float64 else x.float()
