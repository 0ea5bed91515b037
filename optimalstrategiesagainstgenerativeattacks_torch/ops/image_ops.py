"""Spatial image ops over NCHW tensors.

Counterpart of ``optimalstrategiesagainstgenerativeattacks_tpu/ops/image_ops.py``
(nearest upscale, 2x2 average pooling, global max pooling, LeakyReLU(0.2)).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upscale2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upscale of NCHW by an integer factor."""
    if factor == 1:
        return x
    return F.interpolate(x, scale_factor=factor, mode="nearest")


def avg_pool2d(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Average pooling with a square window equal to its stride (valid padding)."""
    return F.avg_pool2d(x, window)


def adaptive_max_pool(x: torch.Tensor) -> torch.Tensor:
    """Global spatial max: NCHW -> [B, C]."""
    return x.amax(dim=(2, 3))


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """LeakyReLU with the project-wide default slope of 0.2."""
    return F.leaky_relu(x, negative_slope)


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> NCHW view; a contiguous input gives channels_last memory."""
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> [B, H, W, C] view."""
    return x.permute(0, 2, 3, 1)
