"""Spatial image ops over NCHW tensors.

Counterpart of ``optimalstrategiesagainstgenerativeattacks_tpu/ops/image_ops.py``
(nearest upscale, average and max pooling, global max and mean pooling, the
StyleGAN [1,2,1] blur, LeakyReLU(0.2)).
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


def max_pool2d(x: torch.Tensor, window: int = 2, stride: int | None = None) -> torch.Tensor:
    """Max pooling with a square window (valid padding); the stride defaults to the window."""
    return F.max_pool2d(x, window, stride or window)


def adaptive_max_pool(x: torch.Tensor) -> torch.Tensor:
    """Global spatial max: NCHW -> [B, C]."""
    return x.amax(dim=(2, 3))


def adaptive_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Global spatial mean: NCHW -> [B, C]."""
    return x.mean(dim=(2, 3))


def blur3x3(x: torch.Tensor, normalize: bool = True, stride: int = 1) -> torch.Tensor:
    """Depthwise [1,2,1] x [1,2,1] blur (StyleGAN's BlurLayer), padding 1, in x's dtype.

    A conv with ``groups=C``, each group one channel to one channel.
    """
    k1d = torch.tensor([1.0, 2.0, 1.0])
    k = torch.outer(k1d, k1d)
    if normalize:
        k = k / k.sum()
    c = x.shape[1]
    kernel = k.to(device=x.device, dtype=x.dtype).expand(c, 1, 3, 3)
    return F.conv2d(x, kernel, stride=stride, padding=1, groups=c)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """LeakyReLU with the project-wide default slope of 0.2."""
    return F.leaky_relu(x, negative_slope)


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> NCHW view; a contiguous input gives channels_last memory."""
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> [B, H, W, C] view."""
    return x.permute(0, 2, 3, 1)
