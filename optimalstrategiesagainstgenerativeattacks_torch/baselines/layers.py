"""Layers of the baseline authenticators, with Flax's semantics.

  * ``BatchNorm``: Flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``, which is
    not torch's.  Training normalises with the batch mean and the *biased*
    variance E[x^2] - E[x]^2 (clipped at 0, in f32), and updates the running
    statistics as ``0.9 * running + 0.1 * batch`` with that biased variance;
    torch's ``BatchNorm`` takes ``momentum=0.1`` for the same update but
    stores the unbiased variance, off by B/(B-1).  Eval reads the running
    statistics.  The channel axis is 1 (NCHW, or [B, features]).
  * ``PReLU``: per-channel slope, 0.25 at init, ``where(x >= 0, x, a * x)``.
  * ``lecun_normal_``: Flax's default kernel init (truncated normal, std
    sqrt(1 / fan_in) / .8796, cut at 2 std), drawn from the generator that
    ``nn/init.py:init_module`` passes (the global one at construction);
    biases start at 0.
"""

from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, generator: torch.Generator | None) -> None:
    std = math.sqrt(1.0 / weight[0].numel()) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def channel_view(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-channel vector shaped to broadcast over axis 1 of an ``ndim`` tensor."""
    return t.view(1, -1, *([1] * (ndim - 2)))


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm`` over axis 1 (see the module docstring)."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.momentum = momentum
        self.eps = eps

    def forward(self, x):
        if self.training:
            axes = [0, *range(2, x.ndim)]
            xf = x.float()
            mean = xf.mean(axes)
            var = torch.clamp(xf.square().mean(axes) - mean.square(), min=0.0)
            with torch.no_grad():
                self.running_mean.copy_(self.momentum * self.running_mean
                                        + (1.0 - self.momentum) * mean)
                self.running_var.copy_(self.momentum * self.running_var
                                       + (1.0 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - channel_view(mean, x.ndim)) * channel_view(mul, x.ndim)
        return y + channel_view(self.bias, x.ndim)


class PReLU(nn.Module):
    """Per-channel parametric ReLU over axis 1."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x):
        return torch.where(x >= 0, x, channel_view(self.alpha.to(x.dtype), x.ndim) * x)


class Conv(nn.Conv2d):
    """``nn.Conv2d`` with Flax's default init: lecun normal kernel, zero bias."""

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        lecun_normal_(self.weight, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class Dense(nn.Linear):
    """``nn.Linear`` with Flax's default init: lecun normal kernel, zero bias."""

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        lecun_normal_(self.weight, generator)
        nn.init.zeros_(self.bias)
