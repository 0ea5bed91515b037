"""Gaussian GIM game models: the stat-pooling authenticator and the impersonator.

Counterpart of ``optimalstrategiesagainstgenerativeattacks_tpu/models/gaussian.py``:

  * authenticator = concat(stat(test), stat(si)) -> MLP((2 n_stats d, s d, 2 s d, 1)),
    kaiming(0.2) weights and zero biases, where s = ``hidden_scale``;
  * impersonator = mean of the leaked sample + MLP([d, d])-mapped noise, the
    noise's mean over the n fakes optionally removed.

The reference's unused ``out_mlp`` is left out, as in the JAX package.
Submodule names follow the Flax names (``dis.mlp``, ``dis.stat``,
``env_noise_mapper``), so ``port/transplant.py`` maps the trees by rule.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from optimalstrategiesagainstgenerativeattacks_torch.nn.blocks import MLP
from optimalstrategiesagainstgenerativeattacks_torch.nn.stats import MeanStdFcStat, MeanStdStat


class GIMGaussianDis(nn.Module):
    """Stat-pooling discriminator: ([B, n, d], [B, k, d]) -> [B, 1] logit."""

    def __init__(self, src_dim: int, stat: nn.Module, hidden_scale: int = 1):
        super().__init__()
        d, s = src_dim, hidden_scale
        self.stat = stat
        self.mlp = MLP((stat.n_stats * d * 2, s * d, 2 * s * d, 1), init="kaiming")

    def forward(self, test_sample, si_sample):
        return self.mlp(torch.cat([self.stat(test_sample), self.stat(si_sample)], dim=-1))


class GIMGaussianAuthenticator(nn.Module):
    """Thin wrapper over the discriminator."""

    def __init__(self, dis: GIMGaussianDis):
        super().__init__()
        self.dis = dis

    def forward(self, test_sample, si_sample):
        return self.dis(test_sample, si_sample)


class GIMGaussianImpersonator(nn.Module):
    """Mean of the leaked sample plus mapped noise: [B, m, d] -> [B, n, d]."""

    def __init__(self, src_dim: int, env_noise_mapper: nn.Module):
        super().__init__()
        self.src_dim = src_dim
        self.env_noise_mapper = env_noise_mapper

    def forward(self, leaked_sample, n: int, remove_noise_mean: bool = True,
                z: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """``z`` [B, n, d] replaces the noise draw from ``generator``."""
        b = leaked_sample.shape[0]
        src = leaked_sample.mean(dim=1)
        if z is None:
            z = torch.randn((b, n, self.src_dim), generator=generator,
                            device=leaked_sample.device, dtype=leaked_sample.dtype)
        w = self.env_noise_mapper(z)
        if remove_noise_mean:
            w = w - w.mean(dim=1, keepdim=True)
        return w + src[:, None, :]


def get_im(src_dim: int) -> GIMGaussianImpersonator:
    """The impersonator with a one-layer noise mapper."""
    return GIMGaussianImpersonator(src_dim, MLP([src_dim, src_dim]))


def get_au(src_dim: int, stat_type: str = "mean_std",
           hidden_scale: int = 1) -> GIMGaussianAuthenticator:
    """The authenticator; ``stat_type`` "mean_std" (the reference) or "mean_std_fc"
    (adds a learned per-element feature, hidden (4d, 4d)); ``hidden_scale`` widens
    the head."""
    if stat_type == "mean_std":
        stat = MeanStdStat()
    elif stat_type == "mean_std_fc":
        stat = MeanStdFcStat(src_dim, fc_n_stats=2, fc_hidden_layers=(4 * src_dim, 4 * src_dim))
    else:
        raise ValueError(f"unknown stat_type: {stat_type}")
    return GIMGaussianAuthenticator(GIMGaussianDis(src_dim, stat, hidden_scale))
