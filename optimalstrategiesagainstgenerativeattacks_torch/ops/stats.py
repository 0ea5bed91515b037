"""Permutation-invariant statistics over the episode ("set") axis.

Counterpart of ``optimalstrategiesagainstgenerativeattacks_tpu/ops/stats.py``.
"""

from __future__ import annotations

import torch


def mean_stat(x: torch.Tensor) -> torch.Tensor:
    """[batch, sample, latent] -> [batch, latent] sample mean."""
    return x.mean(dim=1)


def custom_std(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Safe sample std over axis 1: sqrt(unbiased var + eps); zeros when sample_size == 1."""
    if x.shape[1] > 1:
        return torch.sqrt(x.var(dim=1, unbiased=True) + eps)
    return torch.zeros((x.shape[0], *x.shape[2:]), dtype=x.dtype, device=x.device)
