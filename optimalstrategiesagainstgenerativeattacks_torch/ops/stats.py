"""Permutation-invariant statistics over the episode ("set") axis.

Counterpart of ``optimalstrategiesagainstgenerativeattacks_tpu/ops/stats.py``.
"""

from __future__ import annotations

import torch

from optimalstrategiesagainstgenerativeattacks_torch.ops.precision import widen

def mean_stat(x: torch.Tensor) -> torch.Tensor:
    """[batch, sample, latent] -> [batch, latent] sample mean."""
    return x.mean(dim=1)


def custom_std(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Safe sample std over axis 1: sqrt(unbiased var + eps); zeros when sample_size == 1.

    The variance is written out as the mean of centred squares, the ops
    ``jnp.var`` is made of, rather than ``torch.var``: under the R1 double
    backward, ``torch.var``'s derivative formula leaves a term that is 0 in
    exact arithmetic (a shift of every set member alike leaves the std as it
    is) as a sum of large f32 terms, and the R1 gradient of the env
    encoder's last biases then misses the reference's at f32 tolerances.
    """
    if x.shape[1] > 1:
        return torch.sqrt(unbiased_var(x) + eps)
    return torch.zeros((x.shape[0], *x.shape[2:]), dtype=x.dtype, device=x.device)


def unbiased_var(x: torch.Tensor) -> torch.Tensor:
    """Unbiased sample variance over axis 1: the sum of centred squares over N - 1,
    computed in f32 and returned in x's dtype, as ``jnp.var`` computes a bf16 or f16
    input.  In bf16 the centred values of a set whose spread is small beside its
    mean would keep only a few bits, and the authenticator's set std with them."""
    f = widen(x)
    centred = f - f.mean(dim=1, keepdim=True)
    return ((centred * centred).sum(dim=1) / (x.shape[1] - 1)).to(x.dtype)


def std_stat(x: torch.Tensor) -> torch.Tensor:
    """[batch, sample, latent] -> [batch, latent] safe sample std."""
    return custom_std(x)


def mean_std_stat(x: torch.Tensor) -> torch.Tensor:
    """Concat of mean and safe std along the latent axis (n_stats=2)."""
    return torch.cat([mean_stat(x), std_stat(x)], dim=-1)


def logvar_stat(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """[batch, sample, latent] -> [batch, latent] log of (unbiased var + eps)."""
    return torch.log(unbiased_var(x) + eps)


def mean_logvar_stat(x: torch.Tensor) -> torch.Tensor:
    """Concat of mean and log-variance along the latent axis (n_stats=2)."""
    return torch.cat([mean_stat(x), logvar_stat(x)], dim=-1)
