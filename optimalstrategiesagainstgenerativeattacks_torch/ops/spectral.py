"""Spectral-norm state: one power iteration per player per step, and sigma.

Counterpart of ``optimalstrategiesagainstgenerativeattacks_tpu/ops/spectral.py``
(``power_iterate``, ``compute_sigmas``).  Each spectrally normalised conv
views its weight as the matrix W = weight.reshape(out, in * kh * kw) (torch's
(out, in, kh, kw) order) and keeps buffers u [out] and v [fan]:

  * ``power_iterate``: v' = l2n(W^T u), u' = l2n(W v'), W without gradient;
  * ``sigma``: u^T W v, differentiable through W and not through u, v.

The game advances u, v once per player per step, not on every forward, so
``torch.nn.utils.spectral_norm`` (which updates on each forward) is not used.
"""

from __future__ import annotations

import torch

EPS = 1e-12


def l2_normalize(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x) + eps)


def weight_matrix(weight: torch.Tensor) -> torch.Tensor:
    """(out, in, kh, kw) conv weight -> (out, in * kh * kw)."""
    return weight.reshape(weight.shape[0], -1)


@torch.no_grad()
def power_iterate_(weight: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                   eps: float = EPS) -> None:
    """One power iteration, writing the new vectors into ``u`` and ``v``."""
    w = weight_matrix(weight)
    v.copy_(l2_normalize(w.t() @ u, eps))
    u.copy_(l2_normalize(w @ v, eps))


def sigma(weight: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """First singular value estimate u^T W v (gradient flows through W only)."""
    return torch.dot(u, weight_matrix(weight) @ v)


def power_iterate(module: torch.nn.Module) -> None:
    """Advance the spectral state of every spectrally normalised conv in ``module``."""
    for m in module.modules():
        if hasattr(m, "power_iterate_"):
            m.power_iterate_()
