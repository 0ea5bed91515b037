"""Spectral-norm state: one power iteration per player per step, and sigma.

Counterpart of ``optimalstrategiesagainstgenerativeattacks_tpu/ops/spectral.py``
(``power_iterate``, ``compute_sigmas``).  Each spectrally normalised conv
views its weight as the matrix W = weight.reshape(out, in * kh * kw) (torch's
(out, in, kh, kw) order) and keeps buffers u [out] and v [fan]:

  * ``power_iterate``: v' = l2n(W^T u), u' = l2n(W v'), W without gradient;
  * ``sigma``: u^T W v, differentiable through W and not through u, v.

The game advances u, v once per player per step, not on every forward, so
``torch.nn.utils.spectral_norm`` (which updates on each forward) is not used.

Over a row-sharded W (``parallel/tensor.py``: this rank holds rows W_m of
the model axis ``axis``, u and v stay whole and equal on every rank, as the
JAX state replicates them):

  * v' = l2n(sum_m W_m^T u_m), one all-reduce over the model group;
  * u' = l2n(W v'): the local rows W_m v', their squared norm all-reduced,
    then the normalised rows gathered;
  * sigma = the sum over the model group of u_m^T W_m v, differentiable
    through W_m, and read back into the rows through ``copy_to_model``: each
    rank's W_m / sigma sees only its slice of the output, so the backward sums
    the ranks' cotangents of sigma before they reach W_m.
"""

from __future__ import annotations

from typing import Optional

import torch

from optimalstrategiesagainstgenerativeattacks_torch.parallel import tensor
from optimalstrategiesagainstgenerativeattacks_torch.parallel.mesh import Axis

EPS = 1e-12


def l2_normalize(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x) + eps)


def weight_matrix(weight: torch.Tensor) -> torch.Tensor:
    """(out, in, kh, kw) conv weight -> (out, in * kh * kw)."""
    return weight.reshape(weight.shape[0], -1)


@torch.no_grad()
def power_iterate_(weight: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                   eps: float = EPS, axis: Optional[Axis] = None) -> None:
    """One power iteration, writing the new vectors into ``u`` and ``v``; with
    ``axis``, ``weight`` holds this rank's rows of W."""
    w = weight_matrix(weight)
    if axis is None:
        v.copy_(l2_normalize(w.t() @ u, eps))
        u.copy_(l2_normalize(w @ v, eps))
        return
    v.copy_(l2_normalize(tensor.all_reduce_sum(w.t() @ u[tensor.local_rows(len(u), axis)],
                                               axis), eps))
    u_m = w @ v
    norm = torch.sqrt(tensor.all_reduce_sum(u_m.square().sum(), axis))
    u.copy_(tensor.all_gather(u_m / (norm + eps), axis, 0))


def sigma(weight: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
          axis: Optional[Axis] = None) -> torch.Tensor:
    """First singular value estimate u^T W v (gradient flows through W only); with
    ``axis``, ``weight`` holds this rank's rows of W."""
    if axis is None:
        return torch.dot(u, weight_matrix(weight) @ v)
    local = torch.dot(u[tensor.local_rows(len(u), axis)], weight_matrix(weight) @ v)
    return tensor.copy_to_model(tensor.reduce_from_model(local, axis), axis)


def power_iterate(module: torch.nn.Module) -> None:
    """Advance the spectral state of every spectrally normalised conv in ``module``."""
    for m in module.modules():
        if hasattr(m, "power_iterate_"):
            m.power_iterate_()
