"""Game states: both players, their optimizers, the step and the generator.

Counterpart of ``optimalstrategiesagainstgenerativeattacks_tpu/train/state.py``,
one dataclass a game.  The spectral-norm u/v vectors live as buffers inside
the image players' modules, and the players' parameters are updated in place
by their Adams.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from optimalstrategiesagainstgenerativeattacks_torch.parallel.mesh import all_reduce_grads_
from optimalstrategiesagainstgenerativeattacks_torch.parallel.tensor import sharded_params
from optimalstrategiesagainstgenerativeattacks_torch.utils.config import (
    GaussianGameConfig,
    ImageGameConfig,
)


@dataclass
class GameState:
    """Full mutable state of an image GIM game."""

    cfg: ImageGameConfig
    au: torch.nn.Module
    im: torch.nn.Module
    opt_au: torch.optim.Optimizer
    opt_im: torch.optim.Optimizer
    sched_au: torch.optim.lr_scheduler.LRScheduler
    sched_im: torch.optim.lr_scheduler.LRScheduler
    generator: torch.Generator  # draws the impersonator's noise z
    step: int = -1  # pre-incremented by every train step, as in the reference

    @property
    def device(self) -> torch.device:
        return next(self.au.parameters()).device


@dataclass
class GaussianState:
    """Full mutable state of a Gaussian GIM game (no spectral state, no schedulers)."""

    cfg: GaussianGameConfig
    au: torch.nn.Module
    im: torch.nn.Module
    opt_au: torch.optim.Optimizer
    opt_im: torch.optim.Optimizer
    generator: torch.Generator  # draws every batch and the impersonator's noise
    step: int = -1

    @property
    def device(self) -> torch.device:
        return next(self.au.parameters()).device


def adam_step(module: torch.nn.Module, opt: torch.optim.Optimizer, loss: torch.Tensor) -> None:
    """One optimizer step of ``module`` on ``loss``; the gradient is taken with
    ``torch.autograd.grad`` over the module's parameters only, so a frozen
    player in the same graph keeps its ``.grad`` untouched.  In a process group
    the gradients are averaged over the data axis first (``all_reduce_grads_``);
    a weight sharded over the model axis (``parallel/tensor.py``) steps on this
    rank's rows, with its rows' gradient."""
    params = list(module.parameters())
    for p, g in zip(params, torch.autograd.grad(loss, params)):
        p.grad = g
    all_reduce_grads_(params, sharded_params(module))
    opt.step()
    opt.zero_grad(set_to_none=True)
