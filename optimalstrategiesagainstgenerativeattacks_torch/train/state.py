"""Game state: both players, their optimizers, the step and the noise generator.

Counterpart of ``optimalstrategiesagainstgenerativeattacks_tpu/train/state.py``.
The spectral-norm u/v vectors live as buffers inside the players' modules,
and the players' parameters are updated in place by their Adams.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from optimalstrategiesagainstgenerativeattacks_torch.utils.config import ImageGameConfig


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
