"""GAN losses of the game, as plain functions.

Counterpart of ``optimalstrategiesagainstgenerativeattacks_tpu/train/losses.py``
(``bce_with_logits``, ``gan_accuracy``, ``grad2_penalty``).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def bce_with_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Per-sample stable BCE-with-logits against a constant target; trailing axis squeezed."""
    l = logits.float()
    loss = torch.clamp(l, min=0.0) - l * target + torch.log1p(torch.exp(-l.abs()))
    return loss.squeeze(-1)


def gan_accuracy(out_on_real: torch.Tensor, out_on_fake: torch.Tensor):
    """(acc, acc_on_real, acc_on_fake) with prediction = logit >= 0."""
    acc_on_real = (out_on_real >= 0).float().mean()
    acc_on_fake = 1.0 - (out_on_fake >= 0).float().mean()
    return 0.5 * (acc_on_real + acc_on_fake), acc_on_real, acc_on_fake


def grad2_penalty(score_fn: Callable[..., torch.Tensor],
                  inputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-sample squared norm of d sum(score_fn(*inputs)) / d each input, summed over
    the inputs, in f32: [B].  Kept differentiable (``create_graph``), so a loss that
    adds it takes the double backward (the R1 penalty).  An input that does not
    require grad is differentiated through a detached copy that does."""
    xs = tuple(x if x.requires_grad else x.detach().requires_grad_(True) for x in inputs)
    grads = torch.autograd.grad(score_fn(*xs).sum(), xs, create_graph=True)
    b = xs[0].shape[0]
    return sum(g.float().square().reshape(b, -1).sum(1) for g in grads)
