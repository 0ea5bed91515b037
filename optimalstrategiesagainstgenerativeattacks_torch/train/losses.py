"""GAN losses of the game, as plain functions.

Counterpart of ``optimalstrategiesagainstgenerativeattacks_tpu/train/losses.py``
(``bce_with_logits``, ``gan_accuracy``).
"""

from __future__ import annotations

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
