"""Faults planted in the program's timed path, each a context manager that patches the
port's ``train/image.py`` for its duration and restores it after.  ``calibrate.py`` reads
them on the card at a cell's own size; ``tests/test_cudabench_faults.py`` drives a whole run
with each on the CPU and sees ``correct`` come out false.  The benchmark's own runs plant
none.

  unchanged   a step that returns its state unchanged: the optimizer never steps;
  half_loss   half of the batch left out, the mean taken over the rest: every fake is
              made, but each player's loss, R1 with it, is the mean over the batch's
              first half of episodes;
  half_batch  the same on the batch's first half alone (half the fakes made);
  sign        an answer altered where it is produced: each update applied with the
              wrong sign (the optimizer's state as it should be).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict

import torch


def _first_half_twice(per_episode: torch.Tensor) -> torch.Tensor:
    """The first half of the episodes' terms, twice: its mean is the first half's mean,
    and the other half reaches no gradient."""
    half = per_episode.shape[0] // 2
    return torch.cat([per_episode[:half], per_episode[:half]])


@contextlib.contextmanager
def _patched(module, **attrs):
    saved = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


def unchanged():
    from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg

    return _patched(timg, adam_step=lambda module, opt, loss: None)


def half_loss():
    from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg

    bce, r1 = timg.bce_with_logits, timg.r1_penalty
    return _patched(timg,
                    bce_with_logits=lambda logits, target: _first_half_twice(bce(logits, target)),
                    r1_penalty=lambda *a, **k: _first_half_twice(r1(*a, **k)))


def half_batch():
    from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg

    step = timg.train_step

    def first_half(state, batch, z=None):
        rows = batch["real_sample"].shape[0] // 2
        return step(state, {k: v[:rows] for k, v in batch.items()},
                    None if z is None else z[:rows])

    return _patched(timg, train_step=first_half)


def sign():
    from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg

    adam = timg.adam_step

    def backwards(module, opt, loss):
        before = [p.detach().clone() for p in module.parameters()]
        adam(module, opt, loss)
        with torch.no_grad():
            for p, b in zip(module.parameters(), before):
                p.copy_(2 * b - p)

    return _patched(timg, adam_step=backwards)


FAULTS: Dict[str, Callable] = {"unchanged": unchanged, "half_loss": half_loss,
                               "half_batch": half_batch, "sign": sign}
