"""Training utilities: EMA, interpolation, freezing, parameter counts.

Counterpart of ``optimalstrategiesagainstgenerativeattacks_tpu/train/utils.py``
(the reference's ``training/utils.py``).  The JAX package works on pytrees and
wraps optax transforms; here a module's parameters are updated in place and a
frozen parameter is one the optimizer never holds.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable

import torch


@torch.no_grad()
def accumulate(ema: torch.nn.Module, module: torch.nn.Module, decay: float = 0.999) -> None:
    """Polyak/EMA update in place, parameters only: ema <- decay * ema + (1 - decay) * module.

    Buffers (the spectral u, v) are not averaged: the reference's ``spectral``
    collection is not among its params.
    """
    for e, p in zip(ema.parameters(), module.parameters()):
        e.copy_(e * decay + p.to(e.dtype) * (1.0 - decay))


def lin_interpolation(a, b, t):
    """a + (b - a) * t, for tensors or (nested) dicts of them."""
    if isinstance(a, dict):
        return {k: lin_interpolation(a[k], b[k], t) for k in a}
    return a + (b - a) * t


def freeze_mask(module: torch.nn.Module, predicate: Callable[[str], bool]) -> Dict[str, bool]:
    """{parameter name: True where ``predicate(name)`` says frozen}."""
    return {name: bool(predicate(name)) for name, _ in module.named_parameters()}


def freeze(make_optimizer: Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer],
           module: torch.nn.Module, frozen_mask: Dict[str, bool]) -> torch.optim.Optimizer:
    """The optimizer ``make_optimizer`` builds over the parameters the mask leaves
    trainable: a frozen parameter gets no update and no optimizer state, as with
    ``optax.multi_transform`` and ``set_to_zero``."""
    return make_optimizer([p for name, p in module.named_parameters() if not frozen_mask[name]])


def num_parameters(module: torch.nn.Module) -> int:
    """Number of parameter entries (buffers such as the spectral u, v excluded)."""
    return sum(p.numel() for p in module.parameters())
