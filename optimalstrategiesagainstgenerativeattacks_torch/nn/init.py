"""Weight initialisers with an explicit ``torch.Generator``.

Counterpart of ``optimalstrategiesagainstgenerativeattacks_tpu/nn/init.py``:
the same distributions (torch's defaults), drawn from a generator the caller
owns rather than the global RNG.

  * torch Conv2d / Linear default: weight and bias Uniform(+-1/sqrt(fan_in));
  * ``kaiming_normal(a=0.2)`` (the discriminator head): N(0, 2/((1+a^2) fan_in)),
    zero bias.
"""

from __future__ import annotations

import math

import torch


@torch.no_grad()
def torch_default_(weight: torch.Tensor, bias, generator: torch.Generator) -> None:
    fan_in = weight[0].numel()
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    weight.uniform_(-bound, bound, generator=generator)
    if bias is not None:
        bias.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def kaiming_normal_(weight: torch.Tensor, bias, generator: torch.Generator,
                    a: float = 0.2) -> None:
    fan_in = weight[0].numel()
    weight.normal_(0.0, math.sqrt(2.0 / ((1.0 + a * a) * fan_in)), generator=generator)
    if bias is not None:
        bias.zero_()


def init_module(module: torch.nn.Module, generator: torch.Generator) -> None:
    """Initialise every submodule that defines ``reset_parameters(generator)``."""
    for m in module.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(generator)
