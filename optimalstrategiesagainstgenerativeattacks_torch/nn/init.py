"""Weight initialisers with an explicit ``torch.Generator``.

Counterpart of ``optimalstrategiesagainstgenerativeattacks_tpu/nn/init.py``:
the same distributions (torch's defaults), drawn from a generator the caller
owns rather than the global RNG.

  * torch Conv2d / Linear default: weight and bias Uniform(+-1/sqrt(fan_in));
  * ``kaiming_normal(a=0.2)`` (the discriminator head): N(0, 2/((1+a^2) fan_in)),
    zero bias;
  * ``weights_init(init_type)``: the reference's ``weights_init`` choices
    ('gaussian', 'xavier', 'kaiming', 'orthogonal' with zero bias; 'default');
  * ``uniform_pm1_``: Uniform(-1, 1) (the ArcFace head before its renorm).

Each initialiser fills a weight (and its bias) in place: fan_in is the
weight's size over its first axis ([out, in] linear, [out, in, kh, kw] conv).
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


@torch.no_grad()
def gaussian_(weight: torch.Tensor, bias, generator: torch.Generator) -> None:
    """N(0, 0.02^2), zero bias."""
    weight.normal_(0.0, 0.02, generator=generator)
    if bias is not None:
        bias.zero_()


@torch.no_grad()
def xavier_normal_(weight: torch.Tensor, bias, generator: torch.Generator) -> None:
    """xavier_normal_ with gain sqrt(2): N(0, 4 / (fan_in + fan_out)), zero bias."""
    torch.nn.init.xavier_normal_(weight, gain=math.sqrt(2.0), generator=generator)
    if bias is not None:
        bias.zero_()


@torch.no_grad()
def orthogonal_(weight: torch.Tensor, bias, generator: torch.Generator) -> None:
    """A random orthogonal [out, fan_in] matrix scaled by sqrt(2), zero bias."""
    torch.nn.init.orthogonal_(weight, gain=math.sqrt(2.0), generator=generator)
    if bias is not None:
        bias.zero_()


_WEIGHTS_INIT = {"gaussian": gaussian_, "xavier": xavier_normal_, "kaiming": kaiming_normal_,
                 "orthogonal": orthogonal_, "default": torch_default_}


def weights_init(init_type: str = "kaiming"):
    """The in-place initialiser ``fn(weight, bias, generator)`` of the reference's
    ``weights_init(init_type)``."""
    if init_type not in _WEIGHTS_INIT:
        raise ValueError(f"Unsupported initialization: {init_type}")
    return _WEIGHTS_INIT[init_type]


@torch.no_grad()
def uniform_pm1_(weight: torch.Tensor, generator: torch.Generator | None) -> None:
    """Uniform(-1, 1)."""
    weight.uniform_(-1.0, 1.0, generator=generator)


def init_module(module: torch.nn.Module, generator: torch.Generator) -> None:
    """Initialise every submodule that defines ``reset_parameters(generator)``."""
    for m in module.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(generator)
