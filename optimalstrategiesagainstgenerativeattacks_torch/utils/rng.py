"""Generators seeded from tuples of indices, and the normal draw of the JAX package.

A draw that depends only on its indices (a seed, a step, a batch, an
episode) is the property the JAX package gets from its ``fold_in`` chains
of a fixed key: a resumed run, or an epoch taken again, draws what an
uninterrupted run draws.  The bits differ from JAX's; the distribution of a
``normal`` draw in each dtype is ``jax.random.normal``'s in that dtype.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

# jax.random.uniform randomises the mantissa bits of its dtype: 7 in bf16
BF16_LEVELS = 128
SQRT2_BF16 = float(torch.tensor(math.sqrt(2.0), dtype=torch.bfloat16))


def noise_generator(device, *key: int) -> torch.Generator:
    """A fresh generator on ``device`` seeded from the non-negative integers ``key``."""
    seed = int(np.random.SeedSequence(list(key)).generate_state(1, np.uint64)[0]) >> 1
    return torch.Generator(device=device).manual_seed(seed)


def normal(shape: Sequence[int], generator: Optional[torch.Generator], device,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Standard normal draws of ``shape`` in ``dtype``, distributed as
    ``jax.random.normal``'s in that dtype.  That one is sqrt(2) * erfinv(u) with u
    from ``jax.random.uniform``, whose bits are the dtype's mantissa bits: in bf16 u
    takes the 128 values (4 r - 255) / 256, r = 0 .. 127, and erfinv and the product
    are each rounded to bf16, so z takes 128 values from -2.890625 to 2.515625 (mean
    -0.0120), each with probability 1/128.  The bf16 draw here picks r and computes
    those values the same way; other dtypes draw ``torch.randn``."""
    if dtype != torch.bfloat16:
        return torch.randn(tuple(shape), generator=generator, device=device, dtype=dtype)
    r = torch.randint(0, BF16_LEVELS, tuple(shape), generator=generator, device=device)
    u = (4.0 * r.float() - (2 * BF16_LEVELS - 1)) / (2 * BF16_LEVELS)
    return torch.special.erfinv(u).to(torch.bfloat16) * SQRT2_BF16
