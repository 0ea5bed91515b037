"""Generators seeded from tuples of indices.

A draw that depends only on its indices (a seed, a step, a batch, an
episode) is the property the JAX package gets from its ``fold_in`` chains
of a fixed key: a resumed run, or an epoch taken again, draws what an
uninterrupted run draws.  The bits differ from JAX's.
"""

from __future__ import annotations

import numpy as np
import torch


def noise_generator(device, *key: int) -> torch.Generator:
    """A fresh generator on ``device`` seeded from the non-negative integers ``key``."""
    seed = int(np.random.SeedSequence(list(key)).generate_state(1, np.uint64)[0]) >> 1
    return torch.Generator(device=device).manual_seed(seed)
