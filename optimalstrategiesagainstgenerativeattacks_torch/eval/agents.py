"""Evaluation agents: authenticator/impersonator wrappers and the naive attackers.

Counterpart of ``optimalstrategiesagainstgenerativeattacks_tpu/eval/agents.py``
(parity with the reference's ``authentication_eval/agents.py``): an
``Authenticator`` wraps a score function and a threshold (default 0); an
``Impersonator`` wraps a generation function; the two baseline attackers are
the replay attacker (repeat a random leaked image n times, :46-50) and the
random-source attacker (the real sample of a random dataset item, :53-62).
Both draw from a ``numpy.random.Generator`` with the JAX package's draws in
the same order.

Samples are ``[B, S, H, W, C]`` in [-1, 1]: torch tensors on the eval's
device, or numpy arrays.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


class Authenticator:
    """Score-function agent: act -> (score, pred = score >= th) on the host."""

    def __init__(self, au_model_func: Callable, th: float = 0.0):
        self.au_model_func = au_model_func
        self.th = th

    def act(self, test_sample, si_sample):
        out = self.au_model_func(test_sample=test_sample, si_sample=si_sample)
        out = torch.as_tensor(out).float().cpu().numpy()
        pred = (out >= self.th).astype(np.int64)
        return out, pred


class Impersonator:
    """Generation-function agent: act(leaked, n) -> fake sample."""

    def __init__(self, im_model_func: Callable):
        self.im_model_func = im_model_func

    def act(self, leaked_sample, n: int):
        return self.im_model_func(leaked_sample=leaked_sample, n=n)


def replay_impersonator(leaked_sample, n: int, rng: Optional[np.random.Generator] = None):
    """Repeat one random leaked image n times per batch element (on the sample's device)."""
    rng = rng or np.random.default_rng()
    m = leaked_sample.shape[1]
    picks = [int(rng.integers(m)) for _ in range(n)]
    return leaked_sample[:, picks]


def rand_source_impersonator(
    leaked_sample, n: int, gim_ds, rng: Optional[np.random.Generator] = None,
    normalize: bool = True,
):
    """Real sample of a random dataset item per batch element (numpy, on the host).

    ``gim_ds`` episodes are uint8; with ``normalize`` the result is shifted
    to [-1, 1] to match model space.
    """
    rng = rng or np.random.default_rng()
    batch_size = leaked_sample.shape[0]
    fakes = []
    for _ in range(batch_size):
        idx = int(rng.integers(len(gim_ds)))
        real = gim_ds[idx]["real_sample"].astype(np.float32)
        if normalize:
            real = real / 127.5 - 1.0
        fakes.append(real)
    fake = np.stack(fakes, axis=0)
    assert fake.shape[1] == n
    return fake
