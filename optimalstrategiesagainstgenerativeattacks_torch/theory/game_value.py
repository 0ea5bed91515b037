"""Closed-form Nash game values for the GIM authentication game.

The value of the authentication game between an optimal authenticator and an
optimal generative attacker has a closed form in terms of the regularised
lower incomplete gamma function (ICLR 2020, "Optimal Strategies Against
Generative Attacks", Theorems 1-3).  Capability parity with the reference
``theory/theoretic_game_value.py:10-59``; pure numpy/scipy, no accelerator
involvement.  A copy of ``optimalstrategiesagainstgenerativeattacks_tpu/theory/
game_value.py``, kept in the port so that it needs nothing of the JAX package:

    python -m optimalstrategiesagainstgenerativeattacks_torch.theory.game_value -m 1 -n 5 -k 10 -d 10

Conventions:
  m: number of leaked observations available to the attacker.
  n: number of test observations presented to the authenticator.
  k: number of registration ("source info") observations.
  d: dimension of each observation.
  rho: noise-to-prior variance ratio; delta = m/n style asymptotic ratio.
"""

from __future__ import annotations

import numpy as np
from scipy.special import gammainc


def game_value_mnk(m: int, n: int, d: int, k: int) -> float:
    """Nash value V(m, n, k, d) of the finite-sample authentication game.

    Returns 0.5 (attacker wins / indistinguishable) when n <= m.
    """
    if n > m:
        log_val = np.log((n * (m + k)) / (m * (n + k)))
        denominator = 2 * k * (n - m)
        x1 = (n * d * (m + k) * log_val) / denominator
        x2 = (m * d * (n + k) * log_val) / denominator
        v = 0.5 + 0.5 * (gammainc(d / 2, x1) - gammainc(d / 2, x2))
    else:
        v = 0.5
    return float(v)


def game_value_as_func_of_n(m: int, n_max: int, d: int, k: int):
    """V(m, n, k, d) for n = 1..n_max. Returns (n_array, values)."""
    v = np.zeros((n_max,))
    n_array = np.arange(1, n_max + 1)
    for n in n_array:
        v[n - 1] = game_value_mnk(m, n, d, k)
    return n_array, v


def game_value_rho_delta(d: int, rho: float, delta: float) -> float:
    """Asymptotic Nash value V(rho, delta, d). Returns 0.5 when delta >= 1."""
    if delta < 1:
        log_val = np.log((1.0 + rho) / (delta + rho))
        denominator = 2 * (1 - delta)
        x1 = d * (1 + rho) * log_val / denominator
        x2 = d * (delta + rho) * log_val / denominator
        v = 0.5 + 0.5 * (gammainc(d / 2, x1) - gammainc(d / 2, x2))
    else:
        v = 0.5
    return float(v)


def ml_attacker_game_value_rho_delta(d: int, rho: float, delta: float) -> float:
    """Game value against the maximum-likelihood (plug-in) attacker."""
    log_val = np.log((1.0 + rho + delta) / (delta + rho))
    denominator = 2.0
    x1 = d * (1 + rho + delta) * log_val / denominator
    x2 = d * (delta + rho) * log_val / denominator
    v = 0.5 + 0.5 * (gammainc(d / 2, x1) - gammainc(d / 2, x2))
    return float(v)


def game_value_diff_ml_vs_opt_rho_delta(d: int, rho: float, delta: float) -> float:
    """Advantage of facing the ML attacker over the optimal attacker."""
    return ml_attacker_game_value_rho_delta(d, rho, delta) - game_value_rho_delta(
        d, rho, delta
    )


def get_args(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-m", type=int, default=1, help="number of leaked observations")
    parser.add_argument("-n", type=int, default=5, help="number of test observations")
    parser.add_argument("-k", type=int, default=10, help="number of registration observations")
    parser.add_argument("-d", type=int, default=100, help="observation dimension")
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    print(game_value_mnk(m=args.m, n=args.n, k=args.k, d=args.d))


if __name__ == "__main__":
    main()
