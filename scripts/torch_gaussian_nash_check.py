"""The Gaussian game's Nash check on the port: train, then hold the authenticator's
accuracy beside the closed-form game value.

    python scripts/torch_gaussian_nash_check.py [--n_iters 100000] [--seed 1]
        [--device cuda|cpu] [--window 5000]

Runs ``train_gim_gaussian`` at the README's Nash-check config (d=10, m1 n5 k10,
head x8, B=4096, lr 1e-4, reg 0) with its scalars kept in memory and no
checkpoint but the last (written under ``build/nash_check/`` and deleted),
then prints the mean ``au_acc`` over consecutive windows of ``--window`` steps,
the last window's beside ``game_value_mnk(1, 5, 10, 10)``, and the run's
steps/s on the host clock (logging included).  A record, not a test: the
accuracy reached depends on the seed.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from optimalstrategiesagainstgenerativeattacks_torch.theory import game_value_mnk  # noqa: E402
from optimalstrategiesagainstgenerativeattacks_torch.train.gaussian import (  # noqa: E402
    train_gim_gaussian,
)
from optimalstrategiesagainstgenerativeattacks_torch.utils.config import (  # noqa: E402
    GaussianGameConfig,
)


class _Scalars:
    """The loop's logger, scalars only, kept in memory."""

    def __init__(self):
        self.stats = {}

    def add_scalar(self, category, k, v, global_step):
        self.stats.setdefault(category, {}).setdefault(k, []).append((global_step, v))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n_iters", type=int, default=100_000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--window", type=int, default=5000)
    args = ap.parse_args()
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            sys.exit("--device cuda: torch.cuda.is_available() is false")
    outdir = str(REPO / "build" / "nash_check")
    shutil.rmtree(outdir, ignore_errors=True)
    cfg = GaussianGameConfig(src_dim=10, m=1, n=5, k=10, au_hidden_scale=8, batch_size=4096,
                             n_iters=args.n_iters, save_every=10 ** 9, seed=args.seed,
                             outdir=outdir)
    logger = _Scalars()
    t0 = time.perf_counter()
    train_gim_gaussian(cfg, logger=logger, progress=False, device=args.device)
    seconds = time.perf_counter() - t0
    acc = np.array([v for _, v in logger.stats["train_accuracy"]["au_acc"]])
    value = game_value_mnk(m=cfg.m, n=cfg.n, d=cfg.src_dim, k=cfg.k)
    print(f"config: d={cfg.src_dim} m={cfg.m} n={cfg.n} k={cfg.k} B={cfg.batch_size} head "
          f"x{cfg.au_hidden_scale} lr {cfg.au_lr}/{cfg.im_lr} seed {cfg.seed} on {args.device}")
    for i in range(0, len(acc), args.window):
        last = min(i + args.window, len(acc)) - 1
        print(f"  steps {i}-{last}: au_acc {acc[i:i + args.window].mean():.4f}")
    print(f"last {args.window} steps: au_acc {acc[-args.window:].mean():.4f}; closed-form Nash "
          f"value {value:.4f}; {len(acc)} steps in {seconds:.1f} s = {len(acc) / seconds:.1f} "
          f"steps/s (logging and the state build included)")
    if args.device == "cuda":
        import subprocess

        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip())
    shutil.rmtree(outdir, ignore_errors=True)


if __name__ == "__main__":
    main()
