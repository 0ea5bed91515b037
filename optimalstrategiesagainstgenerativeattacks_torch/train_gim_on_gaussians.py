"""Train GIM on the synthetic Gaussian game with the PyTorch port.

    python -m optimalstrategiesagainstgenerativeattacks_torch.train_gim_on_gaussians \\
        -o <outdir> [--device cuda|cpu] ...

The arguments and defaults of the reference's ``train_gim_on_gaussians.py``
(the JAX package's CLI), plus ``--device``: ``cuda`` (the default) needs a
GPU, ``cpu`` runs on the CPU.  The README's Nash check is ``--src_dim 10 --n 5
--k 10 --au_hidden_scale 8`` (closed-form value 0.9211 from
``theory.game_value``).  The arguments are written to ``<outdir>/args.json``;
checkpoints go to ``<outdir>/ckpts/model_{step:08d}``, and ``-r`` resumes from
one.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-o", "--outdir", default="./gim_gaussians_outdir/",
                        help="Output directory for the experiment")
    parser.add_argument("--ckpt_dir_name", default="ckpts",
                        help="accepted as the reference's CLI accepts it; checkpoints go to "
                             "<outdir>/ckpts, as in the JAX package")
    parser.add_argument("-r", "--resume_from_ckpt", default=None,
                        help="Path to a checkpoint from which to resume training")
    parser.add_argument("--pretrained", default=None,
                        help="Path to pretrained checkpoint to use for model initialization")
    parser.add_argument("--n_iters", type=int, default=500000,
                        help="Number of training iterations.")
    parser.add_argument("--batch_size", type=int, default=4096)
    parser.add_argument("--m", type=int, default=1, help="m: The number of leaked observations")
    parser.add_argument("--n", type=int, default=10, help="n: The number of test observations")
    parser.add_argument("--k", type=int, default=10,
                        help="k: The number of registration observations")
    parser.add_argument("--prior_sigma", type=float, default=10.0,
                        help="The standard deviation of Q, the prior distribution over sources.")
    parser.add_argument("--src_sigma", type=float, default=1.0,
                        help="The known standard deviation of the sources' diagonal covariance.")
    parser.add_argument("--src_dim", type=int, default=1,
                        help="The dimension of source observations")
    parser.add_argument("--au_lr", type=float, default=1e-4,
                        help="Learning rate for the authenticator")
    parser.add_argument("--im_lr", type=float, default=1e-4,
                        help="Learning rate for the attacker (impersonator)")
    parser.add_argument("--reg_param", type=float, default=0.0,
                        help="GAN regularization coefficient. Must be set to 0")
    parser.add_argument("--remove_noise_mean", type=lambda x: bool(int(x)), default=True)
    parser.add_argument("--save_every", type=int, default=100000)
    parser.add_argument("--eval_every", type=int, default=1000)
    parser.add_argument("--save_stats_every", type=int, default=100)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--log_every", type=int, default=100,
                        help="steps between the host's reads of the metrics")
    parser.add_argument("--au_stat", default="mean_std", choices=["mean_std", "mean_std_fc"],
                        help="Authenticator pooling stat; 'mean_std_fc' adds a learned "
                             "per-element feature")
    parser.add_argument("--au_hidden_scale", type=int, default=1,
                        help="Width multiplier for the discriminator head MLP")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda runs on the GPU; cpu on the CPU")
    return parser


def main(argv: Optional[Sequence[str]] = None):
    args = build_parser().parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is false "
                         "(pass --device cpu to run on the CPU)")

    from optimalstrategiesagainstgenerativeattacks_torch.train.gaussian import train_gim_gaussian
    from optimalstrategiesagainstgenerativeattacks_torch.utils.config import (
        GaussianGameConfig,
        save_args,
    )

    save_args(args, args.outdir)
    return train_gim_gaussian(GaussianGameConfig.from_dict(vars(args)), device=args.device)


if __name__ == "__main__":
    main()
