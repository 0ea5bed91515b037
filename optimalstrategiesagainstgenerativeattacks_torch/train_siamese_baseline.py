"""Train the Siamese baseline authenticator with the PyTorch port.

    python -m optimalstrategiesagainstgenerativeattacks_torch.train_siamese_baseline \\
        --dataset_root <ds> -o <outdir> [--device cuda|cpu] ...

The arguments and defaults of the JAX package's ``train_siamese_baseline.py``
(the reference ships no such script; its eval expects an externally trained
checkpoint), plus ``--device``: ``cuda`` (the default) needs a GPU.
Checkpoints go to ``<outdir>/ckpts/model_{step:08d}``, the arguments to
``<outdir>/args.json``; ``--num_workers`` threads decode the episodes.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-o", "--outdir", default="./siamese_outdir/")
    parser.add_argument("--dataset_root", required=True)
    parser.add_argument("--split", default="train")
    parser.add_argument("--dataset_type", default="omniglot",
                        help="omniglot | voxceleb2 | general_imgs")
    parser.add_argument("--img_size", type=int, default=32)
    parser.add_argument("--img_channels", type=int, default=1)
    parser.add_argument("--m", type=int, default=1)
    parser.add_argument("--n", type=int, default=5)
    parser.add_argument("--k", type=int, default=5)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--n_epochs", type=int, default=20)
    parser.add_argument("--example_cnt_per_class", type=int, default=20)
    parser.add_argument("--num_workers", type=int, default=0)
    parser.add_argument("--save_every", type=int, default=1000)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--mining", default="batch_hard", choices=["batch_hard", "random"],
                        help="pair recipe: batch-hard mining on the device (default) or the "
                             "random-pair recipe")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return parser


def main(argv: Optional[Sequence[str]] = None):
    args = build_parser().parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is false "
                         "(pass --device cpu to train on the CPU)")

    from optimalstrategiesagainstgenerativeattacks_torch.baselines.training import train_siamese
    from optimalstrategiesagainstgenerativeattacks_torch.eval.authentication import get_dataset

    ds = get_dataset(
        dataset_root=args.dataset_root, split=args.split, dataset_type=args.dataset_type,
        example_cnt_per_class=args.example_cnt_per_class,
        img_channels=args.img_channels, img_size=args.img_size,
        m=args.m, n=args.n, k=args.k, seed=args.seed,
    )
    print(f"Siamese episodic dataset: {ds.n_classes} classes, {len(ds)} episodes/epoch")
    return train_siamese(vars(args), ds, device=args.device)


if __name__ == "__main__":
    main()
