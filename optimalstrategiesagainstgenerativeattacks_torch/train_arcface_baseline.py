"""Train the ArcFace baseline authenticator with the PyTorch port.

    python -m optimalstrategiesagainstgenerativeattacks_torch.train_arcface_baseline \\
        --dataset_root <ds> -o <outdir> [--device cuda|cpu] ...

The arguments and defaults of the JAX package's ``train_arcface_baseline.py``
(the reference ships no such script; its eval expects an externally trained
checkpoint), plus ``--device``: ``cuda`` (the default) needs a GPU.
Checkpoints go to ``<outdir>/ckpts/model_{step:08d}``, the arguments to
``<outdir>/args.json``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-o", "--outdir", default="./arcface_outdir/")
    parser.add_argument("--dataset_root", required=True)
    parser.add_argument("--split", default="train")
    parser.add_argument("--img_size", type=int, default=32, help="32 or 64")
    parser.add_argument("--img_channels", type=int, default=1)
    parser.add_argument("--num_layers", type=int, default=50, help="50, 100, or 152")
    parser.add_argument("--dropout", type=float, default=0.6)
    parser.add_argument("--emb_dim", type=int, default=512)
    parser.add_argument("--th", type=float, default=1.5,
                        help="verification threshold on -||e1-e2||^2")
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--n_epochs", type=int, default=20)
    parser.add_argument("--example_cnt_per_class", type=int, default=100)
    parser.add_argument("--img_suffix", default=".jpg")
    parser.add_argument("--save_every", type=int, default=1000)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return parser


def main(argv: Optional[Sequence[str]] = None):
    args = build_parser().parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is false "
                         "(pass --device cpu to train on the CPU)")

    from optimalstrategiesagainstgenerativeattacks_torch.baselines.training import train_arcface
    from optimalstrategiesagainstgenerativeattacks_torch.data.episodic import ArcfaceDataSet

    ds = ArcfaceDataSet(
        root=args.dataset_root, split=args.split, img_channels=args.img_channels,
        img_size=args.img_size, example_cnt_per_class=args.example_cnt_per_class,
        img_suffix=args.img_suffix, seed=args.seed,
    )
    print(f"ArcFace dataset: {ds.n_classes} classes, {len(ds)} examples/epoch")
    return train_arcface(vars(args), ds, device=args.device)


if __name__ == "__main__":
    main()
