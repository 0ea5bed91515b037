"""Train several seeds of the image GIM game together with the PyTorch port.

    python -m optimalstrategiesagainstgenerativeattacks_torch.train_multiseed_gim_on_imgs \\
        --dataset_root <ds> -o <outdir> --seeds 2 3 4 [--device cuda|cpu] ...

The arguments and defaults of the JAX package's
``train_multiseed_gim_on_imgs.py``, plus ``--device``: ``cuda`` (the
default) needs a GPU, ``cpu`` runs the kernels' plain versions.  The
defaults are the small config of the head-to-head studies (img 16, style
64, B16, m1 n5 k5).  Each seed writes an ordinary experiment directory
``<outdir>/seed_<s>/`` (``args.json`` and ``ckpts/model_{step:08d}``, named
by the count of steps taken), which the eval CLI
(``eval_gim_on_authentication``) reads as it reads a single-seed run.
``--au_lrs`` / ``--im_lrs`` give each seed its own constant learning rate.
The dataset must have the same image count in every class: it is staged on
the device once and every seed samples from that copy.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-o", "--outdir", required=True)
    parser.add_argument("--dataset_root", required=True)
    parser.add_argument("--dataset_type", default="omniglot", help="omniglot or voxceleb2")
    parser.add_argument("--seeds", type=int, nargs="+", required=True,
                        help="one independent game per seed, trained together")
    parser.add_argument("--au_lrs", type=float, nargs="+", default=None,
                        help="optional per-seed authenticator LRs (len == len(seeds))")
    parser.add_argument("--im_lrs", type=float, nargs="+", default=None,
                        help="optional per-seed impersonator LRs (len == len(seeds))")
    parser.add_argument("--n_steps", type=int, default=2000)
    parser.add_argument("--save_every", type=int, default=400)
    parser.add_argument("--log_every", type=int, default=50)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--ds_n_examples_per_cls", type=int, default=100)
    parser.add_argument("--m", type=int, default=1)
    parser.add_argument("--n", type=int, default=5)
    parser.add_argument("--k", type=int, default=5)
    parser.add_argument("--img_channels", type=int, default=1)
    parser.add_argument("--img_size", type=int, default=16)
    parser.add_argument("--style_dim", type=int, default=64)
    parser.add_argument("--num_env_noise_layers", type=int, default=4)
    parser.add_argument("--au_lr", type=float, default=1e-4)
    parser.add_argument("--im_lr", type=float, default=1e-4)
    parser.add_argument("--env_noise_mapping_lr", type=float, default=1e-6)
    parser.add_argument("--reg_param", type=float, default=0.0)
    parser.add_argument("--n_au_steps", type=int, default=1)
    parser.add_argument("--compute_dtype", default="bfloat16")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda runs the hand-written kernels on the GPU; cpu runs "
                             "their plain versions")
    return parser


def make_train_dataset(cfg):
    """The train split of ``cfg.dataset_type`` (the JAX CLI's choice of reader)."""
    from optimalstrategiesagainstgenerativeattacks_torch.data.episodic import (
        ImgGIMDataSet,
        OmniglotGIMDataSet,
    )

    common = dict(root=cfg.dataset_root, split="train", img_channels=cfg.img_channels,
                  img_size=cfg.img_size, m=cfg.m, n=cfg.n, si=cfg.k,
                  example_cnt_per_class=cfg.ds_n_examples_per_cls, seed=cfg.seed)
    if cfg.dataset_type == "omniglot":
        return OmniglotGIMDataSet(**common)
    return ImgGIMDataSet(hierarchical=True, mirror=True, **common)


def main(argv: Optional[Sequence[str]] = None):
    args = build_parser().parse_args(argv)
    for name in ("au_lrs", "im_lrs"):
        lrs = getattr(args, name)
        if lrs is not None and len(lrs) != len(args.seeds):
            raise SystemExit(f"--{name} must list one LR per seed")
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is false "
                         "(pass --device cpu to run the plain versions on the CPU)")

    from optimalstrategiesagainstgenerativeattacks_torch.train.multiseed import (
        train_multiseed_gim_imgs,
    )
    from optimalstrategiesagainstgenerativeattacks_torch.utils.config import ImageGameConfig

    cfg = ImageGameConfig.from_dict(vars(args))
    ms, _ = train_multiseed_gim_imgs(
        cfg, args.seeds, make_train_dataset(cfg), args.outdir, args.n_steps,
        save_every=args.save_every, log_every=args.log_every, au_lrs=args.au_lrs,
        im_lrs=args.im_lrs, args=vars(args), device=args.device)
    return ms


if __name__ == "__main__":
    main()
