"""Train GIM on images (Omniglot / VoxCeleb2) with the PyTorch port.

    python -m optimalstrategiesagainstgenerativeattacks_torch.train_gim_on_imgs \\
        --dataset_root <ds> -o <outdir> [--device cuda|cpu] ...

The arguments and defaults of the reference's ``train_gim_on_imgs.py``
(the JAX package's CLI without its TPU-only flags), plus ``--device``:
``cuda`` (the default) needs a GPU, ``cpu`` runs the kernels' plain
versions; and ``--cudnn_benchmark 1``: cuDNN times its conv algorithms
(faster, not bit-reproducible).  Omniglot paper hparams are the defaults; for VoxCeleb2 use
``--dataset_type voxceleb2 --img_size 64 --img_channels 3 --au_lr 1e-4
--im_lr 1e-4 --env_noise_mapping_lr 1e-6 --reg_param 10``.  The arguments
are written to ``<outdir>/args.json``; checkpoints go to
``<outdir>/<ckpt_dir_name>/model_{step:08d}``, and ``-r`` resumes from one.

Data parallel over every visible card by default, as the JAX CLI's mesh: with
``--device cuda`` and k > 1 visible cards the CLI starts k workers of itself,
one a card, with gradients all-reduced over NCCL (``parallel/mesh.py``);
under ``torchrun`` (``python -m torch.distributed.run --nproc_per_node k -m
optimalstrategiesagainstgenerativeattacks_torch.train_gim_on_imgs ...``) it
joins the launcher's group, on the CPU over gloo with ``--device cpu``.  The
batch sizes are rounded down to a multiple of the world size, rank 0 writes
everything, and ``--device_data on`` is refused.  With one card, or with
``--device cpu`` and no launcher, it runs in one process.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-o", "--outdir", default="./gim_imgs_outdir/",
                        help="Output directory for the experiment")
    parser.add_argument("--dataset_root", required=True, help="Path to dataset root dir")
    parser.add_argument("--dataset_type", default="omniglot",
                        help="Options are omniglot or voxceleb2")
    parser.add_argument("--ckpt_dir_name", default="ckpts")
    parser.add_argument("-r", "--resume_from_ckpt", default=None,
                        help="Path to a checkpoint from which to resume training")
    parser.add_argument("--pretrained", default=None,
                        help="Path to pretrained checkpoint to use for model initialization")
    parser.add_argument("--n_epochs", type=int, default=100000, help="Number of training epochs")
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--ds_n_examples_per_cls", type=int, default=100,
                        help="Number of examples per class in an epoch")
    parser.add_argument("--m", type=int, default=1, help="m: The number of leaked images")
    parser.add_argument("--n", type=int, default=5, help="n: The number of test images")
    parser.add_argument("--k", type=int, default=5, help="k: The number of registration images")
    parser.add_argument("--img_channels", type=int, default=1,
                        help="Number of image channels. 1 for omniglot, 3 for voxceleb2")
    parser.add_argument("--img_size", type=int, default=32,
                        help="Image size. 32 for omniglot, 64 for voxceleb2")
    parser.add_argument("--style_dim", type=int, default=512)
    parser.add_argument("--num_env_noise_layers", type=int, default=4)
    parser.add_argument("--au_lr", type=float, default=1e-6,
                        help="Learning rate for the authenticator. Use 1e-6 for omniglot and "
                             "1e-4 for voxceleb2")
    parser.add_argument("--im_lr", type=float, default=1e-5,
                        help="Learning rate for the attacker (or impersonator). Use 1e-5 for "
                             "omniglot, 1e-4 for voxceleb2")
    parser.add_argument("--beta1", type=float, default=0.0, help="beta1 for the Adam optimizer")
    parser.add_argument("--beta2", type=float, default=0.99, help="beta2 for the Adam optimizer")
    parser.add_argument("--env_noise_mapping_lr", type=float, default=1e-7,
                        help="Learning rate for the noise mapping module. Use 1e-7 for "
                             "omniglot, 1e-6 for voxceleb2")
    parser.add_argument("--lr_gamma", type=float, default=0.3)
    parser.add_argument("--milestones", type=int, nargs="+", default=[])
    parser.add_argument("--reg_param", type=float, default=0.0,
                        help="GAN regularization coefficient. Use 0. for omniglot, 10. for "
                             "voxceleb2")
    parser.add_argument("--remove_noise_mean", type=lambda x: bool(int(x)), default=True)
    parser.add_argument("--use_img_att", type=lambda x: bool(int(x)), default=False)
    parser.add_argument("--save_every", type=int, default=10000)
    parser.add_argument("--eval_every", type=int, default=500)
    parser.add_argument("--save_imgs_every", type=int, default=500)
    parser.add_argument("--n_au_steps", type=int, default=1)
    parser.add_argument("-dbg", action="store_true")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--log_every", type=int, default=100,
                        help="scalar flush cadence (the reference's tb_log_every)")
    parser.add_argument("--log_enc_every", type=int, default=500,
                        help="encoder-diagnostic cadence (the reference's tb_log_enc_every)")
    parser.add_argument("--compute_dtype", default="bfloat16", help="bfloat16 or float32")
    parser.add_argument("--device_data", default="auto", choices=["auto", "on", "off"],
                        help="stage the whole dataset on the device and sample episodes "
                             "there (no image bytes cross to the device per step); 'auto' "
                             "uses it when every class has the same image count")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda runs the hand-written kernels on the GPU; cpu runs "
                             "their plain versions")
    parser.add_argument("--cudnn_benchmark", type=lambda x: bool(int(x)), default=False,
                        help="1: cuDNN picks each conv's algorithm by timing it (faster; "
                             "the run is then not bit-reproducible)")
    return parser


def make_datasets(cfg):
    """(train, val) episodic datasets of ``cfg.dataset_type`` under ``cfg.dataset_root``."""
    from optimalstrategiesagainstgenerativeattacks_torch.data.episodic import (
        ImgGIMDataSet,
        OmniglotGIMDataSet,
    )

    common = dict(root=cfg.dataset_root, img_channels=cfg.img_channels, img_size=cfg.img_size,
                  m=cfg.m, n=cfg.n, si=cfg.k)
    if cfg.dataset_type == "omniglot":
        return (OmniglotGIMDataSet(split="train", example_cnt_per_class=cfg.ds_n_examples_per_cls,
                                   seed=cfg.seed, **common),
                OmniglotGIMDataSet(split="val", example_cnt_per_class=1, seed=cfg.seed + 1,
                                   **common))
    if cfg.dataset_type == "voxceleb2":
        return (ImgGIMDataSet(split="train", example_cnt_per_class=cfg.ds_n_examples_per_cls,
                              hierarchical=True, mirror=True, seed=cfg.seed, **common),
                ImgGIMDataSet(split="val", example_cnt_per_class=1, hierarchical=True,
                              mirror=True, seed=cfg.seed + 1, **common))
    raise ValueError("Supports only dataset_type in ['omniglot','voxceleb2']")


def main(argv: Optional[Sequence[str]] = None):
    """Train; returns the state (None in the process that started one worker a card)."""
    args = build_parser().parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is false "
                         "(pass --device cpu to run the plain versions on the CPU)")

    from optimalstrategiesagainstgenerativeattacks_torch.parallel import mesh

    if mesh.spawn_workers(__spec__.name, argv, args.device):
        return None

    from optimalstrategiesagainstgenerativeattacks_torch.train.image import train_gim_imgs
    from optimalstrategiesagainstgenerativeattacks_torch.utils.config import (
        ImageGameConfig,
        save_args,
    )

    with mesh.process_group(args.device) as device:
        if mesh.is_main():
            save_args(args, args.outdir)
        cfg = ImageGameConfig.from_dict(vars(args))
        train_ds, val_ds = make_datasets(cfg)
        return train_gim_imgs(cfg, train_ds, val_ds, device=device,
                              cudnn_benchmark=args.cudnn_benchmark)


if __name__ == "__main__":
    main()
