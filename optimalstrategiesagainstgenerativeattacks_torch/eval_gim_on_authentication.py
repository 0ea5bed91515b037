"""Evaluate GIM (and a baseline) authenticators against the GIM, replay and
random-source attackers with the PyTorch port, and write the results CSV.

    python -m optimalstrategiesagainstgenerativeattacks_torch.eval_gim_on_authentication \\
        --ds_root <ds> --gim_exp_dir <outdir> [--baseline_type siamese|arcface
        --baseline_exp_dir <dir>] [--device cuda|cpu] ...

The arguments and defaults of the JAX package's eval CLI, plus ``--device``:
``cuda`` (the default) needs a GPU, ``cpu`` runs the kernels' plain
versions; the CSV goes to ``--csv_file_path`` (default ``results.csv`` in
the working directory).  ``--num_workers`` threads decode the episodes.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ds_root", required=True, help="Path to dataset root dir.")
    parser.add_argument("--split", default="val", help="train, val, or test")
    parser.add_argument("--dataset_type", default="omniglot", help="omniglot or voxceleb2")
    parser.add_argument("--example_cnt_per_class", type=int, default=5,
                        help="How many examples to sample per class for the evaluation")
    parser.add_argument("--img_size", type=int, default=32, help="image size")
    parser.add_argument("--img_channels", type=int, default=1, help="number of image channels")
    parser.add_argument("--m", type=int, default=1, help="m: the number of leaked images")
    parser.add_argument("--n", type=int, default=5, help="n: the number of test images")
    parser.add_argument("--k", type=int, default=5, help="k: the number of registration images")
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--baseline_exp_dir", default=None,
                        help="experiment directory for the baseline model")
    parser.add_argument("--baseline_type", default=None, help="siamese, arcface, or None")
    parser.add_argument("--gim_exp_dir", required=True,
                        help="experiment directory for the GIM model")
    parser.add_argument("--specific_model", default=None,
                        help="Specific checkpoint name. If not given, the latest model is taken.")
    parser.add_argument("--csv_file_path", default="results.csv",
                        help="The path for the results csv file")
    parser.add_argument("--calibrate_q", type=float, default=None,
                        help="Append calibrated-threshold columns: the operating point "
                             "accepting this fraction of real scores (deployable, "
                             "attacker-blind), plus score-distribution stats and the oracle "
                             "balanced-accuracy point. E.g. 0.95.")
    parser.add_argument("--dump_scores_dir", default=None,
                        help="Write raw real/fake score vectors per pairing as npz files "
                             "into this directory (score-distribution analysis).")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda runs the hand-written kernels on the GPU; cpu runs "
                             "their plain versions")
    return parser


def main(argv: Optional[Sequence[str]] = None):
    args = build_parser().parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is false "
                         "(pass --device cpu to run the plain versions on the CPU)")

    from optimalstrategiesagainstgenerativeattacks_torch.eval.authentication import (
        eval_authentication_task,
        get_dataset,
    )

    ds = get_dataset(
        dataset_root=args.ds_root, split=args.split, dataset_type=args.dataset_type,
        example_cnt_per_class=args.example_cnt_per_class,
        img_channels=args.img_channels, img_size=args.img_size,
        m=args.m, n=args.n, k=args.k,
    )
    return eval_authentication_task(
        ds=ds, m=args.m, n=args.n, k=args.k,
        batch_size=args.batch_size, num_workers=args.num_workers,
        baseline_exp_dir=args.baseline_exp_dir, baseline_type=args.baseline_type,
        gim_exp_dir=args.gim_exp_dir, csv_file_path=args.csv_file_path,
        specific_model=args.specific_model, calibrate_q=args.calibrate_q,
        dump_scores_dir=args.dump_scores_dir, device=args.device,
    )


if __name__ == "__main__":
    main()
