"""Train the multi-seed CLI's config in bf16 with chosen submodules in f32, and print
the authenticator's accuracy: a bisection of the bf16 game's faults.

    python scripts/torch_bf16_parts.py --dataset_root <omniglot-layout set>
        [--f32 im.env_decoder im.env_decoder.up_0 au.encoders ...]
        [--seed 2] [--n_steps 400] [--log_every 25] [--device cuda|cpu]

Each ``--f32`` path names a submodule of a player (``au.`` or ``im.`` and its
attribute path).  That submodule is built in f32 and its floating inputs are
cast to f32, so it computes without bf16 rounding on the values the bf16 game
hands it; parameters and initial values are those of the all-bf16 game, since
the players are initialised after the swap in the same module order.  With no
``--f32`` the game runs as ``train_multiseed_gim_on_imgs`` runs it, one seed
at its defaults.  The loop prints au_acc every ``--log_every`` steps; a game
whose authenticator holds 1.000 wins as the JAX package's does on the hard
glyph set, one that sits near 0.5 has been fooled.  Checkpoints go to a
temporary directory that is deleted at the end.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def with_f32_parts(build_models, paths):
    """``build_models`` whose players hold the named submodules in f32."""
    import torch

    def build(cfg):
        players = dict(zip(("au", "im"), build_models(cfg)))
        players32 = dict(zip(("au", "im"),
                             build_models(dataclasses.replace(cfg, compute_dtype="float32"))))
        for path in paths:
            first, *names = path.split(".")
            if first not in players or not names:
                raise SystemExit(f"--f32 {path}: expected au.<submodule> or im.<submodule>")
            parent, parent32 = players[first], players32[first]
            for name in names[:-1]:
                parent, parent32 = getattr(parent, name), getattr(parent32, name)
            sub = getattr(parent32, names[-1])
            forward = sub.forward

            def forward_f32(*args, _forward=forward, **kw):
                return _forward(*(a.float() if torch.is_tensor(a) and a.is_floating_point()
                                  else a for a in args), **kw)

            sub.forward = forward_f32
            setattr(parent, names[-1], sub)
        return players["au"], players["im"]

    return build


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset_root", required=True)
    ap.add_argument("--f32", nargs="*", default=[], help="submodules to run in f32")
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--n_steps", type=int, default=400)
    ap.add_argument("--log_every", type=int, default=25)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    from optimalstrategiesagainstgenerativeattacks_torch import train_multiseed_gim_on_imgs as cli
    from optimalstrategiesagainstgenerativeattacks_torch.train import multiseed

    multiseed.build_models = with_f32_parts(multiseed.build_models, args.f32)
    print(f"f32 parts: {args.f32 or 'none'}", flush=True)
    with tempfile.TemporaryDirectory() as out:
        cli.main(["--dataset_root", args.dataset_root, "-o", out, "--seeds", str(args.seed),
                  "--n_steps", str(args.n_steps), "--save_every", str(args.n_steps),
                  "--log_every", str(args.log_every), "--device", args.device])


if __name__ == "__main__":
    main()
