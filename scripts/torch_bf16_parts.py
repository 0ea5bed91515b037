"""Train the multi-seed CLI's config in bf16 with chosen submodules in f32, or with
chosen f32 sites rounded, and print the authenticator's accuracy: a bisection of
the bf16 game's faults.

    python scripts/torch_bf16_parts.py --dataset_root <omniglot-layout set>
        [--f32 im.env_decoder im.env_decoder.up_0 au.encoders ...]
        [--round down_sums up_sums conv_bias]
        [--seed 2] [--n_steps 400] [--log_every 25] [--device cuda|cpu]

Each ``--f32`` path names a submodule of a player (``au.`` or ``im.`` and its
attribute path).  That submodule is built in f32 and its floating inputs are
cast to f32, so it computes without bf16 rounding on the values the bf16 game
hands it; parameters and initial values are those of the all-bf16 game, since
the players are initialised after the swap in the same module order.  With no
``--f32`` the game runs as ``train_multiseed_gim_on_imgs`` runs it, one seed
at its defaults.  Each ``--round`` group puts one kind of site where the port
keeps a bf16 value in f32, as XLA's compile of the JAX step does, back to the
compute dtype (``ROUND_GROUPS``); all three give the port's rounding from
before it matched XLA's sites.  The loop prints au_acc every ``--log_every``
steps; a game whose authenticator holds 1.000 wins as the JAX package's does
on the hard glyph set, one that sits near 0.5 has been fooled.  Checkpoints go to a
temporary directory that is deleted at the end.
"""

from __future__ import annotations

import argparse
import contextlib
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


ROUND_GROUPS = {
    "down_sums": "ResBlockDown's sum (the img2img norms', the encoders' attention's input)",
    "up_sums": "AdaResBlockUp2's sum (the next block's AdaIN, the attention's input)",
    "conv_bias": "a conv's bias add read by a norm (SNConv's f32_out)",
}


@contextlib.contextmanager
def rounded_sites(groups):
    """The port's blocks with the f32 sites of ``groups`` rounded to the compute dtype,
    for models built inside the context."""
    from optimalstrategiesagainstgenerativeattacks_torch.nn import blocks

    saved = [(blocks.SNConv, "__init__", blocks.SNConv.__init__)]
    saved += [(cls, "forward", cls.forward) for cls in (blocks.ResBlockDown,
                                                        blocks.AdaResBlockUp2)]

    def rounding(forward):
        def run(self, *args, **kw):
            out = forward(self, *args, **kw)
            return out if self.conv_l1.dtype is None else out.to(self.conv_l1.dtype)
        return run

    def init_rounding(self, *args, _init=blocks.SNConv.__init__, **kw):
        _init(self, *args, **kw)
        self.f32_out = False

    try:
        if "conv_bias" in groups:
            blocks.SNConv.__init__ = init_rounding
        for cls, group in ((blocks.ResBlockDown, "down_sums"),
                           (blocks.AdaResBlockUp2, "up_sums")):
            if group in groups:
                cls.forward = rounding(cls.forward)
        yield
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset_root", required=True)
    ap.add_argument("--f32", nargs="*", default=[], help="submodules to run in f32")
    ap.add_argument("--round", nargs="*", default=[], choices=list(ROUND_GROUPS),
                    help="f32 sites to round to the compute dtype")
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--n_steps", type=int, default=400)
    ap.add_argument("--log_every", type=int, default=25)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    from optimalstrategiesagainstgenerativeattacks_torch import train_multiseed_gim_on_imgs as cli
    from optimalstrategiesagainstgenerativeattacks_torch.train import multiseed

    multiseed.build_models = with_f32_parts(multiseed.build_models, args.f32)
    print(f"f32 parts: {args.f32 or 'none'}; rounded sites: {args.round or 'none'}", flush=True)
    with tempfile.TemporaryDirectory() as out, rounded_sites(args.round):
        cli.main(["--dataset_root", args.dataset_root, "-o", out, "--seeds", str(args.seed),
                  "--n_steps", str(args.n_steps), "--save_every", str(args.n_steps),
                  "--log_every", str(args.log_every), "--device", args.device])


if __name__ == "__main__":
    main()
