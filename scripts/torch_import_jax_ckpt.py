"""Turn a JAX experiment directory into one the PyTorch port reads.

    python scripts/torch_import_jax_ckpt.py --jax_exp_dir <jax outdir> --out_dir <port outdir>
        [--kind gim|siamese|arcface] [--specific_model model_00001000]

Reads ``<jax_exp_dir>/args.json`` and one checkpoint of ``<jax_exp_dir>/ckpts/``
(the latest, or ``--specific_model``) with the JAX package, carries the
weights through ``port/transplant.py``, and writes ``<out_dir>/args.json``
and ``<out_dir>/ckpts/<the same name>`` as the port saves them, so the
port's eval CLI and its ``--pretrained`` read it:

  * gim: both players (parameters and spectral u, v), restored with the JAX
    package's ``eval/authentication.py:_restore_gim_state``; the step and
    epoch carry across, the optimizers start afresh;
  * siamese / arcface: the baseline's parameters and BatchNorm statistics,
    payload ``{"model": ...}`` / ``{"arcface": ...}``.

Needs JAX, Flax and orbax as well as torch: run it where the JAX package
runs.  The port's package itself never imports JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def _ckpt_path(exp_dir: str, specific_model):
    from optimalstrategiesagainstgenerativeattacks_tpu.train.checkpoints import get_latest_ckpt

    ckpts = os.path.join(exp_dir, "ckpts")
    return get_latest_ckpt(ckpts) if specific_model is None else os.path.join(ckpts, specific_model)


def import_gim(ckpt_path: str, args_dict: dict, out_dir: str) -> str:
    import jax
    import numpy as np

    from optimalstrategiesagainstgenerativeattacks_torch.port.transplant import load_flax
    from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg
    from optimalstrategiesagainstgenerativeattacks_torch.train.checkpoints import CheckpointIO
    from optimalstrategiesagainstgenerativeattacks_torch.utils.config import ImageGameConfig
    from optimalstrategiesagainstgenerativeattacks_tpu.eval.authentication import (
        _restore_gim_state,
    )
    from optimalstrategiesagainstgenerativeattacks_tpu.train.checkpoints import (
        CheckpointIO as JaxCheckpointIO,
    )

    _, _, _, jstate = _restore_gim_state(ckpt_path, args_dict)
    _, step, last_epoch = JaxCheckpointIO(os.path.dirname(ckpt_path)).load(ckpt_path, jstate)
    cfg = ImageGameConfig.from_dict(args_dict)
    au, im = timg.build_models(cfg)
    state = timg.create_state(cfg, au, im, cfg.seed, "cpu")
    host = jax.tree.map(np.asarray, jstate)
    load_flax(state.au, host.params_au, host.spectral_au)
    load_flax(state.im, host.params_im, host.spectral_im)
    return CheckpointIO(os.path.join(out_dir, "ckpts")).save(state, step, last_epoch=last_epoch)


def import_baseline(kind: str, ckpt_path: str, args_dict: dict, out_dir: str) -> str:
    import numpy as np
    import orbax.checkpoint as ocp

    from optimalstrategiesagainstgenerativeattacks_torch.baselines import training
    from optimalstrategiesagainstgenerativeattacks_torch.port.transplant import load_flax

    key = "model" if kind == "siamese" else "arcface"
    variables = ocp.PyTreeCheckpointer().restore(os.path.abspath(ckpt_path))[key]
    if kind == "siamese":
        model = training.build_siamese(args_dict.get("img_channels", 1),
                                       args_dict.get("img_size", 32))
    else:
        n_classes = np.asarray(variables["params"]["head"]["kernel"]).shape[-1]
        model = training.build_arcface(args_dict, n_classes)
    load_flax(model, variables["params"], variables["batch_stats"])
    step = int(os.path.basename(ckpt_path)[len("model_"):])
    return training.save_checkpoint(out_dir, step, {key: model.state_dict()})


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jax_exp_dir", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--kind", default="gim", choices=["gim", "siamese", "arcface"])
    ap.add_argument("--specific_model", default=None,
                    help="checkpoint name under ckpts/ (default: the latest)")
    args = ap.parse_args(argv)

    from optimalstrategiesagainstgenerativeattacks_torch.utils.config import save_args
    from optimalstrategiesagainstgenerativeattacks_tpu.utils.config import load_args

    args_dict = load_args(args.jax_exp_dir)
    ckpt_path = _ckpt_path(args.jax_exp_dir, args.specific_model)
    save_args(args_dict, args.out_dir)
    if args.kind == "gim":
        out = import_gim(ckpt_path, args_dict, args.out_dir)
    else:
        out = import_baseline(args.kind, ckpt_path, args_dict, args.out_dir)
    print(f"{ckpt_path} -> {out}")
    return out


if __name__ == "__main__":
    main()
