"""The games' hyperparameters, as the port reads them, and ``args.json``.

The fields and their defaults are those of the reference's
``optimalstrategiesagainstgenerativeattacks_tpu/utils/config.py``:
``GaussianGameConfig`` whole, and ``ImageGameConfig`` (the Omniglot paper
hparams) restricted to what the port's models, train step and loop read;
tests hold every default equal to the reference's.  The port keeps its own
copy so that it, and a GPU host running it, needs nothing of the reference
package.  ``from_dict`` ignores keys it does not know, so an ``args.json``
written by the reference (with its TPU-only keys) loads.

``save_args`` / ``load_args`` snapshot a run's arguments to
``<outdir>/args.json`` as flat JSON with the reference's key names;
``from_dict`` maps the old ``target_img_size`` key onto ``img_size``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import List, Optional


def save_args(args, outdir: str) -> str:
    """Snapshot a config (a dataclass, a dict or an argparse namespace) to args.json."""
    os.makedirs(outdir, exist_ok=True)
    json_path = os.path.join(outdir, "args.json")
    if dataclasses.is_dataclass(args):
        payload = dataclasses.asdict(args)
    else:
        payload = args if isinstance(args, dict) else vars(args)
    with open(json_path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
    return json_path


def load_args(outdir: str) -> dict:
    """Load the args.json snapshot as a dict (``ImageGameConfig.from_dict`` reads it)."""
    with open(os.path.join(outdir, "args.json")) as f:
        return json.load(f)


@dataclass
class GaussianGameConfig:
    """Hyperparameters of the synthetic Gaussian GIM game (the reference CLI's defaults).

    ``au_stat`` ("mean_std" or "mean_std_fc") and ``au_hidden_scale`` choose the
    authenticator's pooling stat and widen its head; the defaults are the
    reference architecture.  ``log_every`` is the host's metric-read cadence.
    """

    outdir: str = "./gim_gaussians_outdir/"
    resume_from_ckpt: Optional[str] = None
    pretrained: Optional[str] = None
    n_iters: int = 500_000
    batch_size: int = 4096
    m: int = 1
    n: int = 10
    k: int = 10
    prior_sigma: float = 10.0
    src_sigma: float = 1.0
    src_dim: int = 1
    au_lr: float = 1e-4
    im_lr: float = 1e-4
    reg_param: float = 0.0
    remove_noise_mean: bool = True
    save_every: int = 100_000
    eval_every: int = 1000
    save_stats_every: int = 100
    seed: int = 1
    log_every: int = 100
    compute_dtype: str = "float32"
    au_stat: str = "mean_std"
    au_hidden_scale: int = 1

    @classmethod
    def from_dict(cls, d: dict) -> "GaussianGameConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclass
class ImageGameConfig:
    """Hyperparameters of the image GIM game (defaults: Omniglot, 32x32x1, style 512).

    The VoxCeleb2 paper hparams: ``img_size=64, img_channels=3, au_lr=1e-4,
    im_lr=1e-4, env_noise_mapping_lr=1e-6, reg_param=10``.
    """

    outdir: str = "./gim_imgs_outdir/"
    dataset_root: str = ""
    dataset_type: str = "omniglot"  # omniglot | voxceleb2
    ckpt_dir_name: str = "ckpts"
    resume_from_ckpt: Optional[str] = None
    pretrained: Optional[str] = None
    n_epochs: int = 100_000
    batch_size: int = 128
    num_workers: int = 4
    ds_n_examples_per_cls: int = 100
    m: int = 1
    n: int = 5
    k: int = 5
    img_channels: int = 1
    img_size: int = 32
    style_dim: int = 512
    num_env_noise_layers: int = 4
    au_lr: float = 1e-6
    im_lr: float = 1e-5
    beta1: float = 0.0
    beta2: float = 0.99
    env_noise_mapping_lr: float = 1e-7
    lr_gamma: float = 0.3
    milestones: List[int] = field(default_factory=list)
    reg_param: float = 0.0
    remove_noise_mean: bool = True
    use_img_att: bool = False
    save_every: int = 10_000
    eval_every: int = 500
    save_imgs_every: int = 500
    n_au_steps: int = 1
    dbg: bool = False
    seed: int = 1
    log_every: int = 100  # scalar flush cadence (the reference's tb_log_every)
    log_enc_every: int = 500  # encoder-diagnostic cadence (tb_log_enc_every)
    compute_dtype: str = "bfloat16"
    prefetch_depth: int = 2  # batches the host loader's copy thread stages ahead
    # device-resident episodic sampling (data/device_sampler.py): stage the
    # whole uniform-count dataset on the device once and assemble every batch
    # there, so no image bytes cross to the device per step.  'auto' uses it
    # whenever the dataset has a uniform stacked cache; 'on' requires it;
    # 'off' keeps the host loader (with data/prefetch.py's copy thread)
    device_data: str = "auto"

    @classmethod
    def from_dict(cls, d: dict) -> "ImageGameConfig":
        if "img_size" not in d and "target_img_size" in d:
            d = dict(d, img_size=d["target_img_size"])
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})
