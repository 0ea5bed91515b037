"""The image game's hyperparameters, as the port reads them.

The fields and their defaults are those of the reference's
``optimalstrategiesagainstgenerativeattacks_tpu/utils/config.py``
``ImageGameConfig`` (the Omniglot paper hparams), restricted to what the
port's models and train step read; a test holds every default equal to the
reference's.  The port keeps its own copy so that it, and a GPU host
running it, needs nothing of the reference package.  ``from_dict`` ignores
keys it does not know, so an ``args.json`` written by the reference (with
its TPU-only keys) loads.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List


@dataclass
class ImageGameConfig:
    """Hyperparameters of the image GIM game (defaults: Omniglot, 32x32x1, style 512)."""

    batch_size: int = 128
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
    n_au_steps: int = 1
    seed: int = 1
    compute_dtype: str = "bfloat16"

    @classmethod
    def from_dict(cls, d: dict) -> "ImageGameConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})
