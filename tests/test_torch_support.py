"""Shared helpers of the PyTorch port's parity tests, and the port's import rules.

The helpers build the JAX reference players at a small config, give their
instance norms and attention gammas random values (at init those sit at
(1, 0) and 0, where the attention branch adds nothing and the env decoder's
spatially constant maps meet zero-variance instance norms that amplify
rounding noise), and carry the weights into the port with the transplant.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from optimalstrategiesagainstgenerativeattacks_torch.port.transplant import load_flax
from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg
from optimalstrategiesagainstgenerativeattacks_torch.utils.config import (
    GaussianGameConfig,
    ImageGameConfig,
)
from optimalstrategiesagainstgenerativeattacks_tpu.train.image import build_models as _jax_build
from optimalstrategiesagainstgenerativeattacks_tpu.utils import config as jconfig

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "optimalstrategiesagainstgenerativeattacks_torch"


def small_cfg(**overrides) -> ImageGameConfig:
    """The port's config at the test size (img 16, style 32, B=2, m1 n2 k2, f32)."""
    kw = dict(img_size=16, style_dim=32, m=1, n=2, k=2, batch_size=2, compute_dtype="float32")
    kw.update(overrides)
    return ImageGameConfig(**kw)


def jax_cfg(cfg: ImageGameConfig) -> jconfig.ImageGameConfig:
    """The reference's config with the same fields; its authenticator phase in one chunk."""
    return jconfig.ImageGameConfig(**dataclasses.asdict(cfg), au_microbatch=1)


def jax_build(cfg: ImageGameConfig):
    """The reference's (au, im) modules for the port's config."""
    return _jax_build(jax_cfg(cfg))


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def randomise_norms_and_gammas(tree, rng):
    """Copy of a Flax params tree with InstanceNorm scale/bias, attention gamma and a
    constant input image (``init_img``, all ones at init) random."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomise_norms_and_gammas(v, rng)
        elif k in ("gamma", "init_img") or (k in ("scale", "bias") and "scale" in tree):
            base = 1.0 if k == "scale" else 0.0
            out[k] = (base + 0.5 * rng.standard_normal(np.shape(v))).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def init_jax_players(cfg: ImageGameConfig, seed: int = 0):
    """(au, im, au_vars, im_vars) of the reference, with randomised norms and gammas."""
    jau, jim = jax_build(cfg)
    key = jax.random.PRNGKey(seed)
    s, c = cfg.img_size, cfg.img_channels
    av = jau.init(key, jnp.zeros((1, cfg.n, s, s, c)), jnp.zeros((1, cfg.k, s, s, c)))
    iv = jim.init({"params": key, "noise": key}, jnp.zeros((1, cfg.m, s, s, c)), cfg.n)
    rng = np.random.default_rng(seed + 100)
    av = {"params": randomise_norms_and_gammas(to_numpy(av["params"]), rng),
          "spectral": to_numpy(av["spectral"])}
    iv = {"params": randomise_norms_and_gammas(to_numpy(iv["params"]), rng),
          "spectral": to_numpy(iv["spectral"])}
    return jau, jim, av, iv


def torch_state_from(cfg: ImageGameConfig, av, iv):
    """Port game state on the CPU holding the reference players' weights."""
    au, im = timg.build_models(cfg)
    state = timg.create_state(cfg, au, im, 0, "cpu")
    load_flax(state.au, av["params"], av["spectral"])
    load_flax(state.im, iv["params"], iv["spectral"])
    return state


def uint8_batch(cfg: ImageGameConfig, seed: int):
    rng = np.random.default_rng(seed)
    s, c, b = cfg.img_size, cfg.img_channels, cfg.batch_size
    return {key: rng.integers(0, 256, (b, n, s, s, c), dtype=np.uint8)
            for key, n in (("real_sample", cfg.n), ("leaked_sample", cfg.m),
                           ("si_sample", cfg.k))}


def test_package_source_imports_no_jax():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|optax|orbax|sklearn|pandas"
        r"|optimalstrategiesagainstgenerativeattacks_tpu)\b")
    offenders = [f"{p.relative_to(REPO)}:{i}" for p in [*PKG.rglob("*.py"), REPO / "chip_smoke.py"]
                 for i, line in enumerate(p.read_text().splitlines(), 1) if pattern.match(line)]
    assert offenders == []


def test_config_defaults_match_the_reference():
    reference = jconfig.ImageGameConfig()
    for f in dataclasses.fields(ImageGameConfig):
        assert getattr(ImageGameConfig(), f.name) == getattr(reference, f.name), f.name
    # an args.json of the reference, TPU-only keys included, loads
    assert ImageGameConfig.from_dict(dataclasses.asdict(reference)) == ImageGameConfig()


def test_gaussian_config_defaults_match_the_reference():
    reference = jconfig.GaussianGameConfig()
    assert dataclasses.asdict(GaussianGameConfig()) == dataclasses.asdict(reference)
    # an args.json of the reference CLI, with keys the config does not hold, loads
    args = dict(dataclasses.asdict(reference), ckpt_dir_name="ckpts", src_dim=10, n=5)
    assert GaussianGameConfig.from_dict(args) == GaussianGameConfig(src_dim=10, n=5)


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'sklearn', 'pandas',\n"
        "             'optimalstrategiesagainstgenerativeattacks_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.train.image as t\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.port.transplant\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.kernels.build\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.train.checkpoints\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.train.logger\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.data.episodic\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.data.utils\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.utils.config\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.train_gim_on_imgs\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.eval.scorer\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.eval.agents\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.eval.authentication\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.baselines.layers\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.baselines.siamese\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.baselines.arcface\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.baselines.training as b\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.eval_gim_on_authentication\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.train_siamese_baseline\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.train_arcface_baseline\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.train.gaussian as g\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.models.gaussian\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.theory.game_value as v\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.train_gim_on_gaussians\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.data.device_sampler\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.data.prefetch\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.train.multiseed\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.train_multiseed_gim_on_imgs\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.nn.blocks as nb\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.nn.stats\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.nn.init\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.ops.adain\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.ops.image_ops\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.ops.stats\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.train.losses\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.train.utils\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.data.voxceleb_prep\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.prepare_voxceleb_dataset\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.parallel.mesh as pm\n"
        "import optimalstrategiesagainstgenerativeattacks_torch.parallel.tensor\n"
        "assert round(v.game_value_mnk(1, 5, 10, 10), 6) == 0.921131\n"
        "g.train_step(g.create_state(g.GaussianGameConfig(batch_size=8, src_dim=2), 'cpu'))\n"
        "from optimalstrategiesagainstgenerativeattacks_torch.eval.scorer import roc_auc\n"
        "assert roc_auc([1, 0, 1], [0.3, 0.1, 0.3]) == 1.0\n"
        "b.build_siamese(1, 16)\n"
        "au, im = t.build_models(t.ImageGameConfig(img_size=16, style_dim=32, use_img_att=True))\n"
        "nb.SGDecoderBlock(4, 2, 3)\n"
        "assert (pm.world_size(), pm.rank(), pm.adjust_batch_size(9, 128, 8)) == (1, 0, 8)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cpu_tensors_use_plain_versions_and_count_no_launch():
    from optimalstrategiesagainstgenerativeattacks_torch.kernels import adain, attention

    before = (adain.FWD_LAUNCHES.count, adain.BWD_LAUNCHES.count,
              attention.FWD_LAUNCHES.count)
    x = torch.randn(2, 3, 4, 4, requires_grad=True)
    s = torch.randn(2, 3)
    adain.ada_in(x, s, s).sum().backward()
    f = torch.randn(2, 4, 2)
    attention.attention_core(f, f, torch.randn(2, 4, 3))
    after = (adain.FWD_LAUNCHES.count, adain.BWD_LAUNCHES.count,
             attention.FWD_LAUNCHES.count)
    assert before == after


def test_prepare_voxceleb_cli_help_runs_with_jax_blocked():
    code = (
        "import runpy, sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'cv2',\n"
        "             'optimalstrategiesagainstgenerativeattacks_tpu'):\n"
        "    sys.modules[name] = None\n"
        "sys.argv = ['prepare_voxceleb_dataset', '--help']\n"
        "runpy.run_module('optimalstrategiesagainstgenerativeattacks_torch.prepare_voxceleb_dataset',"
        " run_name='__main__')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--src_vid_ds_root" in out.stdout and "--skip_frames" in out.stdout
