"""The image game's ``use_img_att`` option in the port against the JAX package, on the CPU.

* ``ImgAttention`` (``nn/blocks.py``) at 16x16, one and three channels, f32,
  on the JAX module's weights and spectral vectors carried by the transplant:
  the blend within rtol 1e-5 / atol 1e-6, and the gradients of a random
  projection of it with respect to both images and every parameter within
  1e-5 of each tensor's largest entry.
* The impersonator with ``img_att`` (img 16, style 32, m1 n2, norms and
  attention gammas randomised, z injected): in f32 the fake within the bars
  of ``test_torch_models.py`` (rtol 1e-4 / atol 5e-5), and the gradients of a
  random projection of it, every parameter within rtol 1e-3 plus 1e-4 of its
  tensor's largest entry plus 1e-6 of the largest entry of all (AdaIN
  divides by small per-channel stds; the attention f biases have a gradient
  of 0 in exact arithmetic; as in ``test_torch_train_step.py``); in bf16 the
  fake under ``test_torch_models.py``'s bf16 bars (against the f32 reference, no further
  than the reference's own bf16 fake); the 15 extra SN convs advance with
  the player's power iteration.
* The restore: a JAX experiment directory with ``use_img_att: true`` in its
  ``args.json`` goes through ``scripts/torch_import_jax_ckpt.py`` into the
  port's layout, and the port's eval path (``eval/authentication.py``)
  restores it on the CPU: the players equal the JAX weights, the
  impersonator's fakes equal the JAX fakes (z injected), and the
  authenticator scores them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimalstrategiesagainstgenerativeattacks_torch.eval import authentication as tauth
from optimalstrategiesagainstgenerativeattacks_torch.nn.blocks import ImgAttention
from optimalstrategiesagainstgenerativeattacks_torch.nn.init import init_module
from optimalstrategiesagainstgenerativeattacks_torch.ops.spectral import power_iterate
from optimalstrategiesagainstgenerativeattacks_torch.port.transplant import (
    flax_to_state_dict,
    load_flax,
)
from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg
from optimalstrategiesagainstgenerativeattacks_tpu.nn import blocks as jblocks
from optimalstrategiesagainstgenerativeattacks_tpu.train import image as jimage
from optimalstrategiesagainstgenerativeattacks_tpu.train.checkpoints import CheckpointIO
from optimalstrategiesagainstgenerativeattacks_tpu.utils import config as jconfig
from test_torch_eval import _import_script
from test_torch_models import _apply_as_written
from test_torch_support import jax_build, jax_cfg, randomise_norms_and_gammas, small_cfg, to_numpy

torch.set_num_threads(1)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _assert_grads_close(got: dict, want: dict, rtol: float, floor: float) -> None:
    """|err| <= rtol |ref| + floor max|ref| of the tensor + 1e-6 max|ref| of them all
    (the last for tensors whose gradient is 0 in exact arithmetic, such as the
    attention f biases, which shift every source score of a column alike)."""
    assert set(got) == set(want)
    overall = max(np.abs(w).max() for w in want.values())
    for k, g in got.items():
        np.testing.assert_allclose(g, want[k], rtol=rtol, err_msg=k,
                                   atol=floor * np.abs(want[k]).max() + 1e-6 * overall)


@pytest.mark.parametrize("channels", [1, 3])
def test_img_attention_matches_jax(channels):
    rng = np.random.default_rng(channels)
    x1, x2, proj = (rng.uniform(-1, 1, (2, 16, 16, channels)).astype(np.float32)
                    for _ in range(3))
    jmod = jblocks.ImgAttention(img1_channels=channels)
    variables = to_numpy(jmod.init(jax.random.PRNGKey(channels), x1, x2))

    def loss(params, a, b):
        out = jmod.apply({"params": params, "spectral": variables["spectral"]}, a, b)
        return (out * proj).sum(), out

    (_, want), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        variables["params"], x1, x2)
    module = ImgAttention(channels)
    load_flax(module, variables["params"], variables["spectral"])
    a, b = (_nchw(x).clone().requires_grad_(True) for x in (x1, x2))
    out = module(a, b)
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    (out * _nchw(proj)).sum().backward()
    got = {k: p.grad.numpy() for k, p in module.named_parameters()}
    got.update(x1=a.grad.permute(0, 2, 3, 1).numpy(), x2=b.grad.permute(0, 2, 3, 1).numpy())
    want_grads = flax_to_state_dict(to_numpy(grads[0]), {})
    want_grads.update(x1=np.asarray(grads[1]), x2=np.asarray(grads[2]))
    _assert_grads_close(got, want_grads, rtol=0, floor=1e-5)


@pytest.fixture(scope="module")
def jax_exp(tmp_path_factory):
    """A JAX experiment directory with use_img_att (args.json, one checkpoint) whose
    players have randomised norms and gammas; returns (cfg, dir, JAX state, jim)."""
    cfg = small_cfg(use_img_att=True)
    jcfg = jax_cfg(cfg)
    jau, jim = jax_build(cfg)
    template, _, _, _ = jimage.create_state(jcfg, jau, jim, jax.random.PRNGKey(0))
    rng = np.random.default_rng(100)
    state = template.replace(
        params_au=randomise_norms_and_gammas(to_numpy(template.params_au), rng),
        params_im=randomise_norms_and_gammas(to_numpy(template.params_im), rng),
        spectral_au=to_numpy(template.spectral_au), spectral_im=to_numpy(template.spectral_im))
    exp_dir = tmp_path_factory.mktemp("jax_img_att")
    jconfig.save_args(jcfg, str(exp_dir))
    CheckpointIO(str(exp_dir / "ckpts")).save(state, 3, last_epoch=1)
    return cfg, exp_dir, state, jim


@pytest.fixture(scope="module")
def inputs(jax_exp):
    cfg = jax_exp[0]
    rng = np.random.default_rng(5)
    s = cfg.img_size
    leaked = rng.uniform(-1, 1, (cfg.batch_size, cfg.m, s, s, 1)).astype(np.float32)
    z = rng.standard_normal((cfg.batch_size, cfg.n, cfg.style_dim)).astype(np.float32)
    proj = rng.uniform(-1, 1, (cfg.batch_size, cfg.n, s, s, 1)).astype(np.float32)
    return leaked, z, proj


@pytest.fixture(scope="module")
def f32_reference(jax_exp, inputs):
    """The JAX impersonator's f32 fake and the gradients of sum(fake * proj)."""
    cfg, _, state, jim = jax_exp
    leaked, z, proj = inputs

    def loss(params):
        fake = jim.apply({"params": params, "spectral": state.spectral_im}, leaked, cfg.n, True,
                         False, z=z)
        return (fake * proj).sum(), fake

    (_, fake), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(state.params_im)
    return np.asarray(fake), flax_to_state_dict(to_numpy(grads), {})


def _port_im(cfg, state):
    _, im = timg.build_models(cfg)
    init_module(im, torch.Generator().manual_seed(0))
    load_flax(im, state.params_im, state.spectral_im)
    return im


def test_impersonator_with_img_att_matches_jax_f32(jax_exp, inputs, f32_reference):
    cfg, _, state, _ = jax_exp
    leaked, z, proj = inputs
    want_fake, want_grads = f32_reference
    im = _port_im(cfg, state)
    assert len([m for m in im.img_att.modules() if hasattr(m, "power_iterate_")]) == 15
    fake = im(torch.from_numpy(leaked), cfg.n, True, z=torch.from_numpy(z))
    assert fake.shape == (cfg.batch_size, cfg.n, cfg.img_size, cfg.img_size, 1)
    np.testing.assert_allclose(fake.detach().numpy(), want_fake, rtol=1e-4, atol=5e-5)
    (fake * torch.from_numpy(proj)).sum().backward()
    got = {k: p.grad.numpy() for k, p in im.named_parameters()}
    assert any(k.startswith("img_att.v2conv.") for k in got)
    _assert_grads_close(got, want_grads, rtol=1e-3, floor=1e-4)


def test_impersonator_with_img_att_matches_jax_bf16(jax_exp, inputs, f32_reference):
    cfg, _, state, _ = jax_exp
    leaked, z, _ = inputs
    f32_fake = f32_reference[0]
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    _, jim16 = jax_build(cfg16)
    iv = {"params": state.params_im, "spectral": state.spectral_im}
    default_fake = np.asarray(jim16.apply(iv, leaked, cfg.n, True, False, z=z), np.float32)
    want_fake = np.asarray(_apply_as_written(jim16, iv, leaked, cfg.n, True, False, z=z),
                           np.float32)
    with torch.no_grad():
        fake = _port_im(cfg16, state)(torch.from_numpy(leaked).bfloat16(), cfg.n, True,
                                      z=torch.from_numpy(z))
    assert fake.dtype == torch.bfloat16
    fake = fake.float().numpy()
    assert np.abs(fake - want_fake).mean() < 3e-2
    port_err = np.abs(fake - f32_fake)
    assert port_err.mean() <= 1.5 * np.abs(default_fake - f32_fake).mean()
    assert port_err.max() <= np.abs(want_fake - f32_fake).max()


def test_img_att_spectral_state_advances_with_the_player():
    """Each of img_att's 15 SN convs takes part in the player's power iteration (at
    three channels: with one output channel u is +-1 and cannot move)."""
    cfg = small_cfg(use_img_att=True, img_channels=3)
    _, im = timg.build_models(cfg)
    init_module(im, torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in im.img_att.named_buffers()}
    power_iterate(im)
    after = dict(im.img_att.named_buffers())
    assert len(before) == 30
    # from the init's v = l2n(W^T u), the first iteration moves u (v follows after)
    us = [k for k in before if k.endswith(".u")]
    assert len(us) == 15 and all(not torch.equal(before[k], after[k]) for k in us)


def test_jax_img_att_experiment_restores_and_scores_in_the_port(jax_exp, inputs, f32_reference,
                                                                tmp_path):
    cfg, exp_dir, state, _ = jax_exp
    leaked, z, _ = inputs
    out = tmp_path / "port"
    path = _import_script().main(["--jax_exp_dir", str(exp_dir), "--out_dir", str(out)])
    ckpt, args = tauth.get_exp_args_from_dir(str(out))
    assert args["use_img_att"] is True and ckpt == path
    _, au, im, _ = tauth._restore_gim_state(ckpt, args, "cpu")
    for module, params, spectral in ((au, state.params_au, state.spectral_au),
                                     (im, state.params_im, state.spectral_im)):
        want = flax_to_state_dict(params, spectral)
        got = module.state_dict()
        assert set(got) == set(want)
        for k, v in got.items():
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)

    fake = tauth.get_gim_impersonator(ckpt, args, "cpu").im_model_func(leaked, z=z)
    np.testing.assert_allclose(fake.numpy(), f32_reference[0], rtol=1e-4, atol=5e-5)
    rng = np.random.default_rng(6)
    si = rng.uniform(-1, 1, (cfg.batch_size, cfg.k, cfg.img_size, cfg.img_size, 1))
    scores = tauth.get_gim_authenticator(ckpt, args, "cpu").act(
        test_sample=fake.numpy(), si_sample=si.astype(np.float32))[0]
    assert scores.shape[0] == cfg.batch_size and np.all(np.isfinite(scores))
    tauth._RESTORE_CACHE.clear()
