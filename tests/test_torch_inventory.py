"""The rest of the port's inventory against the JAX package, on the CPU.

Set statistics, the new image ops and ``pixel_norm``, the weight
initialisers' statistics, ``grad2_penalty``, the training utilities
(``accumulate``, ``lin_interpolation``, ``freeze`` with Adam against optax),
``num_parameters`` and the VoxCeleb preparation.  Inputs come from numpy
seeds and go to both sides; weights go through the transplant.

Tolerances: f32 outputs rtol 1e-4 / atol 1e-5, gradients rtol 1e-3 / atol
1e-6; the parameter gradients of a penalty (a double backward) 1e-3 of each
tensor's largest entry plus 1e-6 of the model's, as the R1 tests hold them.
Sample statistics of an initialiser: the sample std within 5 % of the
distribution's (at least 2048 draws: the estimate's own spread is under
1.6 %), the sample mean within 5 % of the std of 0.  ``init_resmlp_to_replay``
draws from a ``torch.Generator``, so its bits differ from the reference's:
it is held by its structure (the identity block exact, zero biases, the
other skip entries N(0, 1e-4^2), the inner MLP kaiming(0.2)), the
reference's output by the same, and the forward under transplanted weights.
"""

import copy
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn
from PIL import Image

from optimalstrategiesagainstgenerativeattacks_torch.data import voxceleb_prep as tprep
from optimalstrategiesagainstgenerativeattacks_torch.nn import blocks as tblocks
from optimalstrategiesagainstgenerativeattacks_torch.nn import init as tinit
from optimalstrategiesagainstgenerativeattacks_torch.nn import stats as tnstats
from optimalstrategiesagainstgenerativeattacks_torch.ops import adain as tadain
from optimalstrategiesagainstgenerativeattacks_torch.ops import image_ops as tio
from optimalstrategiesagainstgenerativeattacks_torch.ops import stats as tstats
from optimalstrategiesagainstgenerativeattacks_torch.port.transplant import (
    flax_to_state_dict,
    load_flax,
    state_dict_to_flax,
)
from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg
from optimalstrategiesagainstgenerativeattacks_torch.train import losses as tlosses
from optimalstrategiesagainstgenerativeattacks_torch.train import utils as tutils
from optimalstrategiesagainstgenerativeattacks_tpu.data import voxceleb_prep as jprep
from optimalstrategiesagainstgenerativeattacks_tpu.nn import blocks as jblocks
from optimalstrategiesagainstgenerativeattacks_tpu.nn import init as jinit
from optimalstrategiesagainstgenerativeattacks_tpu.nn import stats as jnstats
from optimalstrategiesagainstgenerativeattacks_tpu.ops import adain as jadain
from optimalstrategiesagainstgenerativeattacks_tpu.ops import image_ops as jio
from optimalstrategiesagainstgenerativeattacks_tpu.ops import stats as jstats
from optimalstrategiesagainstgenerativeattacks_tpu.train import losses as jlosses
from optimalstrategiesagainstgenerativeattacks_tpu.train import utils as jutils
from test_torch_support import init_jax_players, small_cfg, torch_state_from, uint8_batch

torch.set_num_threads(1)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _close(got, want, grad=False):
    rtol, atol = (1e-3, 1e-6) if grad else (1e-4, 1e-5)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


# ---- set statistics

@pytest.mark.parametrize("name", ["MeanStat", "StdStat", "LogVarStat", "MeanStdStat",
                                  "MeanLogVarStat", "DoubleFCStat"])
def test_set_stat_modules_match_jax(name):
    rng = np.random.default_rng(len(name))
    x = rng.standard_normal((3, 4, 6)).astype(np.float32)
    if name == "DoubleFCStat":
        jmod = jnstats.DoubleFCStat(6, n_stats=2, hidden_layers1=(8,), hidden_layers2=(5, 7))
        tmod = tnstats.DoubleFCStat(6, n_stats=2, hidden_layers1=(8,), hidden_layers2=(5, 7))
        params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(1), x)["params"])
        load_flax(tmod, params, {})
    else:
        jmod, tmod, params = getattr(jnstats, name)(), getattr(tnstats, name)(), {}
    assert tmod.n_stats == jmod.n_stats
    want = np.asarray(jmod.apply({"params": params}, x))
    assert want.shape == (3, 6 * tmod.n_stats)
    ct = rng.standard_normal(want.shape).astype(np.float32)
    want_grads = jax.grad(lambda p, a: (jmod.apply({"params": p}, a) * ct).sum(),
                          argnums=(0, 1))(params, x)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tmod(tx)
    _close(out.detach(), want)
    (out * torch.from_numpy(ct)).sum().backward()
    _close(tx.grad, want_grads[1], grad=True)
    want_params = flax_to_state_dict(want_grads[0], {})
    assert set(want_params) == {k for k, _ in tmod.named_parameters()}
    for k, p in tmod.named_parameters():
        _close(p.grad, want_params[k], grad=True)


def test_logvar_ops_match_jax():
    x = np.random.default_rng(4).standard_normal((4, 5, 7)).astype(np.float32)
    t = torch.from_numpy(x)
    _close(tstats.logvar_stat(t), jstats.logvar_stat(x))
    _close(tstats.mean_logvar_stat(t), jstats.mean_logvar_stat(x))


# ---- image ops and pixel_norm

OPS = {  # name: (port op, JAX op, NHWC input shape)
    "max_pool2d": (tio.max_pool2d, jio.max_pool2d, (2, 6, 4, 3)),
    "max_pool2d_w3s2": (lambda x: tio.max_pool2d(x, 3, 2), lambda x: jio.max_pool2d(x, 3, 2),
                        (2, 7, 9, 3)),
    "adaptive_avg_pool": (tio.adaptive_avg_pool, jio.adaptive_avg_pool, (2, 6, 4, 3)),
    "blur3x3": (tio.blur3x3, jio.blur3x3, (2, 6, 5, 4)),
    "blur3x3_unnormalised_s2": (lambda x: tio.blur3x3(x, False, 2),
                                lambda x: jio.blur3x3(x, False, 2), (2, 7, 6, 3)),
    "blur3x3_one_channel": (tio.blur3x3, jio.blur3x3, (3, 8, 8, 1)),
    "pixel_norm": (tadain.pixel_norm, jadain.pixel_norm, (2, 4, 3, 5)),
}


@pytest.mark.parametrize("name", list(OPS))
def test_image_ops_and_pixel_norm_match_jax(name):
    top, jop, shape = OPS[name]
    rng = np.random.default_rng(len(name))
    x = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(jop(x))
    ct = rng.standard_normal(want.shape).astype(np.float32)
    want_dx = np.asarray(jax.grad(lambda a: (jop(a) * ct).sum())(x))
    tx = nchw(x).requires_grad_(True)
    out = top(tx)
    _close(out.detach() if out.ndim == 2 else nhwc(out), want)
    (out * (torch.from_numpy(ct) if out.ndim == 2 else nchw(ct))).sum().backward()
    _close(nhwc(tx.grad), want_dx, grad=True)


def test_blur3x3_keeps_bf16_and_a_constant():
    x = torch.full((1, 2, 6, 6), 3.0, dtype=torch.bfloat16)
    y = tio.blur3x3(x)
    assert y.dtype == torch.bfloat16
    assert (y[:, :, 1:-1, 1:-1] == 3.0).all()


# ---- weight initialisers

def _stats_ok(w, std, mean=0.0):
    w = np.asarray(w, np.float64).ravel()
    assert abs(w.std() - std) <= 0.05 * std, (w.std(), std)
    assert abs(w.mean() - mean) <= 0.05 * std, (w.mean(), mean)


INIT_STD = {  # fan_in, fan_out -> the distribution's std
    "gaussian": lambda fi, fo: 0.02,
    "xavier": lambda fi, fo: np.sqrt(4.0 / (fi + fo)),
    "kaiming": lambda fi, fo: np.sqrt(2.0 / (1.04 * fi)),
    "orthogonal": None,
    "default": lambda fi, fo: 1.0 / np.sqrt(3.0 * fi),
}


@pytest.mark.parametrize("init_type", list(INIT_STD))
@pytest.mark.parametrize("shape", [(64, 32, 3, 3), (96, 160)], ids=["conv", "dense"])
def test_weights_init_statistics_match_the_reference(init_type, shape):
    fan_in = int(np.prod(shape[1:]))
    fan_out = shape[0] * int(np.prod(shape[2:]))
    w, b = torch.empty(shape), torch.full((shape[0],), 7.0)
    tinit.weights_init(init_type)(w, b, torch.Generator().manual_seed(0))
    jshape = (*shape[2:], shape[1], shape[0]) if len(shape) == 4 else shape[::-1]
    jw = np.asarray(jinit.weights_init(init_type)(jax.random.PRNGKey(0), jshape))
    if init_type == "orthogonal":
        m = w.reshape(shape[0], -1).double()  # [out, fan_in]: rows orthogonal, norm sqrt(2)
        small = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
        torch.testing.assert_close(small, 2.0 * torch.eye(small.shape[0], dtype=torch.float64),
                                   rtol=0, atol=1e-5)
        jm = jw.reshape(-1, jshape[-1]).astype(np.float64)
        jsmall = jm.T @ jm if jm.shape[1] <= jm.shape[0] else jm @ jm.T
        np.testing.assert_allclose(jsmall, 2.0 * np.eye(jsmall.shape[0]), atol=1e-5)
    else:
        std = INIT_STD[init_type](fan_in, fan_out)
        _stats_ok(w, std)
        _stats_ok(jw, std)
    if init_type == "default":
        bound = 1.0 / np.sqrt(fan_in)
        assert w.abs().max() <= bound and b.abs().max() <= bound and b.abs().min() > 0
    else:
        assert (b == 0).all()


def test_weights_init_refuses_an_unknown_type():
    with pytest.raises(ValueError):
        tinit.weights_init("he")


def test_uniform_pm1_statistics_match_the_reference():
    w = torch.empty(64, 64)
    tinit.uniform_pm1_(w, torch.Generator().manual_seed(1))
    jw = np.asarray(jinit.uniform_pm1(jax.random.PRNGKey(1), (64, 64)))
    for a in (w.numpy(), jw):
        assert -1.0 <= a.min() and a.max() <= 1.0
        _stats_ok(a, 1.0 / np.sqrt(3.0))


def test_conv_inits_and_matches_flax():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 5, 5, 3)).astype(np.float32)
    jconv = jblocks.Conv(4, 3, padding=1)
    params = jax.tree.map(np.asarray, jconv.init(jax.random.PRNGKey(2), x)["params"])
    tconv = tblocks.Conv(3, 4, 3, padding=1)
    load_flax(tconv, params, {})
    _close(nhwc(tconv(nchw(x))), jconv.apply({"params": params}, x))
    kaiming = tblocks.Conv(64, 32, 3, init="kaiming")
    kaiming.reset_parameters(torch.Generator().manual_seed(3))
    _stats_ok(kaiming.weight.detach(), np.sqrt(2.0 / (1.04 * 64 * 9)))
    assert (kaiming.bias == 0).all()


def test_flatten_and_identity_match_flax():
    x = np.random.default_rng(9).standard_normal((2, 3, 4, 5)).astype(np.float32)
    _close(tblocks.Flatten()(nchw(x)), jblocks.Flatten().apply({}, x))
    _close(tblocks.Flatten()(torch.from_numpy(x[:, 0])), jblocks.Flatten().apply({}, x[:, 0]))
    t = nchw(x)
    assert tblocks.Identity()(t) is t


def _replay_structure(linear_w, linear_b, mlp, style_dim):
    """The replay init's structure on [out, in] weights: identity block, N(0, 1e-4^2)
    elsewhere, zero biases; the inner MLP (weight, bias) pairs kaiming(0.2)."""
    w = np.asarray(linear_w)
    np.testing.assert_array_equal(w[:style_dim, :style_dim], np.eye(style_dim))
    assert not np.asarray(linear_b).any()
    rest = np.ones(w.shape, bool)
    rest[:style_dim, :style_dim] = False
    _stats_ok(w[rest], 1e-4)
    for weight, bias in mlp:
        _stats_ok(weight, np.sqrt(2.0 / (1.04 * np.asarray(weight).shape[1])))
        assert not np.asarray(bias).any()


def test_init_resmlp_to_replay_structure_and_forward():
    dims, style_dim = [96, 128, 64], 32
    x = np.random.default_rng(10).standard_normal((4, 96)).astype(np.float32)
    jmod = jblocks.ResMLP(dims)
    jparams = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(4), x)["params"])
    jreplay = jax.tree.map(np.asarray, jblocks.init_resmlp_to_replay(
        jparams, style_dim, jax.random.PRNGKey(5)))
    mod = tblocks.ResMLP(dims)
    tinit.init_module(mod, torch.Generator().manual_seed(0))
    tblocks.init_resmlp_to_replay(mod, style_dim, torch.Generator().manual_seed(1))
    mlp = [(layer.weight.detach(), layer.bias.detach()) for layer in mod.model.layers]
    jmlp = [(jreplay["model"][f"Dense_{i}"]["kernel"].T, jreplay["model"][f"Dense_{i}"]["bias"])
            for i in range(len(dims) - 1)]
    for name in ("linear", "out_linear"):
        lin = getattr(mod, name)
        _replay_structure(lin.weight.detach(), lin.bias.detach(), mlp, style_dim)
        _replay_structure(jreplay[name]["kernel"].T, jreplay[name]["bias"], jmlp, style_dim)
    params, _ = state_dict_to_flax(mod.state_dict())
    _close(mod(torch.from_numpy(x)).detach(), jmod.apply({"params": params}, x))
    mod2 = tblocks.ResMLP2(dims)
    tblocks.init_resmlp_to_replay(mod2, style_dim, torch.Generator().manual_seed(2))
    assert (mod2.linear.weight[:style_dim, :style_dim] == torch.eye(style_dim)).all()


# ---- grad2_penalty

def test_grad2_penalty_matches_jax_and_r1_penalty():
    """The reference's case (``tests/test_image_training.py``'s R1 closure check: img 16,
    style 32, B=2, n=k=2, reg_param 3, f32): the penalty of the authenticator's score on
    (real, si) against JAX's; the training step's ``r1_penalty`` equals reg_param times it."""
    cfg = small_cfg(reg_param=3.0)
    jau, _, av, iv = init_jax_players(cfg, seed=5)
    batch = uint8_batch(cfg, seed=7)
    real, si = (timg.prepare(cfg, batch[k], "cpu") for k in ("real_sample", "si_sample"))
    jreal, jsi = (jnp.asarray(batch[k], jnp.float32) / 127.5 - 1.0
                  for k in ("real_sample", "si_sample"))
    want = np.asarray(jax.jit(jlosses.grad2_penalty, static_argnums=0)(
        lambda r, s: jau.apply(av, r, s), (jreal, jsi)))
    state = torch_state_from(cfg, av, iv)
    got = tlosses.grad2_penalty(state.au, (real, si))
    assert got.shape == (cfg.batch_size,) and got.requires_grad
    _close(got.detach(), want, grad=True)
    r, s = real.clone().requires_grad_(True), si.clone().requires_grad_(True)
    fake = torch.tanh(real.flip(1) * 0.5)
    out_real, _ = timg.au_outputs(state.au, r, fake, s)
    np.testing.assert_allclose(timg.r1_penalty(cfg, out_real, r, s).detach().numpy(),
                               cfg.reg_param * got.detach().numpy(), rtol=1e-5, atol=0)


class _JaxLegacyStack(fnn.Module):
    """AdaResBlock then AdaResBlockUp(4), styles from a Dense of one style."""

    @fnn.compact
    def __call__(self, x, style):
        s = [jblocks.Dense(w, name=f"map_{i}")(style) for i, w in enumerate((16, 16, 16, 8))]
        x = jblocks.AdaResBlock(name="res")(x, s[0], s[1])
        return jblocks.AdaResBlockUp(4, name="up")(x, s[2], s[3])


class _TorchLegacyStack(torch.nn.Module):
    def __init__(self):
        super().__init__()
        for i, w in enumerate((16, 16, 16, 8)):
            setattr(self, f"map_{i}", tblocks.Dense(6, w))
        self.res = tblocks.AdaResBlock(8)
        self.up = tblocks.AdaResBlockUp(8, 4)

    def forward(self, x, style):
        s = [getattr(self, f"map_{i}")(style) for i in range(4)]
        return self.up(self.res(x, s[0], s[1]), s[2], s[3])


def test_grad2_penalty_through_the_legacy_adain_blocks_matches_jax():
    """The penalty of a score through AdaResBlock and AdaResBlockUp, and the parameter
    gradients of its mean (AdaIN's double backward), against ``jax.grad`` of the same."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    style = rng.standard_normal((2, 6)).astype(np.float32)
    w = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    jmod = _JaxLegacyStack()
    variables = jmod.init(jax.random.PRNGKey(6), x, style)
    params = jax.tree.map(np.asarray, variables["params"])
    spectral = jax.tree.map(np.asarray, variables["spectral"])

    def jpenalty(p):
        def score(a, s):
            out = jmod.apply({"params": p, "spectral": spectral}, a, s)
            return jnp.sin(out * w).sum(axis=(1, 2, 3))[:, None]
        return jlosses.grad2_penalty(score, (x, style))

    want = np.asarray(jpenalty(params))
    want_grads = flax_to_state_dict(jax.grad(lambda p: jpenalty(p).mean())(params), {})
    mod = _TorchLegacyStack()
    load_flax(mod, params, spectral)
    tw = nchw(w)
    got = tlosses.grad2_penalty(
        lambda a, s: torch.sin(mod(a, s) * tw).sum(dim=(1, 2, 3))[:, None],
        (nchw(x), torch.from_numpy(style)))
    _close(got.detach(), want, grad=True)
    got.mean().backward()
    # the R1 rule of the train-step tests: 1e-3 of the tensor's largest entry plus 1e-6
    # of the stack's (the conv biases in front of AdaIN have an exactly zero gradient)
    player = max(np.abs(g).max() for g in want_grads.values())
    for k, p in mod.named_parameters():
        g, wg = p.grad.numpy(), want_grads[k]
        limit = 1e-3 * np.abs(wg).max() + 1e-6 * player
        assert np.abs(g - wg).max() <= limit, (k, np.abs(g - wg).max(), limit)


# ---- training utilities

def test_freeze_adam_and_accumulate_match_optax_over_three_steps():
    rng = np.random.default_rng(13)
    x = rng.standard_normal((5, 6)).astype(np.float32)
    y = rng.standard_normal((5, 4)).astype(np.float32)
    jmod = jblocks.ResMLP([6, 8, 4])
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(7), x)["params"])
    mask = jutils.freeze_mask(params, lambda path: path[0] == "linear")
    tx = jutils.freeze(optax.adam(1e-2), mask)
    opt_state = tx.init(params)
    jp, jema = params, params

    def loss(p):
        return jnp.square(jmod.apply({"params": p}, x) - y).sum()

    mod = tblocks.ResMLP([6, 8, 4])
    load_flax(mod, params, {})
    ema = copy.deepcopy(mod)
    tmask = tutils.freeze_mask(mod, lambda name: name.startswith("linear."))
    assert tmask == {k: True for k in ("linear.weight", "linear.bias")} | {
        k: False for k, _ in mod.named_parameters() if not k.startswith("linear.")}
    opt = tutils.freeze(lambda ps: torch.optim.Adam(ps, lr=1e-2), mod, tmask)
    frozen0 = {k: p.detach().clone() for k, p in mod.named_parameters() if tmask[k]}
    for _ in range(3):
        updates, opt_state = tx.update(jax.grad(loss)(jp), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        jema = jutils.accumulate(jema, jp, 0.9)
        opt.zero_grad()
        torch.square(mod(torch.from_numpy(x)) - torch.from_numpy(y)).sum().backward()
        opt.step()
        tutils.accumulate(ema, mod, 0.9)
    for tree, module in ((jp, mod), (jema, ema)):
        want = flax_to_state_dict(jax.tree.map(np.asarray, tree), {})
        for k, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    for k, p in mod.named_parameters():
        assert (p in opt.state) != tmask[k], k
        if tmask[k]:
            assert torch.equal(p.detach(), frozen0[k])


def test_accumulate_averages_parameters_and_leaves_buffers():
    """EMA over parameters only: the spectral u, v (buffers; the reference's
    ``spectral`` collection, not its params) keep the EMA module's own values."""
    module = tblocks.ResBlockD(4)
    tinit.init_module(module, torch.Generator().manual_seed(0))
    ema = copy.deepcopy(module)
    with torch.no_grad():
        for t in (*module.parameters(), *module.buffers()):
            t.add_(1.0)
    ema0 = copy.deepcopy(ema)
    tutils.accumulate(ema, module, 0.25)
    for e, p, e0 in zip(ema.parameters(), module.parameters(), ema0.parameters()):
        torch.testing.assert_close(e, 0.25 * e0 + 0.75 * p)
    for (k, b), b0 in zip(ema.named_buffers(), module.buffers()):
        torch.testing.assert_close(b, b0 - 1.0, msg=k)


def test_lin_interpolation_matches_jax():
    rng = np.random.default_rng(14)
    a, b = rng.standard_normal((2, 3, 4)).astype(np.float32)
    _close(tutils.lin_interpolation(torch.from_numpy(a), torch.from_numpy(b), 0.3),
           jutils.lin_interpolation(jnp.asarray(a), jnp.asarray(b), 0.3))
    got = tutils.lin_interpolation({"u": {"v": torch.from_numpy(a)}},
                                   {"u": {"v": torch.from_numpy(b)}}, 0.7)
    want = jutils.lin_interpolation({"u": {"v": jnp.asarray(a)}}, {"u": {"v": jnp.asarray(b)}},
                                    0.7)
    _close(got["u"]["v"], want["u"]["v"])


def test_num_parameters_of_both_players_match_jax():
    cfg = small_cfg()
    _, _, av, iv = init_jax_players(cfg)
    state = torch_state_from(cfg, av, iv)
    for module, tree in ((state.au, av), (state.im, iv)):
        assert tutils.num_parameters(module) == jutils.num_parameters(tree["params"])
        assert sum(b.numel() for b in module.buffers()) > 0  # u, v: not parameters


# ---- VoxCeleb preparation

def _fake_frames(vid_path, img_size, skip_frames=5):
    """A stand-in for ``vid_to_images``: frames drawn from the video's file name."""
    seed = zlib.crc32(os.path.basename(vid_path).encode())
    rng = np.random.default_rng(seed)
    return [Image.fromarray(rng.integers(0, 256, (img_size, img_size, 3), dtype=np.uint8))
            for _ in range(1 + seed % 4 + skip_frames % 2)]


def _tree(root):
    return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
            for d, _, files in os.walk(root) for f in files}


@pytest.mark.parametrize("layout", ["create_dataset", "id_vids_to_imgs",
                                    "id_largest_vid_to_imgs"])
def test_voxceleb_prep_layouts_match_jax(layout, tmp_path, monkeypatch):
    src = tmp_path / "mp4"
    for rel in ("id00012/abc/00001.mp4", "id00012/abc/00002.mp4", "id00012/xyz/00001.mp4",
                "id00034/qrs/00001.mp4", "id00034/qrs/notes.txt"):
        (src / rel).parent.mkdir(parents=True, exist_ok=True)
        (src / rel).write_bytes(b"")
    for mod in (jprep, tprep):
        monkeypatch.setattr(mod, "vid_to_images", _fake_frames)
    out = {}
    for side, mod in (("jax", jprep), ("torch", tprep)):
        dst = tmp_path / side
        if layout == "create_dataset":
            mod.create_dataset(str(src), str(dst), 8, skip_frames=3)
        else:
            getattr(mod, layout)(str(src / "id00012"), str(dst), 8, skip_frames=3)
        out[side] = _tree(dst)
    assert out["torch"] and out["torch"] == out["jax"]
    if layout == "create_dataset":
        assert sorted({os.path.dirname(k) for k in out["torch"]}) == [
            "id00012/0000", "id00012/0001", "id00012/0002", "id00034/0000"]


def test_voxceleb_prep_cli_writes_what_the_jax_cli_writes(tmp_path, monkeypatch):
    src = tmp_path / "mp4" / "id00001" / "vid"
    src.mkdir(parents=True)
    (src / "00001.mp4").write_bytes(b"")
    for mod in (jprep, tprep):
        monkeypatch.setattr(mod, "vid_to_images", _fake_frames)
    tprep.main(["--src_vid_ds_root", str(tmp_path / "mp4"), "--dst_img_ds_root",
                str(tmp_path / "torch"), "--img_size", "6"])
    args = tprep.build_parser().parse_args(["--src_vid_ds_root", str(tmp_path / "mp4"),
                                            "--dst_img_ds_root", str(tmp_path / "jax"),
                                            "--img_size", "6"])
    jprep.main(args)
    assert _tree(tmp_path / "torch") == _tree(tmp_path / "jax") != {}


def test_vid_to_images_decodes_a_video_as_the_jax_module_does(tmp_path):
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path / "v.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (24, 16))
    assert writer.isOpened()
    rng = np.random.default_rng(15)
    for _ in range(7):
        writer.write(rng.integers(0, 256, (16, 24, 3), dtype=np.uint8))
    writer.release()
    got = tprep.vid_to_images(path, 12, skip_frames=3)
    want = jprep.vid_to_images(path, 12, skip_frames=3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.size == (12, 12) and np.array_equal(np.asarray(g), np.asarray(w))
    assert tprep.vid_to_images(path, 32) == []  # narrower than img_size: skipped
