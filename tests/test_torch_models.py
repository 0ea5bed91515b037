"""Port players against the JAX reference players under the transplant.

Small config (img 16, style 32, B=2, m1 n2 k2), the reference's default
stacked layouts (encoder pair, scanned AdaIN blocks), norms and attention
gammas randomised.  f32: au logits rtol 1e-4 / atol 1e-5; the im fake
(injected z, tanh-bounded, ~30 convs and norms deep) rtol 1e-4 / atol 5e-5.

bf16 (both sides cast convs and linears to bf16, rounding at different
places): au logits rtol / atol 5e-2.  The fake is not compared pixel by
pixel there: the reference's own bf16 fake already sits up to ~0.3 from its
f32 fake at this size (AdaIN divides by small per-channel stds).  Instead
the port's bf16 fake must be no further from the f32 reference than the
reference's bf16 fake is: in mean within a factor of 1.5 of the reference
as XLA compiles it by default, and in max within a factor of 1 of the
reference compiled with every bf16 rounding its code writes (XLA's
``xla_allow_excess_precision`` off).  By default XLA may keep fused
intermediates in f32 and skip roundings, such as the attention core's P
rounded to bf16, that the port, rounding after each PyTorch op, makes; the
max follows the few pixels where such a rounding is amplified.  The two
fakes that round alike agree to 3e-2 in mean absolute difference.
``scripts/torch_bf16_fake_readings.py`` prints the readings under both
references.
"""

import jax
import numpy as np
import pytest
import torch

from optimalstrategiesagainstgenerativeattacks_torch.port.transplant import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg
from test_torch_support import init_jax_players, jax_build, small_cfg, torch_state_from

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def players():
    cfg = small_cfg()
    jau, jim, av, iv = init_jax_players(cfg)
    return cfg, jau, jim, av, iv, torch_state_from(cfg, av, iv)


@pytest.fixture(scope="module")
def inputs(players):
    cfg = players[0]
    rng = np.random.default_rng(1)
    s = cfg.img_size

    def imgs(n):
        return rng.uniform(-1, 1, (cfg.batch_size, n, s, s, 1)).astype(np.float32)

    z = rng.standard_normal((cfg.batch_size, cfg.n, cfg.style_dim)).astype(np.float32)
    return imgs(cfg.n), imgs(cfg.k), imgs(cfg.m), z


@pytest.mark.parametrize("player", ["au", "im"])
def test_transplant_round_trip(players, player):
    _, _, _, av, iv, state = players
    v = av if player == "au" else iv
    module = state.au if player == "au" else state.im
    params, spectral = state_dict_to_flax(module.state_dict())
    assert jax.tree.structure(params) == jax.tree.structure(v["params"])
    assert jax.tree.structure(spectral) == jax.tree.structure(v["spectral"])
    for a, b in zip(jax.tree.leaves((params, spectral)), jax.tree.leaves((v["params"], v["spectral"]))):
        np.testing.assert_array_equal(a, b)
    back = flax_to_state_dict(params, spectral)
    for k, t in module.state_dict().items():
        np.testing.assert_array_equal(back[k], t.numpy())


@pytest.mark.parametrize("player", ["au", "im"])
def test_parameter_counts_match(players, player):
    _, _, _, av, iv, state = players
    v = av if player == "au" else iv
    module = state.au if player == "au" else state.im
    assert sum(p.numel() for p in module.parameters()) == sum(
        a.size for a in jax.tree.leaves(v["params"]))
    assert sum(b.numel() for b in module.buffers()) == sum(
        a.size for a in jax.tree.leaves(v["spectral"]))


def test_au_logits_match_jax_f32(players, inputs):
    _, jau, _, av, _, state = players
    test, si, _, _ = inputs
    want = np.asarray(jau.apply(av, test, si))
    with torch.no_grad():
        got = state.au(torch.from_numpy(test), torch.from_numpy(si)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_im_fake_matches_jax_f32(players, inputs):
    cfg, _, jim, _, iv, state = players
    _, _, leaked, z = inputs
    want = np.asarray(jim.apply(iv, leaked, cfg.n, True, False, z=z))
    with torch.no_grad():
        got = state.im(torch.from_numpy(leaked), cfg.n, True, z=torch.from_numpy(z)).numpy()
    assert got.shape == (cfg.batch_size, cfg.n, cfg.img_size, cfg.img_size, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-5)


def _apply_as_written(module, *args, **kwargs):
    """``module.apply`` compiled with every bf16 rounding the JAX code writes."""
    lowered = jax.jit(lambda: module.apply(*args, **kwargs)).lower()
    return lowered.compile(compiler_options={"xla_allow_excess_precision": False})()


def test_bf16_players_match_jax(players, inputs):
    cfg, _, _, av, iv, _ = players
    test, si, leaked, z = inputs
    cfg16 = small_cfg(compute_dtype="bfloat16")
    jau, jim = jax_build(cfg16)
    state = torch_state_from(cfg16, av, iv)
    f32_fake = np.asarray(players[2].apply(iv, leaked, cfg.n, True, False, z=z))
    default_fake = np.asarray(jim.apply(iv, leaked, cfg.n, True, False, z=z)).astype(np.float32)
    want_fake = np.asarray(_apply_as_written(jim, iv, leaked, cfg.n, True, False, z=z)).astype(
        np.float32)
    want_logits = np.asarray(jau.apply(av, test, si)).astype(np.float32)
    with torch.no_grad():
        fake = state.im(torch.from_numpy(leaked).bfloat16(), cfg.n, True, z=torch.from_numpy(z))
        logits = state.au(torch.from_numpy(test).bfloat16(), torch.from_numpy(si).bfloat16())
    assert fake.dtype == torch.bfloat16
    fake = fake.float().numpy()
    assert np.abs(fake - want_fake).mean() < 3e-2
    port_err = np.abs(fake - f32_fake)
    assert port_err.mean() <= 1.5 * np.abs(default_fake - f32_fake).mean()
    assert port_err.max() <= np.abs(want_fake - f32_fake).max()
    np.testing.assert_allclose(logits.float().numpy(), want_logits, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("in1_bias", [0.01, 0.05, 0.3, 1.0])
def test_bf16_env_decoder_second_norm_drops_the_input_as_in_exact_arithmetic(in1_bias):
    """The env decoder's first block takes a 1x1 input: its in1 sees one pixel, so
    its right branch is the same for every input, and its skip branch is
    spatially constant.  The second block's in1 subtracts that constant, so in
    exact arithmetic its output does not depend on the input at all.  In bf16 the
    first block's sum must reach that norm unrounded: rounded, its rounding error,
    which differs with every input, is what the norm scales up (the bf16 game then
    trained to another equilibrium in the hard-glyph head-to-head)."""
    from optimalstrategiesagainstgenerativeattacks_torch.nn.init import init_module

    cfg = small_cfg(compute_dtype="bfloat16")
    _, im = timg.build_models(cfg)
    init_module(im, torch.Generator().manual_seed(0))
    dec = im.env_decoder
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        # a bias as training moves it: the right branch then varies over the pixels
        dec.up_0.in1.bias.copy_(in1_bias * torch.randn(dec.up_0.in1.bias.shape, generator=gen))
        common = 3.0 * torch.randn(1, cfg.style_dim, generator=gen)
        x = (common + 1e-2 * torch.randn(8, cfg.style_dim, generator=gen)).to(torch.bfloat16)
        normed = dec.up_1.in1(dec.up_0(x[:, :, None, None])).float()
    assert (normed - normed[:1]).abs().max() <= 1e-3 * normed.abs().max()


def test_build_models_rejects_unported_options():
    # every model option of the reference is ported: use_img_att builds img_att ...
    _, im = timg.build_models(small_cfg(use_img_att=True))
    assert hasattr(im, "img_att")
    assert not hasattr(timg.build_models(small_cfg())[1], "img_att")
    # ... and a compute dtype the reference does not have is refused
    with pytest.raises(ValueError):
        timg.build_models(small_cfg(compute_dtype="float16"))
