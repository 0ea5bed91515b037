"""Port blocks against their Flax twins under the transplant, forward and gradients.

Each block is initialised by Flax, its norms, attention gamma and constant
input image are given random values, and the weights are carried into the
port; the port's weights carried back give the Flax trees again.  Outputs
rtol 1e-4 / atol 1e-5; input and parameter gradients rtol 1e-3 / atol 1e-6
(f32).  A conv bias that feeds an instance norm or AdaIN has an exactly zero
gradient (the norm removes any per-channel constant); both sides then hold
rounding noise, which must stay below 1e-5.

The StyleGAN blocks run with and without their noise layers; with them, the
weights stay at their zero init and both sides get the same noise, drawn from
each layer's path (a Flax method interceptor on one side, a forward pre-hook
on the other), so the noise weights' gradients are held too.  ``NoiseLayer``
alone runs with random weights and explicit noise.

``conv_one_channel``, the card's path for a conv of one channel to one
channel (cuDNN gets those wrong in bf16), equals ``F.conv2d`` in f64,
forward and backward, to 1e-12.
"""

import zlib

import jax
import numpy as np
import pytest
import torch
from flax import linen as fnn

from optimalstrategiesagainstgenerativeattacks_torch.nn import blocks as tblocks
from optimalstrategiesagainstgenerativeattacks_torch.port.transplant import (
    flax_to_state_dict,
    load_flax,
    state_dict_to_flax,
)
from optimalstrategiesagainstgenerativeattacks_tpu.nn import blocks as jblocks
from test_torch_support import randomise_norms_and_gammas

torch.set_num_threads(1)


def _sg(name, make_flax, make_torch, shapes):
    """A StyleGAN block's two cases: without noise layers, and with them."""
    return {f"{name}{tag}": (lambda: make_flax(use_noise=noise),
                             lambda: make_torch(use_noise=noise), shapes)
            for tag, noise in (("", False), ("_noise", True))}


# name: (flax block, port block, input shapes: 4-D NHWC images, others as they are)
CASES = {
    "SelfAttention": (lambda: jblocks.SelfAttention(), lambda: tblocks.SelfAttention(16),
                      [(2, 4, 4, 16)]),
    "ResBlockDown": (lambda: jblocks.ResBlockDown(8), lambda: tblocks.ResBlockDown(4, 8),
                     [(2, 8, 8, 4)]),
    "ResBlockDown9x9": (lambda: jblocks.ResBlockDown(8, conv_size=9, padding=4),
                        lambda: tblocks.ResBlockDown(2, 8, conv_size=9, padding=4),
                        [(2, 8, 8, 2)]),
    "ResBlockUp": (lambda: jblocks.ResBlockUp(4), lambda: tblocks.ResBlockUp(8, 4),
                   [(2, 4, 4, 8)]),
    "AdaResBlock2": (lambda: jblocks.AdaResBlock2(8, 6), lambda: tblocks.AdaResBlock2(8, 6),
                     [(2, 4, 4, 8), (2, 6)]),
    "AdaResBlockUp2": (lambda: jblocks.AdaResBlockUp2(8, 4),
                       lambda: tblocks.AdaResBlockUp2(8, 4, 6), [(2, 4, 4, 8), (2, 6)]),
    "AdaResBlock": (lambda: jblocks.AdaResBlock(), lambda: tblocks.AdaResBlock(8),
                    [(2, 4, 4, 8), (2, 16), (2, 16)]),
    "ResBlockD": (lambda: jblocks.ResBlockD(), lambda: tblocks.ResBlockD(8), [(2, 4, 4, 8)]),
    "AdaResBlockUp": (lambda: jblocks.AdaResBlockUp(4), lambda: tblocks.AdaResBlockUp(8, 4),
                      [(2, 4, 4, 8), (2, 16), (2, 8)]),
    "AdaResBlockUp9x9": (lambda: jblocks.AdaResBlockUp(1, conv_size=9, padding=4),
                         lambda: tblocks.AdaResBlockUp(4, 1, conv_size=9, padding=4),
                         [(2, 4, 4, 4), (2, 8), (2, 2)]),
    "ResMLP": (lambda: jblocks.ResMLP([8, 16, 6]), lambda: tblocks.ResMLP([8, 16, 6]),
               [(3, 8)]),
    "ResMLP2": (lambda: jblocks.ResMLP2([8, 16, 6]), lambda: tblocks.ResMLP2([8, 16, 6]),
                [(3, 8)]),
    "StyleMod": (lambda: jblocks.StyleMod(), lambda: tblocks.StyleMod(8, 6),
                 [(2, 4, 4, 8), (2, 6)]),
    "StyleEstimator": (lambda: jblocks.StyleEstimator(6), lambda: tblocks.StyleEstimator(8, 6),
                       [(2, 4, 4, 8)]),
    **_sg("SGInputBlock", lambda **kw: jblocks.SGInputBlock(8, **kw),
          lambda **kw: tblocks.SGInputBlock(8, 6, **kw), [(2, 4, 4, 8), (2, 6), (2, 6)]),
    **_sg("SGConstInputBlock", lambda **kw: jblocks.SGConstInputBlock(8, 4, **kw),
          lambda **kw: tblocks.SGConstInputBlock(8, 4, 6, **kw), [(2, 6), (2, 6)]),
    **_sg("SGDecoderBlock", lambda **kw: jblocks.SGDecoderBlock(4, **kw),
          lambda **kw: tblocks.SGDecoderBlock(8, 4, 6, **kw), [(2, 4, 4, 8), (2, 6), (2, 6)]),
    "SGDecoderBlockPixelNorm": (
        lambda: jblocks.SGDecoderBlock(4, use_pixel_norm=True, use_instance_norm=False),
        lambda: tblocks.SGDecoderBlock(8, 4, 6, use_pixel_norm=True, use_instance_norm=False),
        [(2, 4, 4, 8), (2, 6), (2, 6)]),
    "SGToImgBlock": (lambda: jblocks.SGToImgBlock(1), lambda: tblocks.SGToImgBlock(8, 1),
                     [(2, 4, 4, 8)]),
    "SGFromImgBlock": (lambda: jblocks.SGFromImgBlock(8), lambda: tblocks.SGFromImgBlock(1, 8),
                       [(2, 4, 4, 1)]),
    "SGEncoderBlock": (lambda: jblocks.SGEncoderBlock(8, 4, 6),
                       lambda: tblocks.SGEncoderBlock(3, 8, 4, 6), [(2, 8, 8, 3)]),
    "SGDisBlock": (lambda: jblocks.SGDisBlock(8, 4), lambda: tblocks.SGDisBlock(3, 8, 4),
                   [(2, 8, 8, 3)]),
}

ZERO_GRAD = {
    "ResBlockUp": {"conv_r1.bias"},
    "AdaResBlock2": {"conv1.bias", "conv2.bias"},
    "AdaResBlockUp2": {"conv_r1.bias"},
    "AdaResBlock": {"conv1.bias", "conv2.bias"},
    "ResBlockD": {"conv1.bias", "conv2.bias"},
    "AdaResBlockUp": {"conv_r1.bias"},
    "AdaResBlockUp9x9": {"conv_r1.bias"},
}


def _one_signed_channels(params):
    """Channels of the constant input image whose pixels all have one sign: the lrelu
    is linear there, and the instance norm after it removes the bias."""
    x = params["init_img"] + params["bias"]
    return (x > 0).all(axis=(0, 1, 2)) | (x < 0).all(axis=(0, 1, 2))


# entries of a gradient that are exactly zero, as in ZERO_GRAD: name -> {param: mask}
ZERO_GRAD_ENTRIES = {name: {"bias": _one_signed_channels}
                     for name in ("SGConstInputBlock", "SGConstInputBlock_noise")}


def _to_torch(a):
    t = torch.from_numpy(a)
    return t.permute(0, 3, 1, 2) if a.ndim == 4 else t


def _to_numpy(t):
    t = t.detach()
    return (t.permute(0, 2, 3, 1) if t.ndim == 4 else t).numpy()


def _noise(path, b, h, w):
    """A noise layer's noise [B, H, W, 1], drawn from its path."""
    rng = np.random.default_rng(zlib.crc32("/".join(path).encode()))
    return rng.standard_normal((b, h, w, 1)).astype(np.float32)


def _inject_flax_noise(next_fun, args, kwargs, context):
    if isinstance(context.module, jblocks.NoiseLayer) and context.method_name == "__call__":
        kwargs = dict(kwargs, noise=_noise(context.module.path, *args[0].shape[:3]))
    return next_fun(*args, **kwargs)


def _inject_torch_noise(module):
    def hook(name):
        def inject(mod, args, kwargs):
            b, _, h, w = args[0].shape
            return args, dict(kwargs, noise=_to_torch(_noise(name.split("."), b, h, w)))
        return inject

    for name, m in module.named_modules():
        if isinstance(m, tblocks.NoiseLayer):
            m.register_forward_pre_hook(hook(name), with_kwargs=True)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("name", list(CASES))
def test_block_matches_flax_forward_and_grads(name):
    make_flax, make_torch, shapes = CASES[name]
    rng = np.random.default_rng(len(name))
    inputs = [rng.standard_normal(shape).astype(np.float32) for shape in shapes]
    jblk = make_flax()
    with fnn.intercept_methods(_inject_flax_noise):
        variables = jblk.init(jax.random.PRNGKey(0), *inputs)
        params = randomise_norms_and_gammas(jax.tree.map(np.asarray, variables["params"]), rng)
        spectral = jax.tree.map(np.asarray, variables.get("spectral", {}))
        state = {"params": params, "spectral": spectral}
        outs = jax.eval_shape(lambda *a: jblk.apply(state, *a), *inputs)
        cts = [rng.standard_normal(o.shape).astype(np.float32)
               for o in jax.tree.leaves(outs)]

        def loss(p, *a):
            got = jax.tree.leaves(jblk.apply({"params": p, "spectral": spectral}, *a))
            return sum((o * ct).sum() for o, ct in zip(got, cts))

        want_outs = [np.asarray(o) for o in jax.tree.leaves(jblk.apply(state, *inputs))]
        want_grads = jax.grad(loss, argnums=tuple(range(len(inputs) + 1)))(params, *inputs)
    want_param_grads = flax_to_state_dict(want_grads[0], {})

    blk = make_torch()
    load_flax(blk, params, spectral)
    back_params, back_spectral = state_dict_to_flax(blk.state_dict())
    for tree, back in ((params, back_params), (spectral, back_spectral)):
        want_flat, got_flat = dict(_flat(tree)), dict(_flat(back))
        assert set(got_flat) == set(want_flat)
        for k, v in want_flat.items():
            np.testing.assert_array_equal(got_flat[k], v, err_msg="/".join(k))
    _inject_torch_noise(blk)
    targs = [_to_torch(a).requires_grad_(True) for a in inputs]
    outs = blk(*targs)
    outs = list(outs) if isinstance(outs, tuple) else [outs]
    for got, want in zip(outs, want_outs, strict=True):
        np.testing.assert_allclose(_to_numpy(got), want, rtol=1e-4, atol=1e-5)
    sum((o * _to_torch(ct)).sum() for o, ct in zip(outs, cts)).backward()

    for t, w in zip(targs, want_grads[1:], strict=True):
        np.testing.assert_allclose(_to_numpy(t.grad), np.asarray(w), rtol=1e-3, atol=1e-6)
    got_param_grads = {k: p.grad.numpy() for k, p in blk.named_parameters()}
    assert set(got_param_grads) == set(want_param_grads)
    for k, g in got_param_grads.items():
        w = want_param_grads[k]
        if k in ZERO_GRAD.get(name, ()):
            assert max(np.abs(g).max(), np.abs(w).max()) < 1e-5, k
            continue
        zero = ZERO_GRAD_ENTRIES.get(name, {}).get(k)
        if zero is not None:
            m = zero(params)
            assert m.any() and max(np.abs(g[m]).max(), np.abs(w[m]).max()) < 1e-5, k
            g, w = g[~m], w[~m]
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-6, err_msg=k)


def test_noise_layer_matches_flax_with_random_weights_and_explicit_noise():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 5, 6)).astype(np.float32)
    noise = rng.standard_normal((2, 4, 5, 1)).astype(np.float32)
    weight = rng.standard_normal(6).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    jlayer = jblocks.NoiseLayer()
    params = {"weight": weight}
    want = np.asarray(jlayer.apply({"params": params}, x, noise))
    want_grads = jax.grad(lambda p, a: (jlayer.apply({"params": p}, a, noise) * ct).sum(),
                          argnums=(0, 1))(params, x)
    layer = tblocks.NoiseLayer(6)
    load_flax(layer, params, {})
    tx = _to_torch(x).requires_grad_(True)
    out = layer(tx, noise=_to_torch(noise))
    np.testing.assert_allclose(_to_numpy(out), want, rtol=1e-5, atol=1e-6)
    (out * _to_torch(ct)).sum().backward()
    np.testing.assert_allclose(_to_numpy(tx.grad), np.asarray(want_grads[1]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(layer.weight.grad.numpy(), np.asarray(want_grads[0]["weight"]),
                               rtol=1e-4, atol=1e-5)


def test_noise_layer_draws_from_the_generator():
    """The noise is the generator's draw of [B, 1, H, W], shared by the channels; at its
    zero init, the layer is the identity."""
    layer = tblocks.NoiseLayer(3)
    with torch.no_grad():
        layer.weight.fill_(1.0)
    x = torch.zeros(2, 3, 4, 4)
    out = layer(x, generator=torch.Generator().manual_seed(5))
    want = torch.randn((2, 1, 4, 4), generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(out, want.expand(2, 3, 4, 4), rtol=0, atol=0)
    layer.reset_parameters(torch.Generator())
    torch.testing.assert_close(layer(x + 1.5), x + 1.5, rtol=0, atol=0)


@pytest.mark.parametrize("shape,k,padding", [((6, 1, 16, 16), 3, 1), ((4, 1, 8, 8), 9, 4),
                                             ((3, 1, 5, 7), 1, 0)])
def test_conv_one_channel_equals_conv2d(shape, k, padding):
    gen = torch.Generator().manual_seed(k)
    args = [torch.randn(s, generator=gen, dtype=torch.float64, requires_grad=True)
            for s in (shape, (1, 1, k, k), (1,))]
    got = tblocks.conv_one_channel(*args, padding)
    want = torch.nn.functional.conv2d(*args, padding=padding)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    cot = torch.randn(want.shape, generator=gen, dtype=torch.float64)
    for g, w in zip(torch.autograd.grad(got, args, cot), torch.autograd.grad(want, args, cot)):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-12)
