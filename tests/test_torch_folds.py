"""The reference's folds and split input in the port, against the Flax modules.

``SNConv(upscale=2)`` (the 2x upsample folded into a transposed stride-2
conv), ``SNConv(downscale=2)`` (the 2x2 pool folded into a stride-2 conv) and
an ``SNConv`` given a tuple of channel parts, each in f32 against the Flax
``SNConv`` with the same settings under the transplant: outputs rtol 1e-4 /
atol 1e-5, input and parameter gradients rtol 1e-3 / atol 1e-6 (``test_torch_blocks.py``'s
tolerances; atol times the gradient's largest magnitude where that is above
1: a weight gradient through sigma of size 30 holds entries near 0 that
carry f32 noise of 1e-5; an exactly zero gradient, of a bias that a norm
reads, within 1e-5 or 1e-6 of the module's largest gradient), and for ``downscale`` R1's pattern,
the parameter gradient of <grad_x <y, ct>, v>, against ``jax.grad`` of a
function of ``jax.grad``.  The split img2img input (after
``tests/test_split_gen_input.py``): ``ResBlockDown`` and
``Img2ImgDownModule`` given (a, b) against the Flax modules given (a, b), and
against the port given their concat.

Then the bf16 blocks against XLA's jitted compile of the Flax blocks on the
CPU: the share of bf16 outputs (the port's f32 sums rounded) equal to XLA's
is at least each case's bound, set under this test's seed-0 reading: 0.9619
to 1.0 for the blocks and ``Dense`` (bounds 0.99, 0.93 for the 9x9 up
block, 0.999 for ``Dense``); ``ResBlockDown`` given a bf16 input, as the
encoders' down blocks mostly are, reads 0.9990 and 0.9998 (bounds 0.99: the
port pools a bf16 input with bf16 sums, as the reference does; with an f32
sum, 0.6311 and 0.7202).  A bf16
block rounds at each conv and bias; with the reference's order of ops and its
folds the port rounds the same values as XLA does, and the outputs differ
only where the two convs sum their products in another order.  In the torch
order (conv then pool, upsample then conv, the bias inside the conv,
``Dense``'s bias rounded before the add) the port's roundings are
independent of XLA's: at these shapes 0.42-0.61 of the blocks' outputs
agree, and 0.88-0.95 of ``Dense``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimalstrategiesagainstgenerativeattacks_torch.models import image as tmodels
from optimalstrategiesagainstgenerativeattacks_torch.nn import blocks as tblocks
from optimalstrategiesagainstgenerativeattacks_torch.port.transplant import (
    flax_to_state_dict,
    load_flax,
)
from optimalstrategiesagainstgenerativeattacks_tpu.models import image as jmodels
from optimalstrategiesagainstgenerativeattacks_tpu.nn import blocks as jblocks
from test_torch_support import randomise_norms_and_gammas

torch.set_num_threads(1)

BF = jnp.bfloat16
T16 = torch.bfloat16


def _to_torch(a):
    t = torch.from_numpy(np.asarray(a))
    return t.permute(0, 3, 1, 2) if t.ndim == 4 else t


def _to_numpy(t):
    t = t.detach().float()
    return (t.permute(0, 2, 3, 1) if t.ndim == 4 else t).numpy()


def _variables(jmod, args, rng):
    v = jax.jit(jmod.init)(jax.random.PRNGKey(0), *args)
    params = randomise_norms_and_gammas(jax.tree.map(np.asarray, v["params"]), rng)
    return params, jax.tree.map(np.asarray, v.get("spectral", {}))


def _port_args(args, grad: bool = False):
    """The Flax arguments as the port's: NHWC arrays to NCHW leaves, tuples kept."""
    def leaf(a):
        return _to_torch(a).requires_grad_(grad)
    return [tuple(leaf(p) for p in a) if isinstance(a, tuple) else leaf(a) for a in args]


def _leaves(targs):
    return [t for a in targs for t in (a if isinstance(a, tuple) else (a,))]


def _close_grad(got, want, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-6 * max(1.0, float(np.abs(want).max())), err_msg=err_msg)


def _check_f32(jmod, tmod, args, rng, zero_grad=()):
    """Forward, input and parameter gradients of ``tmod`` against ``jmod`` in f32."""
    params, spectral = _variables(jmod, args, rng)
    state = {"params": params, "spectral": spectral}
    want = np.asarray(jmod.apply(state, *args))
    ct = rng.standard_normal(want.shape).astype(np.float32)

    def loss(p, *a):
        return (jmod.apply({"params": p, "spectral": spectral}, *a) * ct).sum()

    want_grads = jax.grad(loss, argnums=tuple(range(len(args) + 1)))(params, *args)
    load_flax(tmod, params, spectral)
    targs = _port_args(args, grad=True)
    out = tmod(*targs)
    np.testing.assert_allclose(_to_numpy(out), want, rtol=1e-4, atol=1e-5)
    (out * _to_torch(ct)).sum().backward()
    for t, w in zip(_leaves(targs), jax.tree.leaves(want_grads[1:]), strict=True):
        _close_grad(_to_numpy(t.grad), w)
    want_param_grads = flax_to_state_dict(want_grads[0], {})
    # an exactly zero gradient holds rounding noise of the module's largest sums
    noise = max(1e-5, 1e-6 * max(np.abs(np.asarray(w)).max() for w in want_param_grads.values()))
    for k, p in tmod.named_parameters():
        g, w = p.grad.numpy(), np.asarray(want_param_grads[k])
        if k in zero_grad:  # a norm reads the conv: rounding noise on both sides
            assert max(np.abs(g).max(), np.abs(w).max()) < noise, k
        else:
            _close_grad(g, w, k)
    return params, spectral, out


def _parts(rng, shape, channels):
    return tuple(rng.standard_normal((*shape, c)).astype(np.float32) for c in channels)


# name: (Flax SNConv, port SNConv, input NHWC or channel parts)
SNCONV_CASES = {
    "upscale 3x3": (lambda: jblocks.SNConv(6, 3, padding=1, upscale=2),
                    lambda: tblocks.SNConv(5, 6, 3, 1, upscale=2), (2, 4, 4, 5)),
    "upscale 9x9 to one channel": (lambda: jblocks.SNConv(1, 9, padding=4, upscale=2),
                                   lambda: tblocks.SNConv(4, 1, 9, 4, upscale=2), (2, 4, 4, 4)),
    "upscale from 1x1": (lambda: jblocks.SNConv(4, 3, padding=1, upscale=2),
                         lambda: tblocks.SNConv(6, 4, 3, 1, upscale=2), (3, 1, 1, 6)),
    "downscale 3x3": (lambda: jblocks.SNConv(6, 3, padding=1, downscale=2),
                      lambda: tblocks.SNConv(5, 6, 3, 1, downscale=2), (2, 8, 8, 5)),
    "downscale 9x9": (lambda: jblocks.SNConv(4, 9, padding=4, downscale=2),
                      lambda: tblocks.SNConv(2, 4, 9, 4, downscale=2), (2, 8, 8, 2)),
    "downscale to 1x1": (lambda: jblocks.SNConv(4, 3, padding=1, downscale=2),
                         lambda: tblocks.SNConv(3, 4, 3, 1, downscale=2), (2, 2, 2, 3)),
    "tuple 3x3": (lambda: jblocks.SNConv(7, 3, padding=1),
                  lambda: tblocks.SNConv(5, 7, 3, 1), ((3, 8, 8), (2, 3))),
    "tuple 9x9 of one-channel parts": (lambda: jblocks.SNConv(8, 9, padding=4),
                                       lambda: tblocks.SNConv(2, 8, 9, 4), ((2, 8, 8), (1, 1))),
    "tuple 1x1": (lambda: jblocks.SNConv(8, 1, padding=0),
                  lambda: tblocks.SNConv(2, 8, 1, 0), ((2, 4, 4), (1, 1))),
}


def _snconv_input(spec, rng):
    if isinstance(spec[1], tuple):
        return _parts(rng, *spec)
    return rng.standard_normal(spec).astype(np.float32)


@pytest.mark.parametrize("name", list(SNCONV_CASES))
def test_snconv_fold_matches_flax_f32(name):
    make_flax, make_torch, spec = SNCONV_CASES[name]
    rng = np.random.default_rng(len(name))
    _check_f32(make_flax(), make_torch(), [_snconv_input(spec, rng)], rng)


@pytest.mark.parametrize("conv_size,padding,hw", [(3, 1, 8), (9, 4, 8), (3, 1, 2)])
def test_snconv_downscale_double_backward_matches_flax(conv_size, padding, hw):
    """R1's pattern through the folded stride-2 conv: d/dW <grad_x <conv(x), ct>, v>."""
    rng = np.random.default_rng(conv_size + hw)
    x = rng.standard_normal((2, hw, hw, 3)).astype(np.float32)
    jmod = jblocks.SNConv(4, conv_size, padding=padding, downscale=2)
    params, spectral = _variables(jmod, [x], rng)
    ct = rng.standard_normal((2, hw // 2, hw // 2, 4)).astype(np.float32)
    v = rng.standard_normal(x.shape).astype(np.float32)

    def inner(p, a):
        return (jmod.apply({"params": p, "spectral": spectral}, a) * ct).sum()

    def outer(p, a):
        return (jax.grad(inner, argnums=1)(p, a) * v).sum()

    want = flax_to_state_dict(jax.grad(outer)(params, x), {})
    tmod = tblocks.SNConv(3, 4, conv_size, padding, downscale=2)
    load_flax(tmod, params, spectral)
    tx = _to_torch(x).requires_grad_(True)
    (gx,) = torch.autograd.grad((tmod(tx) * _to_torch(ct)).sum(), tx, create_graph=True)
    (gx * _to_torch(v)).sum().backward()
    _close_grad(tmod.weight.grad.numpy(), want["weight"])
    assert tmod.bias.grad is None and not np.asarray(want["bias"]).any()


# name: (Flax module, port module, parts' shape, their channels, biases an instance norm
# reads: exactly zero gradients, rounding noise on both sides)
SPLIT_CASES = {
    "ResBlockDown": (lambda: jblocks.ResBlockDown(16, conv_size=3, padding=1),
                     lambda: tblocks.ResBlockDown(5, 16, 3, 1), (3, 8, 8), (2, 3), ()),
    "ResBlockDown9x9": (lambda: jblocks.ResBlockDown(16, conv_size=9, padding=4),
                        lambda: tblocks.ResBlockDown(2, 16, 9, 4), (2, 16, 16), (1, 1), ()),
    "Img2ImgDownModule": (lambda: jmodels.Img2ImgDownModule(img_size=16, img_channels=2,
                                                            style_dim=32),
                          lambda: tmodels.Img2ImgDownModule(16, 2, 32), (2, 16, 16), (1, 1),
                          ("att.conv_f.bias",)  # a constant over the softmax's axis
                          + tuple(f"down_{i}.{c}.bias" for i in range(2)
                                  for c in ("conv_l1", "conv_r2"))),
}


@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_split_input_matches_flax_and_the_concat(name):
    make_flax, make_torch, shape, channels, zero_grad = SPLIT_CASES[name]
    rng = np.random.default_rng(len(name) + 7)
    parts = _parts(rng, shape, channels)
    tmod = make_torch()
    _, _, out = _check_f32(make_flax(), tmod, [parts], rng, zero_grad)
    with torch.no_grad():
        cat = tmod(torch.cat([_to_torch(p) for p in parts], dim=1))
    torch.testing.assert_close(cat, out.detach(), rtol=1e-5, atol=1e-5)


def test_impersonator_split_input_equals_the_concat():
    """The impersonator gives img2img the (env_img, leaked) pair; img2img on the pair
    and on its channel concat agree in f32 (the untrained generator's norms amplify
    the sums' orders, as in ``test_split_gen_input.py``)."""
    im = tmodels.get_im(img_size=16, img_channels=1, style_dim=32)
    gen = torch.Generator().manual_seed(3)
    for m in im.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    seen = {}
    im.img2img.register_forward_hook(lambda mod, args, out: seen.update(args=args, out=out))
    leaked = torch.randn(2, 1, 16, 16, 1, generator=gen)
    z = torch.randn(2, 3, 32, generator=gen)
    with torch.no_grad():
        out = im(leaked, 3, z=z)
        pair, style = seen["args"]
        cat = im.img2img(torch.cat(pair, 1), style)
    assert out.shape == (2, 3, 16, 16, 1) and torch.isfinite(out).all()
    assert isinstance(pair, tuple) and [p.shape[1] for p in pair] == [1, 1]
    torch.testing.assert_close(pair[1], leaked[:, 0].permute(0, 3, 1, 2).repeat_interleave(3, 0))
    torch.testing.assert_close(seen["out"], cat, rtol=1e-3, atol=1e-3)


# --- bf16 against XLA's compile ------------------------------------------------------------

# name: (Flax block, port block, input shapes, least share of outputs equal to XLA's).
# The inputs are bf16, except for the ResBlockDown cases not named "bf16 input": those
# read f32.  The reference pools a bf16 input with bf16 sums, rounding each (a reduce
# in the input's dtype), and so does the port (ops/image_ops.py:Bf16Pool): given bf16,
# as the encoders' down blocks mostly read, a ResBlockDown reads 0.9990 (3x3) and
# 0.9998 (9x9, split) equal to XLA's compile; with F.avg_pool2d's f32 sum, 0.6311 and
# 0.7202 (scripts/torch_bf16_pool_readings.py blocks).
BF16_CASES = {
    "ResBlockDown 32->64 @16": (lambda: jblocks.ResBlockDown(64, dtype=BF),
                                lambda: tblocks.ResBlockDown(32, 64, dtype=T16),
                                [(2, 16, 16, 32)], 0.99),
    "ResBlockDown 9x9 split 1+1->64 @16": (
        lambda: jblocks.ResBlockDown(64, conv_size=9, padding=4, dtype=BF),
        lambda: tblocks.ResBlockDown(2, 64, 9, 4, dtype=T16), [((2, 16, 16), (1, 1))], 0.99),
    "ResBlockDown 32->64 @16 bf16 input": (lambda: jblocks.ResBlockDown(64, dtype=BF),
                                           lambda: tblocks.ResBlockDown(32, 64, dtype=T16),
                                           [(2, 16, 16, 32)], 0.99),
    "ResBlockDown 9x9 split 1+1->64 @16 bf16 input": (
        lambda: jblocks.ResBlockDown(64, conv_size=9, padding=4, dtype=BF),
        lambda: tblocks.ResBlockDown(2, 64, 9, 4, dtype=T16), [((2, 16, 16), (1, 1))], 0.99),
    "ResBlockUp 64->32 @4": (lambda: jblocks.ResBlockUp(32, dtype=BF),
                             lambda: tblocks.ResBlockUp(64, 32, dtype=T16),
                             [(2, 4, 4, 64)], 0.99),
    "ResBlockUp 32->1 @8": (lambda: jblocks.ResBlockUp(1, dtype=BF),
                            lambda: tblocks.ResBlockUp(32, 1, dtype=T16),
                            [(4, 8, 8, 32)], 0.99),
    "AdaResBlockUp2 64->32 @4": (lambda: jblocks.AdaResBlockUp2(64, 32, dtype=BF),
                                 lambda: tblocks.AdaResBlockUp2(64, 32, 32, dtype=T16),
                                 [(2, 4, 4, 64), (2, 32)], 0.99),
    "AdaResBlockUp2 9x9 32->1 @8": (
        lambda: jblocks.AdaResBlockUp2(32, 1, conv_size=9, padding=4, dtype=BF),
        lambda: tblocks.AdaResBlockUp2(32, 1, 32, 9, 4, dtype=T16),
        [(4, 8, 8, 32), (4, 32)], 0.93),
    "AdaResBlock2 64 @4": (lambda: jblocks.AdaResBlock2(64, 32, dtype=BF),
                           lambda: tblocks.AdaResBlock2(64, 32, dtype=T16),
                           [(2, 4, 4, 64), (2, 32)], 0.99),
    "Dense 256->256": (lambda: jblocks.Dense(256, dtype=BF),
                       lambda: tblocks.Dense(256, 256, dtype=T16), [(128, 256)], 0.999),
    "Dense 32->256": (lambda: jblocks.Dense(256, dtype=BF),
                      lambda: tblocks.Dense(32, 256, dtype=T16), [(128, 32)], 0.999),
}


def equal_share(name: str, seed: int = 0) -> float:
    """The share of the port's bf16 outputs equal to XLA's compile of the Flax block."""
    make_flax, make_torch, shapes, _ = BF16_CASES[name]
    rng = np.random.default_rng(seed)
    args = [_parts(rng, *s) if isinstance(s[1], tuple) else
            rng.standard_normal(s).astype(np.float32) for s in shapes]
    bf16_in = not name.startswith("ResBlockDown") or name.endswith("bf16 input")
    if bf16_in:
        args = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, BF)), args)
    jmod = make_flax()
    params, spectral = _variables(jmod, args, rng)
    state = {"params": params, **({"spectral": spectral} if spectral else {})}
    want = np.asarray(jax.jit(jmod.apply)(state, *args)).astype(np.float32)
    tmod = make_torch()
    load_flax(tmod, params, spectral)
    targs = _port_args(jax.tree.map(lambda a: a.astype(np.float32), args))
    if bf16_in:
        targs = jax.tree.map(lambda t: t.to(T16), targs)
    with torch.no_grad():
        got = _to_numpy(tmod(*targs).to(T16))
    assert got.shape == want.shape
    return float(np.mean(got == want))


@pytest.mark.parametrize("name", list(BF16_CASES))
def test_bf16_block_rounds_where_xla_does(name):
    share = equal_share(name)
    assert share >= BF16_CASES[name][3], f"{name}: {share:.4f} of the outputs equal XLA's"
