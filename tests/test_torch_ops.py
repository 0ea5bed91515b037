"""Port ops against the JAX reference ops, on the CPU (plain versions of the kernels).

Inputs come from numpy seeds and go to both sides.  Tolerances (f32):
AdaIN forward and gradients atol 1e-5 / rtol 1e-4 (the reference takes the
variance as s2 - n mu^2, the port two-pass); the other ops atol 1e-6 /
rtol 1e-5; the attention core atol 1e-5 / rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from optimalstrategiesagainstgenerativeattacks_torch.kernels import adain as kadain
from optimalstrategiesagainstgenerativeattacks_torch.kernels.adain import (
    ada_in,
    ada_in_bwd_ref,
    ada_in_ref,
)
from optimalstrategiesagainstgenerativeattacks_torch.kernels.attention import (
    attention_core,
    attention_core_bwd,
    attention_core_ref,
)
from optimalstrategiesagainstgenerativeattacks_torch.ops import adain as tadain
from optimalstrategiesagainstgenerativeattacks_torch.ops import image_ops as tio
from optimalstrategiesagainstgenerativeattacks_torch.ops import stats as tstats
from optimalstrategiesagainstgenerativeattacks_tpu.ops import adain as jadain
from optimalstrategiesagainstgenerativeattacks_tpu.ops import image_ops as jio
from optimalstrategiesagainstgenerativeattacks_tpu.ops import stats as jstats

torch.set_num_threads(1)


def nchw(a):
    """numpy NHWC -> torch NCHW (channels_last memory, as inside the port)."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _adain_case(shape, seed):
    rng = np.random.default_rng(seed)
    b, h, w, c = shape
    x = rng.standard_normal(shape).astype(np.float32)
    m = rng.standard_normal((b, c)).astype(np.float32)
    s = rng.standard_normal((b, c)).astype(np.float32)
    ct = rng.standard_normal(shape).astype(np.float32)
    return x, m, s, ct


def _jax_adain_grads(x, m, s, ct):
    def loss(x, m, s):
        return (jadain.ada_in(x, m, s) * ct).sum()

    return [np.asarray(a) for a in jax.grad(loss, argnums=(0, 1, 2))(x, m, s)]


def _torch_adain_grads(x, m, s, ct):
    xt = nchw(x).requires_grad_(True)
    mt = torch.from_numpy(m).requires_grad_(True)
    st = torch.from_numpy(s).requires_grad_(True)
    (ada_in(xt, mt, st) * nchw(ct)).sum().backward()
    return nhwc(xt.grad), mt.grad.numpy(), st.grad.numpy()


@pytest.mark.parametrize("shape", [(2, 4, 4, 8), (3, 8, 8, 1), (2, 5, 3, 4)],
                         ids=["4x4x8", "8x8x1", "5x3x4"])
def test_ada_in_forward_and_grads_match_jax(shape):
    x, m, s, ct = _adain_case(shape, seed=sum(shape))
    np.testing.assert_allclose(nhwc(ada_in(nchw(x), torch.from_numpy(m), torch.from_numpy(s))),
                               np.asarray(jadain.ada_in(x, m, s)), rtol=1e-4, atol=1e-5)
    for got, want in zip(_torch_adain_grads(x, m, s, ct), _jax_adain_grads(x, m, s, ct)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_ada_in_zero_variance_channel_is_pinned_finite():
    """A constant channel: the reference's gradient is non-finite there; the
    port drops the sigma-term (its limit) and matches the reference elsewhere."""
    x, m, s, ct = _adain_case((2, 4, 4, 3), seed=7)
    x[0, :, :, 1] = 0.5  # exactly representable: sigma is exactly 0 on both sides
    got = _torch_adain_grads(x, m, s, ct)
    want = _jax_adain_grads(x, m, s, ct)
    assert not np.isfinite(want[0][0, :, :, 1]).all()
    assert np.isfinite(got[0]).all()
    g = ct[0, :, :, 1]
    pinned = s[0, 1] / 1e-5 * (g - g.mean())
    np.testing.assert_allclose(got[0][0, :, :, 1], pinned, rtol=1e-4, atol=1e-5)
    keep = np.ones(x.shape, bool)
    keep[0, :, :, 1] = False
    np.testing.assert_allclose(got[0][keep], want[0][keep], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-5)


def test_ada_in_bwd_ref_equals_autograd_of_ada_in_ref():
    x, m, s, ct = _adain_case((2, 6, 6, 5), seed=3)
    xt, mt, st = (torch.from_numpy(a).requires_grad_(True)
                  for a in (np.ascontiguousarray(x.transpose(0, 3, 1, 2)), m, s))
    g = torch.from_numpy(np.ascontiguousarray(ct.transpose(0, 3, 1, 2)))
    (ada_in_ref(xt, mt, st) * g).sum().backward()
    dx, dm, ds = ada_in_bwd_ref(xt.detach(), st.detach(), g)
    for got, want in ((dx, xt.grad), (dm, mt.grad), (ds, st.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-6)


def _jax_ada_in_sigma_held(x, m, s, eps=1e-5):
    """ada_in with the feature std held constant: the port's limit where sigma == 0."""
    sigma = jax.lax.stop_gradient(jnp.std(x, axis=(1, 2), ddof=1, keepdims=True))
    mu = x.mean(axis=(1, 2), keepdims=True)
    return s[:, None, None, :] * (x - mu) / (sigma + eps) + m[:, None, None, :]


def _second_order(first, x, m, s, ct, ct2):
    """Gradient w.r.t. (x, m, s) of R = sum(gx^2 ct2) + |gm|^2 + |gs|^2, where (gx, gm, gs)
    is the gradient of sum(sin(first(x, m, s)) ct): a function of ``jax.grad``."""
    def outer(x, m, s):
        gx, gm, gs = jax.grad(lambda *a: (jnp.sin(first(*a)) * ct).sum(), argnums=(0, 1, 2))(
            x, m, s)
        return (gx * gx * ct2).sum() + (gm * gm).sum() + (gs * gs).sum()

    return [np.asarray(a) for a in jax.grad(outer, argnums=(0, 1, 2))(x, m, s)]


@pytest.mark.parametrize("shape,zero_channel,graphless", [
    ((2, 4, 4, 8), False, False), ((2, 8, 8, 1), False, False), ((2, 4, 4, 8), True, False),
    ((2, 4, 4, 8), False, True)],
    ids=["4x4x8", "8x8x1", "4x4x8_zero_variance", "4x4x8_graphless_backward"])
def test_ada_in_double_backward_matches_jax(shape, zero_channel, graphless, monkeypatch):
    """The double backward through ``ada_in`` (``AdaINBackward``'s backward) against
    ``jax.grad`` of a function of ``jax.grad``; each tensor within 1e-4 of its largest
    entry.  A constant channel (sigma == 0, non-finite in the reference) is held to the
    reference with sigma held constant, the port's pinned limit, on its own scale.
    ``graphless``: the first-order backward returns tensors with no autograd graph, as
    the backward kernel's outputs on the card are; the second order must not need one."""
    if graphless:
        def detached_bwd(*args):
            return tuple(t.detach() for t in ada_in_bwd_ref(*args))
        monkeypatch.setattr(kadain, "_bwd", detached_bwd)
    x, m, s, ct = _adain_case(shape, seed=sum(shape) + 1)
    ct2 = np.random.default_rng(sum(shape) + 2).standard_normal(shape).astype(np.float32)
    if zero_channel:
        x[0, :, :, 1] = 0.5  # exactly representable: sigma is exactly 0 on both sides
    xt = nchw(x).requires_grad_(True)
    mt, st = (torch.from_numpy(a).requires_grad_(True) for a in (m, s))
    gx, gm, gs = torch.autograd.grad((torch.sin(ada_in(xt, mt, st)) * nchw(ct)).sum(),
                                     (xt, mt, st), create_graph=True)
    r = (gx * gx * nchw(ct2)).sum() + (gm * gm).sum() + (gs * gs).sum()
    got = [t.detach() for t in torch.autograd.grad(r, (xt, mt, st))]
    got = [nhwc(got[0]), got[1].numpy(), got[2].numpy()]
    want = _second_order(jadain.ada_in, x, m, s, ct, ct2)
    held = _second_order(_jax_ada_in_sigma_held, x, m, s, ct, ct2)
    pinned = [np.zeros(x.shape, bool), np.zeros(m.shape, bool), np.zeros(s.shape, bool)]
    if zero_channel:
        pinned[0][0, :, :, 1] = pinned[1][0, 1] = pinned[2][0, 1] = True
        assert not np.isfinite(want[0][pinned[0]]).all()
    for g, w, h, p in zip(got, want, held, pinned):
        assert np.isfinite(g).all()
        for sel, ref in ((~p, w), (p, h)):
            if sel.any():
                err = np.abs(g[sel] - ref[sel]).max()
                assert err <= 1e-4 * np.abs(ref[sel]).max(), (err, np.abs(ref[sel]).max())


@pytest.mark.parametrize("affine", [False, True], ids=["plain", "affine"])
def test_instance_norm_matches_jax(affine):
    rng = np.random.default_rng(11)
    x = (3.0 + rng.standard_normal((2, 5, 5, 6))).astype(np.float32)
    scale = rng.standard_normal(6).astype(np.float32) if affine else None
    bias = rng.standard_normal(6).astype(np.float32) if affine else None
    want = jadain.instance_norm(x, scale, bias)
    got = tadain.instance_norm(nchw(x), *(None if a is None else torch.from_numpy(a)
                                         for a in (scale, bias)))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("op", ["upscale2d", "avg_pool2d", "adaptive_max_pool", "leaky_relu"])
def test_image_ops_match_jax(op):
    x = np.random.default_rng(5).standard_normal((2, 6, 4, 3)).astype(np.float32)
    got = getattr(tio, op)(nchw(x))
    want = np.asarray(getattr(jio, op)(x))
    got = got.numpy() if got.ndim == 2 else nhwc(got)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sample_size", [1, 3])
def test_set_stats_match_jax(sample_size):
    x = np.random.default_rng(2).standard_normal((4, sample_size, 7)).astype(np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_allclose(tstats.custom_std(t).numpy(), np.asarray(jstats.custom_std(x)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tstats.mean_stat(t).numpy(), np.asarray(jstats.mean_stat(x)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("stat", ["custom_std", "logvar_stat", "mean_stat"])
def test_set_stats_of_bf16_sets_match_jax(stat):
    """A bf16 set whose spread is small beside its mean, as the authenticator's env
    features of nearly coinciding fakes are: ``jnp.var`` computes a bf16 input in
    f32 and rounds the result once, so the port's statistic must lie within one
    bf16 rounding of the reference's (its centred squares taken in bf16 missed by
    up to the statistic itself)."""
    rng = np.random.default_rng(3)
    x = (2.5 + 0.02 * rng.standard_normal((8, 5, 64))).astype(np.float32)
    t = torch.from_numpy(x).to(torch.bfloat16)
    got = getattr(tstats, stat)(t)
    want = np.asarray(getattr(jstats, stat)(jnp.asarray(t.float().numpy(), jnp.bfloat16)),
                      np.float32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7, atol=0)


def _jax_attention_core(f, g, h):
    """The jnp core of nn/blocks.py SelfAttention (:895-898), kept in f32."""
    attn = jnp.einsum("bic,bjc->bij", f, g, preferred_element_type=jnp.float32)
    attn = jax.nn.softmax(attn, axis=1)
    return jnp.einsum("bic,bij->bjc", h, attn, preferred_element_type=jnp.float32)


ATT_SHAPES = [(2, 16, 8, 1), (2, 64, 16, 4), (1, 256, 16, 2)]


def _att_case(b, n, c, cq, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, n, cq), (b, n, cq), (b, n, c), (b, n, c)))


@pytest.mark.parametrize("shape", ATT_SHAPES, ids=["n16_cq1", "n64_cq4", "n256_cq2"])
def test_attention_core_matches_jax_and_sdpa(shape):
    f, g, h, _ = _att_case(*shape, seed=shape[1])
    tf, tg, th = map(torch.from_numpy, (f, g, h))
    got = attention_core(tf, tg, th).numpy()
    np.testing.assert_allclose(got, np.asarray(_jax_attention_core(f, g, h)),
                               rtol=1e-4, atol=1e-5)
    # standard attention with Q = g, K = f, V = h at scale 1
    sdpa = F.scaled_dot_product_attention(tg, tf, th, scale=1.0).numpy()
    np.testing.assert_allclose(got, sdpa, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(attention_core_ref(tf, tg, th).numpy(), got, rtol=0, atol=0)


@pytest.mark.parametrize("shape", ATT_SHAPES, ids=["n16_cq1", "n64_cq4", "n256_cq2"])
def test_attention_core_bwd_matches_jax(shape):
    f, g, h, dout = _att_case(*shape, seed=shape[1] + 1)
    _, vjp = jax.vjp(_jax_attention_core, f, g, h)
    want = [np.asarray(a) for a in vjp(dout)]
    got = attention_core_bwd(*map(torch.from_numpy, (f, g, h, dout)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5)
    # and the Function's backward is the same function
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (f, g, h)]
    attention_core(*leaves).backward(torch.from_numpy(dout))
    for leaf, a in zip(leaves, got):
        np.testing.assert_allclose(leaf.grad.numpy(), a.numpy(), rtol=0, atol=0)
