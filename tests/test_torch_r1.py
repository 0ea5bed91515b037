"""The attention core under the R1 penalty's double backward, against the JAX reference.

* K2's backward (``attention_core_bwd``, torch ops) against ``jax.vjp`` of
  the JAX core (``nn/blocks.py:SelfAttention``, :895-899), run op by op on
  the same bf16 inputs and cotangent.  The JAX vjp rounds twice to the
  activation dtype: it takes P rounded (the P of the forward's second
  product) for dh, and the cotangent of ``attn.astype(bf16)`` is bf16, so dP
  is rounded before the softmax vjp.  The port rounds alike, and is held by
  the measure the forward is held by (``test_torch_kernel_budget.py``): for
  each of df, dg, dh, at most 2^-9 of the largest entry apart and at least
  99 % of the bf16 entries equal.  The backward without those roundings
  misses the measure.
* ``SelfAttention`` under transplanted weights: the gradient, with respect
  to its weights and to x, of R = |d sum(out * ct) / dx|^2 (the R1 penalty's
  form), against ``jax.grad`` of the same through the Flax module.
  - f32: the train-step test's tolerances, rtol 1e-3 with an absolute floor
    of 1e-4 x max|g| of the tensor and 1e-6 x max|g| over all tensors.  The
    f and h conv biases have an exactly zero gradient (they shift every
    source score of a column alike, or add a constant that the softmax's
    columns, summing to one, carry through unchanged), so both sides hold
    rounding noise there, which the second floor covers.
  - bf16: two programs whose bf16 convs accumulate in other orders, so the
    results differ by bf16 rounding, not by a bf16 step.  The measure takes
    the f32 reference as the yardstick: per tensor of non-zero gradient, the
    port's bf16 result is within 2^-5 of the reference's norm of the JAX
    bf16 result (Frobenius), and its error against the f32 reference is at
    most twice the JAX bf16 result's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimalstrategiesagainstgenerativeattacks_torch.kernels import attention as k2
from optimalstrategiesagainstgenerativeattacks_torch.nn import blocks as tblocks
from optimalstrategiesagainstgenerativeattacks_torch.port.transplant import (
    flax_to_state_dict,
    load_flax,
)
from optimalstrategiesagainstgenerativeattacks_tpu.nn import blocks as jblocks
from test_torch_support import randomise_norms_and_gammas

torch.set_num_threads(1)

ZERO_GRAD = ("conv_f.bias", "conv_h.bias")


def _jax_core(f, g, h):
    """nn/blocks.py SelfAttention (:895-899): f32 scores and softmax, P rounded to h's dtype."""
    attn = jnp.einsum("bic,bjc->bij", f, g, preferred_element_type=jnp.float32)
    attn = jax.nn.softmax(attn.astype(jnp.float32), axis=1)
    attn = attn.astype(h.dtype)
    out = jnp.einsum("bic,bij->bjc", h, attn, preferred_element_type=jnp.float32)
    return out.astype(h.dtype)


def _unrounded_bwd(f, g, h, dout):
    """The backward with P and dP left in f32."""
    ff, gf, hf, do = f.float(), g.float(), h.float(), dout.float()
    p = torch.softmax(torch.bmm(ff, gf.transpose(1, 2)), dim=1)
    dp = torch.bmm(hf, do.transpose(1, 2))
    ds = p * (dp - (p * dp).sum(dim=1, keepdim=True))
    return (torch.bmm(ds, gf).to(f.dtype), torch.bmm(ds.transpose(1, 2), ff).to(g.dtype),
            torch.bmm(p, do).to(h.dtype))


def _agreement(got, want):
    """(max |got - want| / max |want|, share of exactly equal entries)."""
    d = np.abs(got.float().numpy() - want)
    return d.max() / np.abs(want).max(), (d == 0).mean()


def _meets(got, want):
    rel, equal = _agreement(got, want)
    return rel <= 2.0 ** -9 and equal >= 0.99


ATT_BF16 = [(2, 16, 8, 1), (2, 64, 32, 4), (1, 256, 16, 2), (2, 50, 20, 3), (2, 64, 256, 32)]


@pytest.mark.parametrize("shape", ATT_BF16, ids=["n16_cq1", "n64_cq4", "n256_cq2", "n50_cq3",
                                                 "n64_c256_cq32"])
def test_attention_core_bwd_bf16_rounds_as_the_jax_reference(shape):
    b, n, c, cq = shape
    rng = np.random.default_rng(n)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((b, n, cq), (b, n, cq), (b, n, c), (b, n, c))]
    jx = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    _, vjp = jax.vjp(_jax_core, *jx[:3])
    want = [np.asarray(w.astype(jnp.float32)) for w in vjp(jx[3])]
    tx = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    got = k2.attention_core_bwd(*tx)
    for name, gt, w in zip(("df", "dg", "dh"), got, want):
        assert gt.dtype == torch.bfloat16
        assert _meets(gt, w), (name, _agreement(gt, w))
    # without the two roundings the backward misses the reference at bf16 level
    assert not all(_meets(gt, w) for gt, w in zip(_unrounded_bwd(*tx), want))


def _grad_of_grad_jax(dtype, params, spectral, x, ct):
    jblk = jblocks.SelfAttention(dtype=dtype)

    def inner(p, xx):
        out = jblk.apply({"params": p, "spectral": spectral}, xx)
        return (out.astype(jnp.float32) * ct).sum()

    def penalty(p, xx):
        return jnp.square(jax.grad(inner, argnums=1)(p, xx).astype(jnp.float32)).sum()

    gp, gx = jax.grad(penalty, argnums=(0, 1))(params, jnp.asarray(x, dtype or jnp.float32))
    out = flax_to_state_dict(gp, {})
    out["x"] = np.asarray(gx.astype(jnp.float32))
    return out


def _grad_of_grad_port(dtype, params, spectral, x, ct):
    blk = tblocks.SelfAttention(x.shape[-1], dtype=dtype)
    load_flax(blk, params, spectral)
    tx = torch.from_numpy(x).to(dtype or torch.float32).permute(0, 3, 1, 2).requires_grad_(True)
    inner = (blk(tx).float() * torch.from_numpy(ct).permute(0, 3, 1, 2)).sum()
    gx, = torch.autograd.grad(inner, tx, create_graph=True)
    penalty = gx.float().square().sum()
    names = [k for k, _ in blk.named_parameters()]
    grads = torch.autograd.grad(penalty, [p for _, p in blk.named_parameters()] + [tx])
    out = {k: g.float().numpy() for k, g in zip(names + ["x"], grads)}
    out["x"] = out["x"].transpose(0, 2, 3, 1)
    return out


@pytest.fixture(scope="module")
def attention_case():
    """Flax-initialised SelfAttention over 8x8 tokens of 32 channels, gamma random."""
    shape = (2, 8, 8, 32)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(shape).astype(np.float32)
    ct = rng.standard_normal(shape).astype(np.float32)
    variables = jblocks.SelfAttention().init(jax.random.PRNGKey(0), x)
    params = randomise_norms_and_gammas(jax.tree.map(np.asarray, variables["params"]), rng)
    spectral = jax.tree.map(np.asarray, variables["spectral"])
    want32 = _grad_of_grad_jax(None, params, spectral, x, ct)
    return params, spectral, x, ct, want32


def test_self_attention_grad_of_grad_matches_jax_f32(attention_case):
    params, spectral, x, ct, want = attention_case
    got = _grad_of_grad_port(None, params, spectral, x, ct)
    assert set(got) == set(want)
    overall = max(np.abs(w).max() for w in want.values())
    for k, g in got.items():
        floor = max(1e-4 * np.abs(want[k]).max(), 1e-6 * overall)
        np.testing.assert_allclose(g, want[k], rtol=1e-3, atol=floor, err_msg=k)


def test_self_attention_grad_of_grad_matches_jax_bf16(attention_case):
    params, spectral, x, ct, want32 = attention_case
    want = _grad_of_grad_jax(jnp.bfloat16, params, spectral, x, ct)
    got = _grad_of_grad_port(torch.bfloat16, params, spectral, x, ct)
    assert set(got) == set(want)
    for k in got:
        if k in ZERO_GRAD:
            continue
        ref = np.linalg.norm(want32[k])
        assert np.linalg.norm(got[k] - want[k]) <= 2.0 ** -5 * ref, k
        assert np.linalg.norm(got[k] - want32[k]) <= 2 * np.linalg.norm(want[k] - want32[k]), k
