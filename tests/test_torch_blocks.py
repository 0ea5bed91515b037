"""Port blocks against their Flax twins under the transplant, forward and gradients.

Each block is initialised by Flax, its norms and attention gamma are given
random values, and the weights are carried into the port.  Outputs rtol 1e-4
/ atol 1e-5; input and parameter gradients rtol 1e-3 / atol 1e-6 (f32).
A conv bias that feeds an instance norm or AdaIN has an exactly zero
gradient (the norm removes any per-channel constant); both sides then hold
rounding noise, which must stay below 1e-5.

``conv_one_channel``, the card's path for a conv of one channel to one
channel (cuDNN gets those wrong in bf16), equals ``F.conv2d`` in f64,
forward and backward, to 1e-12.
"""

import jax
import numpy as np
import pytest
import torch

from optimalstrategiesagainstgenerativeattacks_torch.nn import blocks as tblocks
from optimalstrategiesagainstgenerativeattacks_torch.port.transplant import (
    flax_to_state_dict,
    load_flax,
)
from optimalstrategiesagainstgenerativeattacks_tpu.nn import blocks as jblocks
from test_torch_support import randomise_norms_and_gammas

torch.set_num_threads(1)

# name: (flax block, port block, input NHWC shape, style width or None)
CASES = {
    "SelfAttention": (lambda: jblocks.SelfAttention(), lambda: tblocks.SelfAttention(16),
                      (2, 4, 4, 16), None),
    "ResBlockDown": (lambda: jblocks.ResBlockDown(8), lambda: tblocks.ResBlockDown(4, 8),
                     (2, 8, 8, 4), None),
    "ResBlockDown9x9": (lambda: jblocks.ResBlockDown(8, conv_size=9, padding=4),
                        lambda: tblocks.ResBlockDown(2, 8, conv_size=9, padding=4),
                        (2, 8, 8, 2), None),
    "ResBlockUp": (lambda: jblocks.ResBlockUp(4), lambda: tblocks.ResBlockUp(8, 4),
                   (2, 4, 4, 8), None),
    "AdaResBlock2": (lambda: jblocks.AdaResBlock2(8, 6), lambda: tblocks.AdaResBlock2(8, 6),
                     (2, 4, 4, 8), 6),
    "AdaResBlockUp2": (lambda: jblocks.AdaResBlockUp2(8, 4),
                       lambda: tblocks.AdaResBlockUp2(8, 4, 6), (2, 4, 4, 8), 6),
}

ZERO_GRAD = {
    "ResBlockUp": {"conv_r1.bias"},
    "AdaResBlock2": {"conv1.bias", "conv2.bias"},
    "AdaResBlockUp2": {"conv_r1.bias"},
}


@pytest.mark.parametrize("name", list(CASES))
def test_block_matches_flax_forward_and_grads(name):
    make_flax, make_torch, shape, style_dim = CASES[name]
    rng = np.random.default_rng(len(name))
    x = rng.standard_normal(shape).astype(np.float32)
    inputs = [x]
    if style_dim is not None:
        inputs.append(rng.standard_normal((shape[0], style_dim)).astype(np.float32))
    jblk = make_flax()
    variables = jblk.init(jax.random.PRNGKey(0), *inputs)
    params = randomise_norms_and_gammas(jax.tree.map(np.asarray, variables["params"]), rng)
    spectral = jax.tree.map(np.asarray, variables["spectral"])
    out_shape = jax.eval_shape(lambda *a: jblk.apply({"params": params, "spectral": spectral}, *a),
                               *inputs).shape
    ct = rng.standard_normal(out_shape).astype(np.float32)

    def loss(p, *a):
        return (jblk.apply({"params": p, "spectral": spectral}, *a) * ct).sum()

    want_out = np.asarray(jblk.apply({"params": params, "spectral": spectral}, *inputs))
    want_grads = jax.grad(loss, argnums=tuple(range(len(inputs) + 1)))(params, *inputs)
    want_param_grads = flax_to_state_dict(want_grads[0], {})

    blk = make_torch()
    load_flax(blk, params, spectral)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    targs = [tx] + [torch.from_numpy(a).requires_grad_(True) for a in inputs[1:]]
    out = blk(*targs)
    got_out = out.detach().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got_out, want_out, rtol=1e-4, atol=1e-5)
    (out * torch.from_numpy(ct).permute(0, 3, 1, 2)).sum().backward()

    np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want_grads[1]),
                               rtol=1e-3, atol=1e-6)
    for t, w in zip(targs[1:], want_grads[2:]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-3, atol=1e-6)
    got_param_grads = {k: p.grad.numpy() for k, p in blk.named_parameters()}
    assert set(got_param_grads) == set(want_param_grads)
    for k, g in got_param_grads.items():
        if k in ZERO_GRAD.get(name, ()):
            assert max(np.abs(g).max(), np.abs(want_param_grads[k]).max()) < 1e-5, k
            continue
        np.testing.assert_allclose(g, want_param_grads[k], rtol=1e-3, atol=1e-6, err_msg=k)


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
