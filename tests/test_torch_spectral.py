"""Port spectral-norm state against ``ops/spectral.py`` of the JAX reference.

Same kernels and u/v on both sides (numpy seeds); u/v after one power
iteration atol 1e-6, sigma rtol 1e-5, d sigma / dW atol 1e-6.
"""

import jax
import numpy as np
import pytest
import torch

from optimalstrategiesagainstgenerativeattacks_torch.nn.blocks import ResBlockDown
from optimalstrategiesagainstgenerativeattacks_torch.ops import spectral as tspec
from optimalstrategiesagainstgenerativeattacks_torch.port.transplant import (
    flax_to_state_dict,
    load_flax,
)
from optimalstrategiesagainstgenerativeattacks_tpu.nn import blocks as jblocks
from optimalstrategiesagainstgenerativeattacks_tpu.ops import spectral as jspec

torch.set_num_threads(1)

# (kh, kw, in, out) HWIO kernels, one stacked pair (leading axis 2) like the encoder pair
KERNELS = {"a": (3, 3, 4, 8), "b": (1, 1, 8, 8), "c": (9, 9, 2, 3), "pair": (2, 3, 3, 4, 5)}


def _trees(seed):
    rng = np.random.default_rng(seed)
    params, spectral = {}, {}
    for name, shape in KERNELS.items():
        k = rng.standard_normal(shape).astype(np.float32)
        stack, (kh, kw, cin, cout) = shape[:-4], shape[-4:]
        params[name] = {"kernel": k}
        spectral[name] = {
            "u": rng.standard_normal(stack + (cout,)).astype(np.float32),
            "v": rng.standard_normal(stack + (cin * kh * kw,)).astype(np.float32),
        }
    return params, spectral


def _torch_views(params, spectral):
    """Per-kernel (OIHW weight, u, v) torch tensors, stacked kernels split."""
    out = {}
    for name in KERNELS:
        k, u, v = params[name]["kernel"], spectral[name]["u"], spectral[name]["v"]
        ks, us, vs = (k, u, v) if k.ndim == 5 else (k[None], u[None], v[None])
        for i in range(ks.shape[0]):
            w = torch.from_numpy(np.ascontiguousarray(ks[i].transpose(3, 2, 0, 1)))
            out[(name, i)] = (w, torch.from_numpy(us[i].copy()), torch.from_numpy(vs[i].copy()))
    return out


def _jax_leaf(tree, name, i, leaf):
    a = np.asarray(tree[name][leaf])
    return a[i] if len(KERNELS[name]) == 5 else a


@pytest.mark.parametrize("seed", [0, 1])
def test_power_iterate_matches_jax(seed):
    params, spectral = _trees(seed)
    new = jspec.power_iterate(params, spectral)
    for (name, i), (w, u, v) in _torch_views(params, spectral).items():
        tspec.power_iterate_(w, u, v)
        np.testing.assert_allclose(u.numpy(), _jax_leaf(new, name, i, "u"), rtol=0, atol=1e-6)
        np.testing.assert_allclose(v.numpy(), _jax_leaf(new, name, i, "v"), rtol=0, atol=1e-6)


def test_sigma_and_its_weight_gradient_match_jax():
    params, spectral = _trees(2)
    sig = jspec.compute_sigmas(params, spectral)

    def total(p):
        return sum(jax.tree.leaves(jax.tree.map(lambda s: s.sum(), jspec.compute_sigmas(p, spectral))))

    grads = jax.grad(total)(params)
    for (name, i), (w, u, v) in _torch_views(params, spectral).items():
        w.requires_grad_(True)
        s = tspec.sigma(w, u, v)
        s.backward()
        np.testing.assert_allclose(s.item(), _jax_leaf(sig, name, i, "sigma"), rtol=1e-5)
        g = _jax_leaf(grads, name, i, "kernel")
        np.testing.assert_allclose(w.grad.numpy(), g.transpose(3, 2, 0, 1), rtol=0, atol=1e-6)
        assert not u.requires_grad and not v.requires_grad


def test_module_power_iterate_updates_every_snconv_like_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    jblk = jblocks.ResBlockDown(8)
    variables = jblk.init(jax.random.PRNGKey(3), x)
    params = jax.tree.map(np.asarray, variables["params"])
    spectral = jax.tree.map(np.asarray, variables["spectral"])
    blk = ResBlockDown(4, 8)
    load_flax(blk, params, spectral)
    tspec.power_iterate(blk)
    want = flax_to_state_dict(params, jspec.power_iterate(params, spectral))
    got = blk.state_dict()
    for key in want:
        if key.endswith((".u", ".v")):
            np.testing.assert_allclose(got[key].numpy(), want[key], rtol=0, atol=1e-6)
