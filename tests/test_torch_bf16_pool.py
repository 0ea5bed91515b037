"""The port's pool of a bf16 input (``…_torch/ops/image_ops.py:avg_pool2d``) against
XLA's compile of the reference's pool, and the card scripts' pool steps on the CPU.

The reference pools a bf16 input with bf16 sums (``…_tpu/ops/image_ops.py:avg_pool2d``,
``mean(..., dtype=x.dtype)``); XLA's CPU compile adds the window's values one by one,
row-major, each partial sum rounded.  The port's pool does the same with elementwise
bf16 ops: at the flagship's and VoxCeleb's bf16 pool shapes (batch 2), NCHW and
channels_last (an NHWC image of one channel viewed NCHW among them), its output, its
gradient and R1's double backward (the gradient of <grad, v> with respect to the
cotangent) equal ``jax.jit`` of the reference's bit for bit, in the layouts
``F.avg_pool2d`` gives.  An f32 input still goes through ``F.avg_pool2d``.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from optimalstrategiesagainstgenerativeattacks_torch.ops.image_ops import avg_pool2d
from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg
from optimalstrategiesagainstgenerativeattacks_tpu.ops.image_ops import avg_pool2d as jax_pool

REPO = Path(__file__).resolve().parents[1]
SPEC = importlib.util.spec_from_file_location("torch_bf16_pool",
                                              REPO / "scripts" / "torch_bf16_pool.py")
script = importlib.util.module_from_spec(SPEC)
SPEC.loader.exec_module(script)

torch.set_num_threads(1)

# NHWC: the encoders' and img2img's bf16 pools at the flagship (32x32x1) and VoxCeleb
# (64x64x3) widths, batch 2
SHAPES = [(2, 32, 32, 1), (2, 16, 16, 128), (2, 64, 64, 3), (2, 32, 32, 64), (2, 8, 8, 256)]
# NCHW memory, and the NCHW view of NHWC memory (channels_last; the models' layout)
LAYOUTS = {"nchw": lambda t: t.contiguous(),
           "nhwc": lambda t: t.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)}


def _nchw(a, dtype=torch.bfloat16):
    return torch.from_numpy(np.asarray(a, np.float32)).permute(0, 3, 1, 2).to(dtype)


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bf16_pool_equals_xla(shape):
    rng = np.random.default_rng(0)
    b, h, w, c = shape
    x = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    ct = jnp.asarray(rng.standard_normal((b, h // 2, w // 2, c)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    want = np.asarray(jax.jit(jax_pool)(x), np.float32)
    want_grad = np.asarray(jax.jit(lambda a, t: jax.vjp(jax_pool, a)[1](t)[0])(x, ct), np.float32)
    want_double = np.asarray(jax.jit(jax.grad(lambda t, a: jnp.sum(
        (jax.vjp(jax_pool, a)[1](t)[0] * v).astype(jnp.float32))))(ct, x), np.float32)
    for layout, make in LAYOUTS.items():
        xt = make(_nchw(x))
        got, grad, double = chip_smoke.pool_and_grads(xt, _nchw(ct), _nchw(v, torch.float32))
        assert got.dtype == grad.dtype == double.dtype == torch.bfloat16
        for name, a, e in (("output", got, want), ("gradient", grad, want_grad),
                           ("double backward", double, want_double)):
            np.testing.assert_array_equal(_nhwc(a), e, err_msg=f"{name} {layout}")
        plain = chip_smoke.pool_and_grads(xt, _nchw(ct), _nchw(v, torch.float32),
                                          lambda t: F.avg_pool2d(t, 2))
        assert got.stride() == plain[0].stride(), layout
        assert grad.stride() == plain[1].stride() == xt.stride(), layout


def test_f32_pool_is_f_avg_pool2d():
    x = torch.randn(2, 5, 8, 6, generator=torch.Generator().manual_seed(1))
    for t in (x, x.contiguous(memory_format=torch.channels_last)):
        got, want = avg_pool2d(t), F.avg_pool2d(t, 2)
        assert torch.equal(got, want) and got.stride() == want.stride()


def test_card_script_steps_on_cpu():
    """The card scripts' pool sites and ``chip_smoke.py`` phase 4's card-vs-CPU check of
    the pool (here CPU against CPU), then a bf16 R1 step with each pool of the A B B A
    comparison, at a tiny VoxCeleb-shaped config."""
    state, batches = script.state_and_batches("vox", 0, "cpu", img_size=16, style_dim=32,
                                              batch_size=2, n=2, k=2)
    sites = script.pool_sites(state, batches)
    assert sites and all(len(shape) == 4 and shape[2] == 16 for shape, _ in sites)
    assert chip_smoke.check_pool_sites({"vox": sites}, "cpu") == len(sites)
    for pool in (script.f32_sum_pool, avg_pool2d):
        with script.pooled_by(pool):
            metrics, _ = timg.train_step(state, batches[0])
        assert all(np.isfinite(float(m)) for m in metrics.values())
        assert float(metrics["au_reg"]) > 0
