"""The candidate pool of a bf16 input (``scripts/torch_bf16_pool.py:bf16_pool``) against
XLA's compile of the reference's pool, and the card script's steps on the CPU.

The reference pools a bf16 input with bf16 sums (``…_tpu/ops/image_ops.py:avg_pool2d``,
``mean(..., dtype=x.dtype)``); XLA's CPU compile adds the window's values one by one,
row-major, each partial sum rounded.  The candidate does the same with elementwise
bf16 ops: at the flagship's and VoxCeleb's bf16 pool shapes (batch 2) its output,
its gradient and R1's double backward (the gradient of <grad, v> with respect to the
cotangent) equal ``jax.jit`` of the reference's at 0.999 of the values or more (all of
them at seed 0).  The port itself still pools with ``F.avg_pool2d`` (``ROADMAP.md`` §3
item 1).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg
from optimalstrategiesagainstgenerativeattacks_tpu.ops.image_ops import avg_pool2d as jax_pool

REPO = Path(__file__).resolve().parents[1]
SPEC = importlib.util.spec_from_file_location("torch_bf16_pool",
                                              REPO / "scripts" / "torch_bf16_pool.py")
pool = importlib.util.module_from_spec(SPEC)
SPEC.loader.exec_module(pool)

torch.set_num_threads(1)

# NHWC: the encoders' and img2img's bf16 pools at the flagship (32x32x1) and VoxCeleb
# (64x64x3) widths, batch 2
SHAPES = [(2, 32, 32, 1), (2, 16, 16, 128), (2, 64, 64, 3), (2, 32, 32, 64), (2, 8, 8, 256)]


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
    for layout in (torch.contiguous_format, torch.channels_last):
        got, grad, double = pool.pool_and_grads(_nchw(x).contiguous(memory_format=layout),
                                                _nchw(ct), _nchw(v, torch.float32))
        assert got.dtype == grad.dtype == double.dtype == torch.bfloat16
        for name, a, e in (("output", got, want), ("gradient", grad, want_grad),
                           ("double backward", double, want_double)):
            share = float(np.mean(_nhwc(a) == e))
            assert share >= 0.999, f"{name} {layout}: {share:.4f} equal to XLA's"


def test_card_script_steps_on_cpu():
    """The card script's pool sites, its card-vs-CPU check (here CPU against CPU) and a
    bf16 R1 step with the candidate, at a tiny VoxCeleb-shaped config."""
    state, batches = pool.state_and_batches("vox", 0, "cpu", img_size=16, style_dim=32,
                                            batch_size=2, n=2, k=2)
    sites = pool.pool_sites(state, batches)
    assert sites and all(len(shape) == 4 and shape[2] == 16 for shape, _ in sites)
    assert pool.check_sites(sites, "cpu", 0) == 0
    with pool.pooled_by(pool.bf16_pool):
        metrics, _ = timg.train_step(state, batches[0])
    assert all(np.isfinite(float(m)) for m in metrics.values())
    assert float(metrics["au_reg"]) > 0
