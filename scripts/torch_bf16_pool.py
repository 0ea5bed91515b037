#!/usr/bin/env python
"""A pool of a bf16 input with bf16 sums, as the reference's compile pools it: the
candidate, bit-equal on the card and the CPU, and what it costs a train step.

The port pools with ``F.avg_pool2d``, an f32 sum rounded once.  The reference
sums a bf16 window in bf16 (``…_tpu/ops/image_ops.py:avg_pool2d``, ``mean(...,
dtype=x.dtype)``), and XLA's CPU compile adds the window's values one by one,
row-major, each partial sum rounded (``scripts/torch_bf16_pool_readings.py
orders``).  ``bf16_pool`` does that with strided views and elementwise bf16 ops,
which round alike on the CPU and the card.  It is not the port's pool: it moves
``tests/test_torch_train_step_bf16.py``'s single-batch max over its bound
(``scripts/torch_bf16_pool_readings.py r1``).

On one NVIDIA GPU, at the flagship (B=128, 32x32x1, style 512, bf16) and
VoxCeleb (64x64x3, R1) configs:
  1. every bf16 pool of a train step (input shape and layout), the candidate on
     the card against the candidate on the CPU on the same random input: the
     count of unequal values of the output, the gradient and R1's double
     backward (the gradient of <grad, v> with respect to the cotangent);
  2. device launches and device ms a step with the port's pool and with the
     candidate (torch.profiler, one step each), and the kernels that differ;
  3. ms a step, A B B A in one process (A the port's pool, B the candidate),
     ``--steps`` steps after ``--warm``, wall clock up to a synchronize.

    python scripts/torch_bf16_pool.py [--configs flagship vox] [--steps 20] [--warm 3]

Exits non-zero if a value differs or there is no GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from optimalstrategiesagainstgenerativeattacks_torch.nn import blocks  # noqa: E402
from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg  # noqa: E402
from optimalstrategiesagainstgenerativeattacks_torch.utils.config import (  # noqa: E402
    ImageGameConfig,
)

CONFIGS = {"flagship": {}, "vox": dict(img_size=64, img_channels=3, au_lr=1e-4, im_lr=1e-4,
                                       env_noise_mapping_lr=1e-6, reg_param=10.0)}


def _windows(x, window):
    """NCHW -> a [B, C, H/w, w, W/w, w] view of the non-overlapping windows."""
    h, w = x.shape[-2:]
    return x.unflatten(-1, (w // window, window)).unflatten(-3, (h // window, window))


class Bf16Pool(torch.autograd.Function):
    """The window's values added one by one into a bf16 sum, row-major, then divided by
    the window's size.  Its gradient is ``Bf16Unpool``, the adjoint, whose gradient is
    this pool again, so R1's double backward pools in bf16 as the reference does."""

    @staticmethod
    def forward(ctx, x, window):
        ctx.window = window
        dense = x.is_contiguous() or x.is_contiguous(memory_format=torch.channels_last)
        ctx.grad_strides = x.stride() if dense else None
        v = _windows(x, window)
        b, c, h, w = x.shape
        # the input's layout, as F.avg_pool2d keeps it (another layout in front of a
        # conv costs cuDNN a transform each way); an NHWC image of one channel,
        # viewed NCHW, counts as channels_last, as it does for F.avg_pool2d
        nhwc = x.is_contiguous(memory_format=torch.channels_last) and x.stride(1) == 1
        s = torch.empty((b, c, h // window, w // window), dtype=x.dtype, device=x.device,
                        memory_format=torch.channels_last if nhwc else torch.contiguous_format)
        torch.add(v[:, :, :, 0, :, 0], v[:, :, :, 0, :, 1], out=s)
        for k in range(2, window * window):
            s.add_(v[:, :, :, k // window, :, k % window])
        return s.div_(window * window)

    @staticmethod
    def backward(ctx, g):
        return Bf16Unpool.apply(g, ctx.window, ctx.grad_strides), None


class Bf16Unpool(torch.autograd.Function):
    """``g / w²`` over each window (exact for a window of 2), in one launch, with the
    strides given (the pooled input's, as autograd wants its gradient) or contiguous."""

    @staticmethod
    def forward(ctx, g, window, strides=None):
        ctx.window = window
        b, c, h, w = g.shape
        shape = (b, c, h * window, w * window)
        out = (torch.empty_strided(shape, strides, dtype=g.dtype, device=g.device) if strides
               else torch.empty(shape, dtype=g.dtype, device=g.device))
        torch.div(g[:, :, :, None, :, None].expand(b, c, h, window, w, window),
                  window * window, out=_windows(out, window))
        return out

    @staticmethod
    def backward(ctx, gg):
        return Bf16Pool.apply(gg, ctx.window), None, None


def bf16_pool(x, window: int = 2):
    """The candidate: a bf16 input through ``Bf16Pool``, any other through ``F.avg_pool2d``."""
    return Bf16Pool.apply(x, window) if x.dtype == torch.bfloat16 else F.avg_pool2d(x, window)


@contextlib.contextmanager
def pooled_by(pool):
    """Every ``ResBlockDown`` (and StyleGAN block) pools with ``pool`` inside the block."""
    saved, blocks.avg_pool2d = blocks.avg_pool2d, pool
    try:
        yield
    finally:
        blocks.avg_pool2d = saved


def pool_and_grads(x, ct, v):
    """The candidate's output, gradient and double backward at NCHW bf16 ``x``."""
    x = x.detach().requires_grad_(True)
    ct = ct.detach().requires_grad_(True)
    y = bf16_pool(x)
    (g,) = torch.autograd.grad(y, x, ct, create_graph=True)
    (gg,) = torch.autograd.grad((g.float() * v).sum(), ct)
    return y.detach(), g.detach(), gg


def state_and_batches(name: str, seed: int, device: str, **overrides):
    cfg = ImageGameConfig(seed=seed, **{**CONFIGS[name], **overrides})
    rng = np.random.default_rng(seed)
    batches = [{key: torch.from_numpy(rng.integers(
        0, 256, (cfg.batch_size, n, cfg.img_size, cfg.img_size, cfg.img_channels),
        dtype=np.uint8)).to(device)
        for key, n in (("real_sample", cfg.n), ("leaked_sample", cfg.m), ("si_sample", cfg.k))}
        for _ in range(2)]
    state = timg.create_state(cfg, *timg.build_models(cfg), seed, device)
    return state, batches


def step(state, batches):
    timg.train_step(state, batches[state.step % 2])


def pool_sites(state, batches) -> dict:
    """(shape, channels_last) -> calls of each bf16 pool in one train step."""
    sites = {}

    def record(x, window=2):
        if x.dtype == torch.bfloat16:
            key = (tuple(x.shape), x.is_contiguous(memory_format=torch.channels_last)
                   and not x.is_contiguous())
            sites[key] = sites.get(key, 0) + 1
        return F.avg_pool2d(x, window)

    with pooled_by(record):
        step(state, batches)
    return sites


def check_sites(sites: dict, device: str, seed: int) -> int:
    """The candidate on ``device`` against it on the CPU at each site: unequal values."""
    gen = torch.Generator().manual_seed(seed)
    unequal = 0
    for (shape, channels_last), calls in sites.items():
        b, c, h, w = shape
        x = torch.randn(shape, generator=gen).to(torch.bfloat16)
        if channels_last:
            x = x.contiguous(memory_format=torch.channels_last)
        ct = torch.randn(b, c, h // 2, w // 2, generator=gen).to(torch.bfloat16)
        v = torch.randn(shape, generator=gen)
        want = pool_and_grads(x, ct, v)
        got = pool_and_grads(x.to(device), ct.to(device), v.to(device))
        counts = [int((a.cpu() != e).sum()) for a, e in zip(got, want)]
        unequal += sum(counts)
        print(f"  pool {list(shape)}{' channels_last' if channels_last else ''} ({calls} a "
              f"step): unequal values card vs CPU: output {counts[0]}, gradient {counts[1]}, "
              f"double backward {counts[2]}", flush=True)
    return unequal


def device_activities(state, batches) -> tuple:
    """(launches, device ms) of one step by kernel name (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(state, batches)
        torch.cuda.synchronize()
    launches, ms = Counter(), Counter()
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            launches[e.name] += 1
            ms[e.name] += (e.time_range.end - e.time_range.start) / 1e3
    return launches, ms


def print_diff(what: str, port: Counter, candidate: Counter, fmt: str) -> None:
    total_p, total_c = sum(port.values()), sum(candidate.values())
    print(f"  {what} a step: port's pool {total_p:{fmt}}, candidate {total_c:{fmt}} "
          f"({total_c - total_p:+{fmt}})", flush=True)
    diff = {k: candidate[k] - port[k] for k in candidate | port if candidate[k] != port[k]}
    for k in sorted(diff, key=lambda k: -abs(diff[k]))[:8]:
        print(f"    {diff[k]:+{fmt}} {k[:150]}", flush=True)


def ms_a_step(state, batches, n: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step(state, batches)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", nargs="+", default=list(CONFIGS), choices=list(CONFIGS))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    unequal = 0
    for name in args.configs:
        state, batches = state_and_batches(name, args.seed, "cuda")
        for _ in range(args.warm):
            step(state, batches)
        sites = pool_sites(state, batches)
        print(f"{name}: {sum(sites.values())} bf16 pools a step at {len(sites)} shapes",
              flush=True)
        unequal += check_sites(sites, "cuda", args.seed)
        with pooled_by(bf16_pool):
            step(state, batches)  # the candidate's first launches
            candidate = device_activities(state, batches)
        port = device_activities(state, batches)
        print_diff("device launches", port[0], candidate[0], "d")
        print_diff("device ms", port[1], candidate[1], ".3f")
        times = []
        for label in "ABBA":
            with pooled_by(bf16_pool) if label == "B" else contextlib.nullcontext():
                times.append(ms_a_step(state, batches, args.steps))
        print(f"  ms a step, {args.steps} steps after {args.warm}, A B B A (A the port's pool, "
              f"B the candidate): {' / '.join(f'{t:.2f}' for t in times)}  [{card}]", flush=True)
        del state, batches
        torch.cuda.empty_cache()
    if unequal:
        sys.exit(f"{unequal} values of the candidate differ between the card and the CPU")


if __name__ == "__main__":
    main()
