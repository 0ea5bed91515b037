#!/usr/bin/env python
"""What the port's pool of a bf16 input costs a train step, against ``F.avg_pool2d``.

The port pools a bf16 input with bf16 sums, as the reference's compile pools it
(``…_torch/ops/image_ops.py:Bf16Pool``): the window's values added one by one,
row-major, each partial sum rounded, then divided.  ``F.avg_pool2d`` sums in f32 and
rounds once.  On one NVIDIA GPU, at the flagship (B=128, 32x32x1, style 512, bf16)
and VoxCeleb (64x64x3, R1) configs:
  1. every bf16 pool of a train step (input shape and strides), the port's pool on
     the card against it on the CPU on the same random input (``chip_smoke.py``
     phase 4's check): the count of unequal values of the output, the gradient and
     R1's double backward, and their strides against ``F.avg_pool2d``'s;
  2. device launches and device ms a step with ``F.avg_pool2d`` and with the port's
     pool (torch.profiler, one step each), and the kernels that differ;
  3. ms a step, A B B A in one process (A ``F.avg_pool2d`` in every block, B the
     port's pool), ``--steps`` steps after ``--warm``, wall clock up to a
     synchronize.

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

import chip_smoke  # noqa: E402
from optimalstrategiesagainstgenerativeattacks_torch.nn import blocks  # noqa: E402
from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg  # noqa: E402
from optimalstrategiesagainstgenerativeattacks_torch.utils.config import (  # noqa: E402
    ImageGameConfig,
)

CONFIGS = {"flagship": {}, "vox": dict(img_size=64, img_channels=3, au_lr=1e-4, im_lr=1e-4,
                                       env_noise_mapping_lr=1e-6, reg_param=10.0)}


def f32_sum_pool(x, window: int = 2):
    """``F.avg_pool2d``: an f32 sum of the window, rounded once (A)."""
    return F.avg_pool2d(x, window)


@contextlib.contextmanager
def pooled_by(pool):
    """Every ``ResBlockDown`` (and StyleGAN block) pools with ``pool`` inside the block."""
    saved, blocks.avg_pool2d = blocks.avg_pool2d, pool
    try:
        yield
    finally:
        blocks.avg_pool2d = saved


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
    """(shape, strides) -> calls of each bf16 pool in one train step."""
    with chip_smoke.recording_pools() as sites:
        step(state, batches)
    return sites


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


def print_diff(what: str, f32_sum: Counter, port: Counter, fmt: str) -> None:
    total_a, total_b = sum(f32_sum.values()), sum(port.values())
    print(f"  {what} a step: F.avg_pool2d {total_a:{fmt}}, the port's pool {total_b:{fmt}} "
          f"({total_b - total_a:+{fmt}})", flush=True)
    diff = {k: port[k] - f32_sum[k] for k in port | f32_sum if port[k] != f32_sum[k]}
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
    for name in args.configs:
        state, batches = state_and_batches(name, args.seed, "cuda")
        for _ in range(args.warm):
            step(state, batches)
        chip_smoke.check_pool_sites({name: pool_sites(state, batches)}, seed=args.seed)
        port = device_activities(state, batches)
        with pooled_by(f32_sum_pool):
            step(state, batches)  # F.avg_pool2d's first launches
            f32_sum = device_activities(state, batches)
        print_diff("device launches", f32_sum[0], port[0], "d")
        print_diff("device ms", f32_sum[1], port[1], ".3f")
        times = []
        for label in "ABBA":
            with pooled_by(f32_sum_pool) if label == "A" else contextlib.nullcontext():
                times.append(ms_a_step(state, batches, args.steps))
        print(f"  ms a step, {args.steps} steps after {args.warm}, A B B A (A F.avg_pool2d, "
              f"B the port's pool): {' / '.join(f'{t:.2f}' for t in times)}  [{card}]",
              flush=True)
        del state, batches
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
