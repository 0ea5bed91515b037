"""Where a train step's time goes on the GPU: a torch.profiler trace of a few steps.

    python scripts/torch_profile_step.py [--config flagship|vox|gaussian|legacy]
                                         [--warm N] [--steps N] [--trace PATH.json.gz]
                                         [--time] [--cudnn_benchmark]
                                         [--compute_dtype bfloat16|float32]

Builds the port's game state from a seed at the flagship config (B=128,
32x32x1, style 512, bf16), the VoxCeleb config (64x64x3, R1 with
reg_param 10) or the Gaussian game's Nash-check config (d=10, m1 n5 k10,
head x8, B=4096, f32), takes ``--warm`` steps, then traces ``--steps``
calls of ``train_step`` (the image game's on two device-resident uint8
batches; the Gaussian game's drawing its batch on the device) and prints,
per step (``legacy``: a step of ``chip_smoke.py`` phase 14's legacy AdaIN
stack, B'=640, bf16: power iteration, forward, backward, Adam):
  * host ms (wall clock up to the final synchronize) and the ms the host
    took to enqueue the steps (before that synchronize);
  * device busy ms (the union of the kernels', memsets' and copies'
    intervals) and the device's idle share of the wall clock;
  * device launches;
  * device ms by category of kernel name, largest first, the largest
    kernels by name, and the ops (with four levels of their callers) that
    launched the most device time.
The profiler adds host time, so host ms here exceed chip_smoke.py's.  With
``--trace`` the Chrome trace is written there.  ``--time`` times the steps
without the profiler instead (wall clock up to the final synchronize, as
``chip_smoke.py`` phases 6 and 7 do) and prints ms/step and steps/s;
``--cudnn_benchmark`` lets cuDNN pick its algorithms by timing them.  Needs
one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import itertools
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from optimalstrategiesagainstgenerativeattacks_torch.train import gaussian as tg  # noqa: E402
from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg  # noqa: E402
from optimalstrategiesagainstgenerativeattacks_torch.utils.config import (  # noqa: E402
    GaussianGameConfig,
    ImageGameConfig,
)

SMI = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
CONFIGS = {
    "flagship": {},
    # the VoxCeleb2 paper hparams (train_gim_on_imgs.py:6-8)
    "vox": dict(img_size=64, img_channels=3, au_lr=1e-4, im_lr=1e-4,
                env_noise_mapping_lr=1e-6, reg_param=10.0),
    # the README's Nash check of the Gaussian game
    "gaussian": dict(src_dim=10, m=1, n=5, k=10, au_hidden_scale=8, batch_size=4096),
    "legacy": {},
}
# (category, substrings of a kernel name), first match wins
CATEGORIES = (
    ("K2 attention core (port)", ("attention_core",)),
    ("K1/K1b AdaIN (port)", ("adain_",)),
    ("avg_pool2d forward + backward", ("avg_pool",)),
    ("cuDNN layout transforms", ("nchwToNhwc", "nhwcToNchw", "nchwtonhwc", "nhwctonchw")),
    ("im2col / col2im (conv_one_channel)", ("im2col", "col2im")),
    ("convolutions", ("conv", "fprop", "dgrad", "wgrad", "cudnn")),
    ("GEMMs", ("gemm", "gemv")),
    ("softmax", ("softmax",)),
    ("nearest upsample", ("upsample",)),
    ("Adam (foreach)", ("multi_tensor_apply", "foreach")),
    ("reductions", ("reduce_kernel", "Reduce")),
    ("copies and casts", ("copy", "Memcpy")),  # casts run direct_copy_kernel
    ("memsets and fills", ("Memset", "FillFunctor")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def category(name: str) -> str:
    for label, keys in CATEGORIES:
        if any(k in name for k in keys):
            return label
    return "other"


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals (us)."""
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main() -> None:
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=list(CONFIGS), default="vox")
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, help="write the Chrome trace here (.json.gz)")
    ap.add_argument("--time", action="store_true", help="time the steps, no profiler")
    ap.add_argument("--cudnn_benchmark", action="store_true")
    ap.add_argument("--compute_dtype", default=None, choices=["bfloat16", "float32"],
                    help="the image configs' compute dtype (default: the config's)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    torch.backends.cudnn.benchmark = args.cudnn_benchmark

    if args.config == "legacy":
        import chip_smoke as cs
        from optimalstrategiesagainstgenerativeattacks_torch.ops.spectral import power_iterate

        stack = cs.inventory_module(lambda: cs.LegacyStack(torch.bfloat16), args.seed).cuda()
        opt = torch.optim.Adam(stack.parameters(), lr=1e-4, betas=(0.0, 0.99))
        x, style = (t.cuda() for t in cs.legacy_inputs(
            cs.LEGACY_B, torch.Generator().manual_seed(args.seed), torch.bfloat16))

        def step():
            power_iterate(stack)
            loss = stack(x, style).float().square().mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()

        for _ in range(args.warm):
            step()
    elif args.config == "gaussian":
        cfg = GaussianGameConfig(seed=args.seed, **CONFIGS[args.config])
        state = tg.create_state(cfg, "cuda")
        tg.train_chunk(state, args.warm)

        def step():
            tg.train_step(state)
    else:
        dtype = {"compute_dtype": args.compute_dtype} if args.compute_dtype else {}
        cfg = ImageGameConfig(seed=args.seed, **CONFIGS[args.config], **dtype)
        rng = np.random.default_rng(args.seed)
        batches = [
            {key: torch.from_numpy(rng.integers(
                0, 256, (cfg.batch_size, n, cfg.img_size, cfg.img_size, cfg.img_channels),
                dtype=np.uint8)).cuda()
             for key, n in (("real_sample", cfg.n), ("leaked_sample", cfg.m),
                            ("si_sample", cfg.k))}
            for _ in range(2)
        ]
        state, _ = timg.train_gim_imgs_steps(cfg, itertools.cycle(batches), args.warm,
                                             device="cuda")

        def step():
            timg.train_step(state, batches[state.step % 2])
    torch.cuda.synchronize()
    if args.time:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        s = (time.perf_counter() - t0) / args.steps
        card = subprocess.run(SMI, capture_output=True, text=True).stdout.strip()
        print(f"{args.config} ({args.compute_dtype or 'its dtype'}): "
              f"{args.steps} steps after {args.warm}, cudnn.benchmark "
              f"{args.cudnn_benchmark}: {s * 1e3:.2f} ms/step, {1 / s:.4f} steps/s, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
        return
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        t_enqueued = time.perf_counter()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    events = prof.events()
    # device activities; user annotations (e.g. Optimizer.step) span kernels and are not work
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    if not device:
        sys.exit("the trace holds no device activity")
    wall_us = (t1 - t0) * 1e6
    busy = busy_us((e.time_range.start, e.time_range.end) for e in device)
    by_cat, by_name = defaultdict(float), defaultdict(float)
    for e in device:
        by_cat[category(e.name)] += e.time_range.end - e.time_range.start
        by_name[e.name] += e.time_range.end - e.time_range.start
    n = args.steps
    if args.config == "legacy":
        print(f"legacy: the AdaIN stack of chip_smoke.py phase 14, B'={cs.LEGACY_B}, bf16; "
              f"{n} traced steps after {args.warm}")
    else:
        shape = (f"d={cfg.src_dim} m={cfg.m} n={cfg.n} k={cfg.k} head x{cfg.au_hidden_scale}"
                 if args.config == "gaussian" else
                 f"img={cfg.img_size}x{cfg.img_size}x{cfg.img_channels} style={cfg.style_dim}")
        print(f"{args.config}: B={cfg.batch_size} {shape} reg_param={cfg.reg_param} "
              f"{cfg.compute_dtype}; {n} traced steps after {args.warm}")
    print(f"  host {wall_us / n / 1e3:.2f} ms/step under the profiler, of which enqueue "
          f"{(t_enqueued - t0) * 1e3 / n:.2f} ms/step")
    print(f"  device busy {busy / n / 1e3:.2f} ms/step, idle share {1 - busy / wall_us:.3f}, "
          f"{len(device) / n:.0f} device activities per step")
    total = sum(by_cat.values())
    for label, us in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {label:34s} {us / n / 1e3:9.2f} ms/step  {us / total:.3f}")
    print("  largest kernels (ms/step, category):")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {us / n / 1e3:8.2f}  {category(name)}: {name[:110]}")
    print("  ops that launched the most device time (ms/step: op < its callers, 4 up):")
    by_op = defaultdict(float)
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        chain, parent = [e.name], e.cpu_parent
        while parent is not None and len(chain) < 5:
            chain.append(parent.name)
            parent = parent.cpu_parent
        by_op[" < ".join(chain)] += sum(k.duration for k in e.kernels)
    for chain, us in sorted(by_op.items(), key=lambda kv: -kv[1])[:15]:
        print(f"    {us / n / 1e3:8.2f}  {chain}")
    if args.trace:
        Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(args.trace)
        print(f"  trace: {args.trace}")


if __name__ == "__main__":
    main()
