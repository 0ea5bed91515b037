"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--steps N]

Phases (each prints its lines; the first failure exits non-zero):
  1. card:    require CUDA; print the card's name and power limit;
  2. build:   build the hand-written kernels from the checkout's sources;
  3. kernels: each kernel against its plain PyTorch version at every site
              the flagship train step gives it, in bf16 and f32, with the
              kernel's and the plain version's times (CUDA events);
  4. slice:   the flagship impersonator and authenticator forwards in f32
              on the card (kernels) against the same models on the CPU
              (plain versions), same weights, fixed noise;
  5. train:   flagship train steps (B=128, 32x32x1, style 512, bf16) on
              uint8 episodes drawn from --seed; metrics must be finite and
              every kernel of the path must have launched its expected
              count; prints steps/s and images/s.
The second-to-last line is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import copy
import itertools
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# per-step launches at the flagship config, by site shape
ADAIN_SITES = {  # (B', C, H, W): launches per step (forward; backward the same)
    (640, 512, 4, 4): 11,     # 5 res blocks x 2, up_0 first
    (640, 256, 8, 8): 2,      # up_0 second, up_1 first
    (640, 128, 16, 16): 2,    # up_1 second, up_2 first
    (640, 1, 32, 32): 1,      # up_2 second
}
ATTENTION_SITES = {  # (B', N, C, CQ): forward launches per step
    (1920, 64, 256, 32): 2,   # authenticator encoders, au phase
    (1280, 64, 256, 32): 2,   # frozen authenticator encoders, im phase
    (128, 64, 256, 32): 2,    # impersonator encoders
    (640, 64, 128, 16): 1,    # env decoder
    (640, 64, 256, 32): 1,    # img2img down stage
    (640, 256, 128, 16): 1,   # img2img up stage
}
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 2.0 ** -6)}  # (atol, rtol)
SLICE_TOL = 1e-3  # f32 forward, card vs CPU, TF32 off: |err| <= tol * max(1, max|ref|)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compare(name: str, got: torch.Tensor, ref: torch.Tensor, atol: float, rtol: float) -> float:
    """Fail unless max|got - ref| <= atol + rtol * max|ref| (all in f32); returns the error."""
    g, r = got.float(), ref.float()
    if g.shape != r.shape:
        fail(f"{name}: shape {tuple(g.shape)} != {tuple(r.shape)}")
    if not torch.isfinite(g).all():
        fail(f"{name}: non-finite values")
    err = (g - r).abs().max().item()
    scale = r.abs().max().item()
    limit = atol + rtol * scale
    print(f"    {name}: max_abs_err={err:.3e} max|ref|={scale:.3e} limit={limit:.3e}")
    if not err <= limit:
        fail(f"{name}: error {err} above {limit}")
    return err


def check_adain(gen: torch.Generator, results: dict) -> None:
    from optimalstrategiesagainstgenerativeattacks_torch.kernels import adain as k1

    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = TOL[dtype]
        for (b, c, h, w), per_step in ADAIN_SITES.items():
            def rand(*shape):
                return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

            x = rand(b, c, h, w).contiguous(memory_format=torch.channels_last)
            g = rand(b, c, h, w).contiguous(memory_format=torch.channels_last)
            ms, ss = rand(b, c), rand(b, c)
            tag = f"adain {dtype_name(dtype)} [{b},{h},{w},{c}]"
            print(f"  {tag} (x{per_step} per step)")
            fwd_err = compare("fwd", k1.ada_in_fwd_cuda(x, ms, ss), k1.ada_in_ref(x, ms, ss),
                              atol, rtol)
            got = k1.ada_in_bwd_cuda(x, ss, g)
            ref = k1.ada_in_bwd_ref(x, ss, g)
            bwd_err = max(compare(f"bwd {n}", a, r_, atol, rtol)
                          for n, a, r_ in zip(("dx", "dmean", "dstd"), got, ref))
            t = {
                "fwd": cuda_ms(lambda: k1.ada_in_fwd_cuda(x, ms, ss)),
                "fwd_plain": cuda_ms(lambda: k1.ada_in_ref(x, ms, ss)),
                "bwd": cuda_ms(lambda: k1.ada_in_bwd_cuda(x, ss, g)),
                "bwd_plain": cuda_ms(lambda: k1.ada_in_bwd_ref(x, ss, g)),
            }
            print(f"    ms: fwd {t['fwd']:.4f} (plain {t['fwd_plain']:.4f}), "
                  f"bwd {t['bwd']:.4f} (plain {t['bwd_plain']:.4f})")
            for kname, err, key in (("adain_fwd", fwd_err, "fwd"), ("adain_bwd", bwd_err, "bwd")):
                r = results[kname]
                r["max_abs_err"] = max(r["max_abs_err"], err)
                if dtype == torch.bfloat16:  # the train step's dtype
                    r["ms"] += per_step * t[key]
                    r["plain_ms"] += per_step * t[key + "_plain"]


def check_attention(gen: torch.Generator, results: dict) -> None:
    from optimalstrategiesagainstgenerativeattacks_torch.kernels import attention as k2

    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = TOL[dtype]
        for (b, n, c, cq), per_step in ATTENTION_SITES.items():
            def rand(*shape, scale=1.0):
                return (scale * torch.randn(*shape, generator=gen, device="cuda")).to(dtype)

            f, g, h = rand(b, n, cq, scale=0.5), rand(b, n, cq, scale=0.5), rand(b, n, c)
            dout = rand(b, n, c)
            print(f"  attention {dtype_name(dtype)} B'={b} N={n} C={c} CQ={cq} "
                  f"(x{per_step} per step)")
            fwd_err = compare("fwd", k2.attention_core_cuda(f, g, h),
                              k2.attention_core_ref(f, g, h), atol, rtol)
            leaves = [t.clone().requires_grad_(True) for t in (f, g, h)]
            k2.attention_core(*leaves).backward(dout)
            leaves_ref = [t.clone().requires_grad_(True) for t in (f, g, h)]
            k2.attention_core_ref(*leaves_ref).backward(dout)
            for name, a, r_ in zip(("df", "dg", "dh"), leaves, leaves_ref):
                compare(f"bwd {name}", a.grad, r_.grad, atol, rtol)
            t_k = cuda_ms(lambda: k2.attention_core_cuda(f, g, h))
            t_p = cuda_ms(lambda: k2.attention_core_ref(f, g, h))
            print(f"    ms: fwd {t_k:.4f} (plain {t_p:.4f})")
            r = results["attention_core_fwd"]
            r["max_abs_err"] = max(r["max_abs_err"], fwd_err)
            if dtype == torch.bfloat16:
                r["ms"] += per_step * t_k
                r["plain_ms"] += per_step * t_p


def dtype_name(dtype) -> str:
    return "bf16" if dtype == torch.bfloat16 else "f32"


@torch.no_grad()
def randomise_norms_and_gammas(module: torch.nn.Module, gen: torch.Generator) -> None:
    """Give every InstanceNorm affine and attention gamma a random value.

    At init the norms are (1, 0) and the gammas 0: the attention branch then
    adds nothing to the output, and the env decoder's spatially constant
    maps meet zero-variance instance norms that amplify rounding noise.
    Random values exercise the attention kernel and keep the comparison
    well conditioned.
    """
    from optimalstrategiesagainstgenerativeattacks_torch.nn.blocks import (
        InstanceNorm,
        SelfAttention,
    )

    for m in module.modules():
        if isinstance(m, InstanceNorm):
            m.weight.copy_(1.0 + 0.5 * torch.randn(m.weight.shape, generator=gen))
            m.bias.copy_(0.5 * torch.randn(m.bias.shape, generator=gen))
        elif isinstance(m, SelfAttention):
            m.gamma.copy_(0.5 * torch.randn(m.gamma.shape, generator=gen))


def check_slice(seed: int) -> None:
    from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg
    from optimalstrategiesagainstgenerativeattacks_torch.utils.config import ImageGameConfig

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ImageGameConfig(compute_dtype="float32", batch_size=2)
    au, im = timg.build_models(cfg)
    state = timg.create_state(cfg, au, im, seed, "cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    randomise_norms_and_gammas(au, gen)
    randomise_norms_and_gammas(im, gen)
    b, s = cfg.batch_size, cfg.img_size
    leaked = torch.rand(b, cfg.m, s, s, 1, generator=gen) * 2 - 1
    si = torch.rand(b, cfg.k, s, s, 1, generator=gen) * 2 - 1
    z = torch.randn(b, cfg.n, cfg.style_dim, generator=gen)

    def run(au_, im_, device):
        with torch.no_grad():
            fake = im_(leaked.to(device), cfg.n, z=z.to(device))
            return fake.cpu(), au_(fake, si.to(device)).cpu()

    fake_cpu, logit_cpu = run(state.au, state.im, "cpu")
    au_gpu, im_gpu = copy.deepcopy(state.au).cuda(), copy.deepcopy(state.im).cuda()
    fake_gpu, logit_gpu = run(au_gpu, im_gpu, "cuda")
    print(f"  fake {tuple(fake_gpu.shape)}, logits {logit_gpu.flatten().tolist()}")
    compare("im fake (card vs CPU)", fake_gpu, fake_cpu, SLICE_TOL, SLICE_TOL)
    compare("au logits (card vs CPU)", logit_gpu, logit_cpu, SLICE_TOL, SLICE_TOL)
    if fake_gpu.abs().max() > 1.0:
        fail("fake images outside [-1, 1]")


def run_train(seed: int, n_steps: int, counters) -> dict:
    from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg
    from optimalstrategiesagainstgenerativeattacks_torch.utils.config import ImageGameConfig

    cfg = ImageGameConfig(seed=seed)  # the flagship defaults
    print(f"  config: B={cfg.batch_size} img={cfg.img_size}x{cfg.img_size}x{cfg.img_channels} "
          f"style={cfg.style_dim} m={cfg.m} n={cfg.n} k={cfg.k} {cfg.compute_dtype}")
    rng = np.random.default_rng(seed)
    batches = [
        {key: torch.from_numpy(rng.integers(
            0, 256, (cfg.batch_size, n, cfg.img_size, cfg.img_size, cfg.img_channels),
            dtype=np.uint8)).cuda()
         for key, n in (("real_sample", cfg.n), ("leaked_sample", cfg.m), ("si_sample", cfg.k))}
        for _ in range(2)
    ]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.reset()
    # the user's entry point: the first call builds the state from cfg.seed
    # and takes the warm-up step; the second runs the timed steps, ending in
    # the host reading every metric
    t0 = time.perf_counter()
    state, history = timg.train_gim_imgs_steps(cfg, itertools.cycle(batches), 1, device="cuda")
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, steady = timg.train_gim_imgs_steps(cfg, itertools.cycle(batches[::-1]), n_steps - 1,
                                              state=state)
    step_s = (time.perf_counter() - t0) / (n_steps - 1)
    launches = {c.name: c.count for c in counters}
    for i, m in enumerate(history + steady):
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad:
            fail(f"step {i}: non-finite metrics {bad}")
        print(f"  step {i}: " + " ".join(f"{k}={m[k]:.4f}"
                                         for k in ("im_loss", "au_loss", "au_acc", "im_trained")))
    if state.step != n_steps - 1:
        fail(f"state.step {state.step} after {n_steps} steps")
    with torch.no_grad():
        real, leaked, si = timg.prepare_batch(cfg, batches[0], "cuda")
        fake = state.im(leaked, cfg.n, cfg.remove_noise_mean, generator=state.generator)
        logits = state.au(fake, si)
    if tuple(fake.shape) != (cfg.batch_size, cfg.n, cfg.img_size, cfg.img_size, cfg.img_channels):
        fail(f"fake shape {tuple(fake.shape)}")
    if not (torch.isfinite(fake).all() and fake.abs().max() <= 1.0 and torch.isfinite(logits).all()):
        fail("trained players give non-finite or out-of-range outputs")
    images = cfg.batch_size * (cfg.m + cfg.n + cfg.k)
    print(f"  warm-up step (state build, kernel compiles, cuDNN autotune): {warm_s:.2f} s")
    print(f"  steady steps 1..{n_steps - 1}: {1.0 / step_s:.3f} steps/s, "
          f"{images / step_s:.1f} images/s ({images} batch images per step), "
          f"{step_s * 1e3:.2f} ms/step, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{smi_line()}]")
    return launches


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args()
    if args.steps < 2:
        fail("--steps must be at least 2 (the first step is warm-up)")

    print("[1/5] card", flush=True)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    print(f"  {smi_line()}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    print("[2/5] build", flush=True)
    from optimalstrategiesagainstgenerativeattacks_torch.kernels import adain as k1
    from optimalstrategiesagainstgenerativeattacks_torch.kernels import attention as k2
    from optimalstrategiesagainstgenerativeattacks_torch.kernels import build

    t0 = time.perf_counter()
    so = build.build_cuda_library("attention")
    build.load_cuda_library("attention")
    print(f"  attention.cu -> {so.name}: {time.perf_counter() - t0:.2f} s")
    for line in open(str(so) + ".log").read().splitlines():
        if "registers" in line or "spill" in line:
            print(f"    ptxas: {line.strip()}")
    t0 = time.perf_counter()
    x = torch.randn(2, 4, 4, 4, device="cuda").contiguous(memory_format=torch.channels_last)
    s = torch.randn(2, 4, device="cuda")
    k1.ada_in_fwd_cuda(x, s, s)
    k1.ada_in_bwd_cuda(x, s, x)
    torch.cuda.synchronize()
    print(f"  triton adain kernels (first f32 compile): {time.perf_counter() - t0:.2f} s",
          flush=True)

    results = {
        name: {"name": name, "route": route, "source": src, "replaces": rep,
               "launches": 0, "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
        for name, route, src, rep in (
            ("adain_fwd", "triton", "optimalstrategiesagainstgenerativeattacks_torch/kernels/adain.py",
             "optimalstrategiesagainstgenerativeattacks_tpu/ops/pallas/adain_pallas.py:72"),
            ("adain_bwd", "triton", "optimalstrategiesagainstgenerativeattacks_torch/kernels/adain.py",
             "optimalstrategiesagainstgenerativeattacks_tpu/ops/pallas/adain_pallas.py:92"),
            ("attention_core_fwd", "cuda",
             "optimalstrategiesagainstgenerativeattacks_torch/kernels/csrc/attention.cu",
             "optimalstrategiesagainstgenerativeattacks_tpu/ops/pallas/attention_pallas.py:52"),
        )
    }

    print("[3/5] kernels vs plain versions at the flagship sites "
          f"(f32 atol/rtol {TOL[torch.float32]}, bf16 {TOL[torch.bfloat16]}; "
          "pass: max|err| <= atol + rtol*max|ref|)", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    check_adain(gen, results)
    check_attention(gen, results)
    torch.cuda.synchronize()

    print(f"[4/5] slice parity: flagship widths, f32, TF32 off, B=2, fixed z "
          f"(tol {SLICE_TOL} x max(1, max|ref|))", flush=True)
    check_slice(args.seed)

    print(f"[5/5] train: {args.steps} flagship steps", flush=True)
    counters = (k1.FWD_LAUNCHES, k1.BWD_LAUNCHES, k2.FWD_LAUNCHES)
    launches = run_train(args.seed, args.steps, counters)
    expected = {
        "adain_fwd": sum(ADAIN_SITES.values()) * args.steps,
        "adain_bwd": sum(ADAIN_SITES.values()) * args.steps,
        "attention_core_fwd": sum(ATTENTION_SITES.values()) * args.steps,
    }
    print(f"  launches {launches}, expected {expected}")
    for name, want in expected.items():
        if launches[name] != want:
            fail(f"{name}: {launches[name]} launches, expected {want}")
        results[name]["launches"] = launches[name]

    print(smi_line())
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
