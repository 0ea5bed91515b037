"""Drive the PyTorch port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--steps N]

Phases (each prints its lines; the first failure exits non-zero):
  1. card:    require CUDA; print the card's name and power limit;
  2. build:   build the hand-written kernels from the checkout's sources;
              print each CUDA kernel's registers and spills (ptxas) and
              the tensor-core instructions of the bf16 attention kernel
              (cuobjdump);
  3. kernels: each kernel against its plain PyTorch version at every site
              the flagship, the VoxCeleb and the study config's (the
              multi-seed CLI's defaults) train steps and eval batches give
              it, in bf16 and f32 (the study config's sites are first
              recorded from one of its train steps and eval batches and
              must be the tables'); then, in bf16, the device time of the kernel, its
              plain version and (attention) the one PyTorch call for the
              same function, each call after a write of a 128 MB buffer
              that evicts L2, from torch.profiler's CUDA kernel records
              (median of the calls), beside the bound: bytes over 3.35 TB/s
              or flops over the peak rate, whichever is larger; each AdaIN
              site also prints both kernels' tile plans and the time of
              F.instance_norm, the nearest library op (not the same
              function);
  4. slice:   the flagship impersonator and authenticator forwards in f32
              on the card (kernels) against the same models on the CPU
              (plain versions), same weights, fixed noise; then every SN
              conv site of one bf16 train step of the flagship, with
              use_img_att, VoxCeleb and the multi-seed CLI's config, run as
              the port runs it (plain, the folded stride-2 and transposed
              convs, each part of the split img2img input), forward and
              backward, against the same conv in f32 without cuDNN, and at
              each VoxCeleb authenticator site
              R1's double backward (the gradient of <grad_x conv, v> with
              respect to the weight and the cotangent) the same way; then
              the bf16 rounding sites (tests/bf16_sites_support.py) at the flagship
              and VoxCeleb widths: each chain in bf16 on the card against
              the same chain in f32 on the CPU, mean error at most 1.5 x
              the CPU bf16 chain's (which tests/test_torch_bf16_sites.py
              holds to XLA's compile of the JAX chain), where XLA keeps the
              value in f32 under the card's error with the value rounded,
              and where it rounds equal to that; then the bf16 pool
              (``ops/image_ops.py:Bf16Pool``, bf16 sums as XLA's compile of
              the reference pools) at every shape and layout of a bf16 pool
              in those configs' steps: output, gradient and R1's double
              backward on the card bit-equal to the CPU, the output in
              ``F.avg_pool2d``'s layout and the gradient in its gradient's;
  5. R1:      the R1 penalty and the authenticator's parameter gradients at
              the VoxCeleb widths in f32 on the card (kernels, and the
              attention core's backward differentiated again) against the
              same on the CPU in f64 (plain versions), same weights and
              inputs, taking the card's branch at each LeakyReLU and max
              pool; the CPU's own f32 run printed beside it;
  6. train:   flagship train steps (B=128, 32x32x1, style 512, bf16) on
              uint8 episodes drawn from --seed; metrics must be finite and
              every kernel of the path must have launched its expected
              count; prints steps/s and images/s;
  7. vox:     the VoxCeleb config (B=128, 64x64x3, style 512, R1 with
              reg_param 10, bf16) through the loop, ``train_gim_imgs``, on
              an in-memory uint8 dataset drawn from --seed: a checkpoint
              inside the run, the step-0 images, diagnostics and eval,
              then ``sample`` and ``eval_step`` once each, steady steps
              (steps/s, images/s, peak memory) and a resume from the
              checkpoint for one step; every launch count must be the one
              expected;
  8. eval:    the flagship eval grid: 2 flagship steps and a checkpoint, the
              Siamese baseline trained for 4 batch-hard steps (then its
              steps/s), and ``eval_authentication_task`` (gim and siamese
              authenticators x gim, replay and rnd_src attackers, batches
              of 64, calibration columns, score dumps) over 520 in-memory
              episodes; checks the CSV, 520 finite scores a side a row, the
              AUCs and every launch count (K1b none); prints each row's
              seconds and episodes/s; then the gim and Siamese scores of one
              batch, f32, card against CPU;
  9. vox eval: ArcFace (ir_se, 50 layers, 64x64x3, emb 512) trained for 3
              steps of 128 (then its steps/s), and the grid with the ArcFace
              baseline against phase 7's checkpoint over 160 episodes, with
              the same checks; the ArcFace scores card against CPU;
 10. gaussian: the Gaussian game at the README's Nash-check config (d=10,
              m1 n5 k10, head x8, B=4096): one f32 step card against CPU at
              reg_param 0 and 5 (metrics and parameters after Adam), then
              ``train_gim_gaussian`` for 3000 steps with checkpoints inside,
              a resume from one, and timed chunks of 100 steps (steps/s,
              episodes/s); prints the final au_acc beside the closed-form
              Nash value; no kernel may launch;
 11. img_att: the flagship impersonator with ``use_img_att`` in f32, card
              against CPU, then bf16 flagship train steps with it: finite
              metrics and fakes (img_att's blend is not tanh-bounded, in the
              reference neither: its range is printed), phase 6's launch
              counts, and its steps/s beside phase 6's.
 12. feed:    the data feeding at the flagship (964 x 20 images of 32x32x1)
              and VoxCeleb (2000 x 20 of 64x64x3, mirrored) sizes on
              in-memory seeded sets: the device loader's batches traced to
              their classes' frames (distinct, flips seen where the set
              mirrors) and its epochs' classes against the numpy permutation;
              prefetched batches equal to the host loader's byte for byte;
              the device loader's time a batch alone (CUDA events); then
              train steps fed by the device loader, the host loader with
              prefetch and with prefetch_depth 0, run A B C C B A, steps/s
              each, every run's launches checked;
 13. multiseed: ``train_multiseed_gim_imgs`` at the flagship with 2 seeds on
              phase 12's set (launches 2 x steps x one step's, per-seed
              checkpoints, one restored by the eval CLI's restore and scored
              against its state), then multi-steps/s, seed-steps/s and peak
              memory; 2 f32 multi-seed steps against single-seed runs of each
              seed on the same batches; then the multi-seed CLI's default
              config (img 16, style 64, B16) with 3 seeds: its launches and
              steps/s beside one seed's.
 14. inventory: the legacy AdaIN blocks at the flagship generator's widths
              (5 AdaResBlock at 4x4x512, AdaResBlockUp 512 -> 256 -> 128 -> 1,
              B' = 640, bf16): steps of power iteration, forward, backward
              and Adam, finite, K1 16 and K1b 16 launches a step, K2 none,
              steps/s; the same stack in f32 on the card against the CPU
              in f64 (output and parameter gradients), and grad2_penalty
              through it with its parameter gradients (AdaIN's double
              backward: K1b for the first order); the StyleGAN kit at 32x32,
              style 512 (bf16 B = 640, finite, no kernel; f32 outputs on the
              card against the CPU in f64 with the same noise injected, the
              gradients printed beside the CPU's f32 ones and beside f64
              with the parameters moved by one f32 rounding;
              blur3x3 in bf16 against f32 without cuDNN); the set
              stats, ResMLP/ResMLP2, pixel_norm, the pools, freeze + Adam and
              accumulate, f32 card against CPU at width 512
              (``inventory_launches``: the legacy stack's bf16 run).
 15. hard study: 400 steps of seed 2 at the study config (img 16, style 64,
              B16, bf16) through ``train_multiseed_gim_imgs`` on the hard
              glyph set (``scripts/make_hard_glyph_ds.py`` at its defaults,
              built in the background from phase 3 on), then the eval grid
              on its val split: AUC and accuracy of each attacker, steps/s,
              the launches of the run and of each row; fails on a non-finite
              metric or a replay AUC under 0.9 (``study_launches``: the
              training run).
 16. data parallel: ``scripts/torch_data_parallel.py check``: k ranks over
              NCCL, one a card, with k >= 2 visible cards; with one, two
              ranks on it over gloo (NCCL refuses two ranks on one card);
              at the flagship with a global B of 128: 2 f32 steps (TF32 off,
              cuDNN deterministic) held to one process on the same batches
              and noise within the JAX suite's mesh tolerances
              (``tests/test_image_training.py:159-174``), every parameter,
              u/v and Adam moment bit-equal across ranks, then 4 bf16 steps
              finite with one step's launches a step on every rank, and
              steps/s (``dp_launches``: rank 0's bf16 steps).
 17. model axis: ``scripts/torch_data_parallel.py check --model_parallel 2``:
              the ranks laid out (data, model) and the authenticator head's six
              matrices sharded over the model axis (``parallel/tensor.py``,
              ``min_size`` 1024); on one card two ranks over gloo (data 1 x
              model 2), with four cards data 2 x model 2 over NCCL: (a) 2
              flagship f32 steps (TF32 off, cuDNN deterministic, global B 128)
              held to one process within the JAX suite's mesh tolerances;
              (b) VoxCeleb bf16 R1 steps (global B 32 on one card, 128 on
              four), a warm-up and 2 timed: finite, one card's launches a
              step on every rank (18 + 18 + 9), steps/s and the model-axis
              collectives' ms a step a rank; after
              each, replicated tensors bit-equal on every rank and slices on
              their data ranks (``tp_launches``: rank 0's VoxCeleb steps).
The second-to-last line is a JSON summary of the kernels, with times per
flagship, VoxCeleb and study step and per gim-vs-gim eval batch of each
config (sum over sites of ms x launches), and the launches of each run
(``multiseed_launches``: phase 13's flagship run); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import csv
import io
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# per-step launches at the flagship config, by site shape and input dtype.  An AdaIN
# reads its conv in f32 (SNConv's f32_out) and the up blocks' sums and the attention's
# output in f32, as XLA's compile of the JAX step does; only the first up block's first
# AdaIN reads a bf16 value, the res stack's loop carry (tests/bf16_sites_support.py)
ADAIN_SITES = {  # (B', C, H, W, dtype): launches per step (forward; backward the same)
    (640, 512, 4, 4, "f32"): 10,   # 5 res blocks x 2
    (640, 512, 4, 4, "bf16"): 1,   # up_0 first
    (640, 256, 8, 8, "f32"): 2,    # up_0 second, up_1 first
    (640, 128, 16, 16, "f32"): 2,  # up_1 second, up_2 first (behind the attention)
    (640, 1, 32, 32, "f32"): 1,    # up_2 second
}
ATTENTION_SITES = {  # (B', N, C, CQ): forward launches per step
    (1920, 64, 256, 32): 2,   # authenticator encoders, au phase
    (1280, 64, 256, 32): 2,   # frozen authenticator encoders, im phase
    (128, 64, 256, 32): 2,    # impersonator encoders
    (640, 64, 128, 16): 1,    # env decoder
    (640, 64, 256, 32): 1,    # img2img down stage
    (640, 256, 128, 16): 1,   # img2img up stage
}
# per-step launches at the VoxCeleb config (64x64x3), by site shape
VOX_ADAIN_SITES = {
    (640, 512, 4, 4, "f32"): 10,   # 5 res blocks x 2
    (640, 512, 4, 4, "bf16"): 1,   # up_0 first
    (640, 256, 8, 8, "f32"): 2,    # up_0 second, up_1 first
    (640, 128, 16, 16, "f32"): 2,  # up_1 second, up_2 first (behind the attention)
    (640, 64, 32, 32, "f32"): 2,   # up_2 second, up_3 first
    (640, 3, 64, 64, "f32"): 1,    # up_3 second
}
VOX_ATTENTION_SITES = {
    (1920, 256, 128, 16): 2,  # authenticator encoders, au phase (and under R1's double backward)
    (1280, 256, 128, 16): 2,  # frozen authenticator encoders, im phase
    (128, 256, 128, 16): 2,   # impersonator encoders
    (640, 64, 256, 32): 1,    # env decoder
    (640, 256, 128, 16): 2,   # img2img down and up stages
}
# launches of one call of each entry point at the VoxCeleb config with B=128
# (sample: one episode); the kernels' names as their LaunchCounters have them
VOX_LAUNCHES = {
    "train_step": {"adain_fwd": sum(VOX_ADAIN_SITES.values()),
                   "adain_bwd": sum(VOX_ADAIN_SITES.values()),
                   "attention_core_fwd": sum(VOX_ATTENTION_SITES.values())},
    # the impersonator's forward (all AdaIN sites, 5 attention) and 4 encoder passes
    "eval_step": {"adain_fwd": sum(VOX_ADAIN_SITES.values()), "adain_bwd": 0,
                  "attention_core_fwd": 9},
    "diag": {"adain_fwd": 0, "adain_bwd": 0, "attention_core_fwd": 2},
    "sample": {"adain_fwd": sum(VOX_ADAIN_SITES.values()), "adain_bwd": 0,
               "attention_core_fwd": 5},
}
VOX_STEPS = 3  # timed steady VoxCeleb steps after the loop
# the eval grid's batch of 64 episodes (n = k = 5): one authenticator call
# encodes test + si = 640 images, one impersonator call generates B' = 320;
# sites of one gim-vs-gim batch (two authenticator calls, one impersonator call)
EVAL_BATCH = 64
EVAL_EPISODES, VOX_EVAL_EPISODES = 520, 160  # 8 batches + a padded ninth; 2 + a padded third
ARCFACE_BATCH = 128
EVAL_DEVICE = "cuda"  # of phases 8 and 9
FEED_DEVICE = "cuda"  # of phases 12 and 13
EVAL_ADAIN_SITES = {  # per impersonator call
    (320, 512, 4, 4, "f32"): 10,
    (320, 512, 4, 4, "bf16"): 1,
    (320, 256, 8, 8, "f32"): 2,
    (320, 128, 16, 16, "f32"): 2,
    (320, 1, 32, 32, "f32"): 1,
}
EVAL_ATTENTION_SITES = {
    (640, 64, 256, 32): 4,    # authenticator encoders, 2 per call
    (64, 64, 256, 32): 2,     # impersonator encoders on the leaked images
    (320, 64, 128, 16): 1,    # env decoder
    (320, 64, 256, 32): 1,    # img2img down stage
    (320, 256, 128, 16): 1,   # img2img up stage
}
VOX_EVAL_ADAIN_SITES = {
    (320, 512, 4, 4, "f32"): 10,
    (320, 512, 4, 4, "bf16"): 1,
    (320, 256, 8, 8, "f32"): 2,
    (320, 128, 16, 16, "f32"): 2,
    (320, 64, 32, 32, "f32"): 2,
    (320, 3, 64, 64, "f32"): 1,
}
VOX_EVAL_ATTENTION_SITES = {
    (640, 256, 128, 16): 4,   # authenticator encoders, 2 per call
    (64, 256, 128, 16): 2,    # impersonator encoders on the leaked images
    (320, 64, 256, 32): 1,    # env decoder
    (320, 256, 128, 16): 2,   # img2img down and up stages
}
# per-step launches at the multi-seed CLI's defaults, the head-to-head studies' config
# (img 16, style 64, B16, n = k = 5: channels [1, 64, 64], attention at 8x8 and, in the
# env decoder, 4x4; phase 3 records them from a train step and an eval batch)
STUDY_ADAIN_SITES = {
    (80, 64, 4, 4, "f32"): 10,     # 5 res blocks x 2
    (80, 64, 4, 4, "bf16"): 1,     # up_0 first
    (80, 64, 8, 8, "f32"): 2,      # up_0 second; up_1 first (behind the attention)
    (80, 1, 16, 16, "f32"): 1,     # up_1 second
}
STUDY_ATTENTION_SITES = {
    (240, 64, 64, 8): 2,      # authenticator encoders, au phase
    (160, 64, 64, 8): 2,      # frozen authenticator encoders, im phase
    (16, 64, 64, 8): 2,       # impersonator encoders
    (80, 16, 64, 8): 1,       # env decoder
    (80, 64, 64, 8): 2,       # img2img down and up stages
}
STUDY_EVAL_ADAIN_SITES = {
    (320, 64, 4, 4, "f32"): 10,
    (320, 64, 4, 4, "bf16"): 1,
    (320, 64, 8, 8, "f32"): 2,
    (320, 1, 16, 16, "f32"): 1,
}
STUDY_EVAL_ATTENTION_SITES = {
    (640, 64, 64, 8): 4,      # authenticator encoders, 2 per call
    (64, 64, 64, 8): 2,       # impersonator encoders on the leaked images
    (320, 16, 64, 8): 1,      # env decoder
    (320, 64, 64, 8): 2,      # img2img down and up stages
}
AU_CALL_ATTENTION = 2  # K2 launches of one GIM authenticator call
IM_TYPES = ("gim", "replay", "rnd_src")
# key prefixes of the kernels' JSON and the unit each sums over; the site
# tables of each, in this order
PER_CONFIG = {"": "flagship step", "vox_": "VoxCeleb step",
              "eval_": "flagship eval batch (gim vs gim)",
              "vox_eval_": "VoxCeleb eval batch (gim vs gim)",
              "study_": "study step", "study_eval_": "study eval batch (gim vs gim)"}
ADAIN_TABLES = (ADAIN_SITES, VOX_ADAIN_SITES, EVAL_ADAIN_SITES, VOX_EVAL_ADAIN_SITES,
                STUDY_ADAIN_SITES, STUDY_EVAL_ADAIN_SITES)
ATTENTION_TABLES = (ATTENTION_SITES, VOX_ATTENTION_SITES, EVAL_ATTENTION_SITES,
                    VOX_EVAL_ATTENTION_SITES, STUDY_ATTENTION_SITES, STUDY_EVAL_ATTENTION_SITES)
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 2.0 ** -6)}  # (atol, rtol)
SLICE_TOL = 1e-3  # f32 forward, card vs CPU, TF32 off: |err| <= tol * max(1, max|ref|)
# f32 R1 penalty and authenticator gradients, card vs CPU, TF32 off: per tensor
# |err| <= R1_TOL * max|ref| of the tensor + R1_TOL * 1e-3 * max|ref| of the player
R1_TOL = 1e-3
# bf16 SN convs on the card against f32 without cuDNN: several bf16 roundings of a sum
CONV_TOL = 2e-2
# the bf16 rounding sites: the card's bf16 chain's mean error against the CPU's f32
# chain, at most this times the CPU bf16 chain's (the CPU tests' ratio to XLA's)
SITES_RATIO = 1.5
SITES_BIAS_SCALE = 30.0  # conv and linear biases: the rounding of an offset value shows

# the Gaussian game at the README's Nash-check config (d=10, m1 n5 k10, head x8, B=4096)
GAUSS_CONFIG = dict(src_dim=10, m=1, n=5, k=10, au_hidden_scale=8, batch_size=4096,
                    log_every=100)
GAUSS_STEPS, GAUSS_SAVE_EVERY = 3000, 1000  # the loop's steps; a checkpoint each 1000
GAUSS_TIMED_CHUNKS = 10  # chunks of log_every steps timed after the loop
# f32 Gaussian step, card vs CPU, TF32 off: each metric |err| <= GAUSS_TOL * max(1, |ref|),
# the accuracies within 2 / B (a logit within rounding of 0 may take the other side);
# each parameter |err| <= GAUSS_TOL * max|ref| of its tensor where its gradient is above
# 1e-6 of the player's largest, else within 2 lr (Adam's first step is lr g / (|g| + eps))
GAUSS_TOL = 1e-4
# phase 12: seeded in-memory sets (classes x images a class): Omniglot's 964 x 20 at
# 32x32x1 (19.7 MB) and 2000 identities x 20 frames at 64x64x3 (492 MB)
FEED_SETS = {"flagship": (964, 20), "vox": (2000, 20)}
FEED_EXAMPLES_PER_CLASS = 100  # the CLIs' ds_n_examples_per_cls
FEED_STEPS = {"flagship": 8, "vox": 3}  # timed steps a run, after one that fills the pipeline
FEED_ORDER = ("device", "prefetch", "sync", "sync", "prefetch", "device")  # A B C C B A
FEED_ASSEMBLY_BATCHES = 50  # device-loader batches timed alone
FEED_CHECKED_EPISODES = 16  # episodes a batch whose frames are traced to their class
FEED_PREFETCH_CHECKED = 4  # prefetched batches compared with the host loader's
# phase 13: flagship multi-seed; the multi-seed CLI's default config
MULTISEED_SEEDS, MULTISEED_STEPS, MULTISEED_TIMED = 2, 4, 4
SMALL_SEEDS, SMALL_STEPS, SMALL_TIMED = 3, 10, 10
# f32 multi-seed against single-seed steps on the card: the Gaussian phase's rule
MULTISEED_TOL = 1e-4
MULTISEED_FLIPS = 4  # a tensor's entries whose Adam step may take the other sign (as in the
# R1 train-step test of the CPU suite)
N_PHASES = 17

# NVIDIA H100 SXM data sheet: HBM rate, dense bf16 tensor-core and f32 CUDA-core peaks
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16_tensor": 989e12, "f32": 67e12}
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
L2_FLUSH_BYTES = 128 << 20  # > the 50 MB L2: each timed call finds its inputs cold
TIMED_CALLS = 20


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def bound(n_bytes: int, flops: int, rate: str) -> tuple:
    """(least time in ms, "bytes" or "operations") for this much work on the card."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[rate]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


class DeviceTimer:
    """Device time of a call, from torch.profiler's CUDA activity records.

    Each call follows a bitwise_not over a 128 MB buffer: it evicts L2 and
    marks in the trace where the call starts.  A call's time is the sum of
    the durations of the device activities (kernels, memsets, copies)
    between its marker and the next; the median over TIMED_CALLS calls.
    Returns {tag: (ms, names of the call's kernels)}.

    The trace may lack some activities: on an H100, two runs of four in one
    call found 13 and 9 fewer markers than calls when every job of a phase
    went into one trace.  So the jobs are traced a few at a time, and a
    trace that lacks one is taken again, up to PROFILES times.
    """

    PROFILES = 3
    JOBS_PER_PROFILE = 5
    THROWAWAY_CALLS = 10

    def __init__(self):
        self.jobs = {}
        self.flush = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")

    def add(self, tag: str, fn) -> None:
        self.jobs[tag] = fn

    def run(self) -> dict:
        for fn in self.jobs.values():  # warm up: compiles, cuBLAS / cuDNN heuristics
            fn()
        torch.cuda.synchronize()
        tags, out = list(self.jobs), {}
        for i in range(0, len(tags), self.JOBS_PER_PROFILE):
            group = {tag: self.jobs[tag] for tag in tags[i:i + self.JOBS_PER_PROFILE]}
            for attempt in range(1, self.PROFILES + 1):
                got, problem = self._profile(group)
                if got is not None:
                    break
                print(f"  timer: profile {attempt} of {self.PROFILES}: {problem}", flush=True)
            else:
                fail(f"timer: {problem}")
            out.update(got)
        self.jobs.clear()
        return out

    def _profile(self, jobs: dict) -> tuple:
        """One traced run of the jobs: ({tag: (ms, kernels)}, None), or (None, problem)."""
        from torch.profiler import ProfilerActivity, profile

        expected = TIMED_CALLS * len(jobs)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            # throwaway calls first: the trace may miss the first activities
            for _ in range(self.THROWAWAY_CALLS):
                torch.bitwise_not(self.flush, out=self.flush)
                next(iter(jobs.values()))()
            torch.cuda.synchronize()
            for fn in [fn for fn in jobs.values() for _ in range(TIMED_CALLS)]:
                torch.bitwise_not(self.flush, out=self.flush)
                fn()
            torch.cuda.synchronize()
        device = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        calls = []
        for e in device:
            if "bitwise_not" in e.name:
                calls.append([])
            elif calls:
                calls[-1].append(e)
        if len(calls) < expected:
            return None, f"{len(calls)} marked calls in the trace, expected {expected} and more"
        calls = calls[-expected:]
        out = {}
        for k, tag in enumerate(jobs):
            mine = calls[k * TIMED_CALLS:(k + 1) * TIMED_CALLS]
            times = [sum(e.time_range.end - e.time_range.start for e in c) for c in mine]
            if min(times) <= 0.0 or len({len(c) for c in mine}) != 1:
                return None, f"{tag}: calls with no device time, or that ran different kernels"
            out[tag] = (statistics.median(times) / 1e3, {e.name for c in mine for e in c})
        return out, None


def sdpa_backend(kernels: set) -> str:
    """SDPA's backend, read from the names of the kernels it ran."""
    for key, name in (("flash", "flash"), ("fmha", "efficient"), ("cudnn", "cudnn")):
        if any(key in k.lower() for k in kernels):
            return name
    return "math"


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


def site_line(tag: str, k_ms: float, p_ms: float, bound_ms: float, bound_by: str,
              lib: str = "", note: str = "") -> None:
    print(f"    {tag}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms{lib}, bound "
          f"{bound_ms * 1e3:.2f} us ({bound_by}), share of bound {bound_ms / k_ms:.3f}{note}")


def tile_text(cfg: dict) -> str:
    """An AdaIN tile plan: mode, tile [samples x rows (or elements) x channels],
    warps, elements of each input a thread, programs."""
    from optimalstrategiesagainstgenerativeattacks_torch.kernels.adain import MODE_NAMES

    tile = cfg["BLOCK_B"] * cfg["BLOCK_HW"] * cfg["BLOCK_C"]
    return (f"{MODE_NAMES[cfg['MODE']]} {cfg['BLOCK_B']}x{cfg['BLOCK_HW']}x{cfg['BLOCK_C']}, "
            f"{cfg['num_warps']} warps, {tile // (32 * cfg['num_warps'])} a thread, "
            f"{math.prod(cfg['grid'])} programs")


def launches_key(prefix: str) -> str:
    """The kernels' JSON key of launches per unit: a train step, or an eval batch."""
    return f"{prefix}launches_per_{'batch' if prefix.endswith('eval_') else 'step'}"


def add_site(results: dict, prefix: str, name: str, per_step: int, k_ms: float, p_ms: float,
             bound_ms: float, bound_by: str, lib_ms=None) -> None:
    """Add one site's times, x its launches per unit, to a kernel's per-unit sums
    of one config (``prefix``: a key of PER_CONFIG)."""
    r = results[name]
    r[launches_key(prefix)] += per_step
    r[f"{prefix}ms"] += per_step * k_ms
    r[f"{prefix}plain_ms"] += per_step * p_ms
    r[f"{prefix}bound_ms"] += per_step * bound_ms
    r["_bound_by"][prefix][bound_by] += per_step * bound_ms
    if lib_ms is not None:
        r[f"{prefix}library_ms"] = (r[f"{prefix}library_ms"] or 0.0) + per_step * lib_ms


def per_step_text(site, *tables) -> str:
    return ", ".join(f"x{t[site]} per {name}" for name, t in zip(PER_CONFIG.values(), tables)
                     if site in t)


def union(*tables) -> list:
    """The sites of several per-step tables, each once, in order of first appearance."""
    return list(dict.fromkeys(site for t in tables for site in t))


def check_adain(gen: torch.Generator, results: dict, timer: DeviceTimer) -> dict:
    """Check both AdaIN kernels at every flagship and VoxCeleb site shape in f32 and in
    bf16; time each site in the dtype the steps give it.

    Returns {(B', C, H, W, dtype): {kernel: (ms, plain ms, bound ms, bound by, library ms)}}.
    """
    import torch.nn.functional as F

    from optimalstrategiesagainstgenerativeattacks_torch.kernels import adain as k1

    sites, times = [], {}
    timed = set(union(*ADAIN_TABLES))
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = TOL[dtype]
        for b, c, h, w in dict.fromkeys(site[:4] for site in timed):
            def rand(*shape):
                return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

            site = (b, c, h, w, dtype_name(dtype))
            x = rand(b, c, h, w).contiguous(memory_format=torch.channels_last)
            g = rand(b, c, h, w).contiguous(memory_format=torch.channels_last)
            ms, ss = rand(b, c), rand(b, c)
            tag = f"adain {dtype_name(dtype)} [{b},{h},{w},{c}]"
            print(f"  {tag} ({per_step_text(site, *ADAIN_TABLES) or 'no step runs it'})")
            fwd_err = compare("fwd", k1.ada_in_fwd_cuda(x, ms, ss), k1.ada_in_ref(x, ms, ss),
                              atol, rtol)
            got = k1.ada_in_bwd_cuda(x, ss, g)
            ref = k1.ada_in_bwd_ref(x, ss, g)
            bwd_err = max(compare(f"bwd {n}", a, r_, atol, rtol)
                          for n, a, r_ in zip(("dx", "dmean", "dstd"), got, ref))
            results["adain_fwd"]["max_abs_err"] = max(results["adain_fwd"]["max_abs_err"], fwd_err)
            results["adain_bwd"]["max_abs_err"] = max(results["adain_bwd"]["max_abs_err"], bwd_err)
            if site not in timed:  # only the dtype a step gives the site is timed
                continue
            timer.add(f"{tag} fwd", lambda x=x, ms=ms, ss=ss: k1.ada_in_fwd_cuda(x, ms, ss))
            timer.add(f"{tag} fwd plain", lambda x=x, ms=ms, ss=ss: k1.ada_in_ref(x, ms, ss))
            timer.add(f"{tag} bwd", lambda x=x, ss=ss, g=g: k1.ada_in_bwd_cuda(x, ss, g))
            timer.add(f"{tag} bwd plain", lambda x=x, ss=ss, g=g: k1.ada_in_bwd_ref(x, ss, g))
            # yardstick only: per-(sample, channel) statistics as the channels of
            # one instance, NCHW, with the styles as its affine
            xn = x.contiguous().view(1, b * c, h, w)
            timer.add(f"{tag} instance_norm", lambda xn=xn, ms=ms, ss=ss: F.instance_norm(
                xn, weight=ss.reshape(-1), bias=ms.reshape(-1)))
            sites.append((tag, site, dtype))

    print("  timing the sites (device time, L2 evicted before each call)", flush=True)
    t = timer.run()
    for tag, site, dtype in sites:
        b, c, h, w, _ = site
        print(f"  {tag} ({per_step_text(site, *ADAIN_TABLES)})")
        times[site] = {}
        for d, name, n_bytes, flops in (
                ("fwd", "adain_fwd", k1.ada_in_fwd_bytes(b, h, w, c, dtype),
                 k1.ada_in_fwd_flops(b, h, w, c)),
                ("bwd", "adain_bwd", k1.ada_in_bwd_bytes(b, h, w, c, dtype),
                 k1.ada_in_bwd_flops(b, h, w, c))):
            k_ms, p_ms = t[f"{tag} {d}"][0], t[f"{tag} {d} plain"][0]
            b_ms, b_by = bound(n_bytes, flops, "f32")
            plan = k1.tile_config(b, h * w, c, k1.PER_THREAD[d])
            site_line(d, k_ms, p_ms, b_ms, b_by, note=f"; tile {tile_text(plan)}")
            times[site][name] = (k_ms, p_ms, b_ms, b_by, None)
        in_ms, in_ops = t[f"{tag} instance_norm"]
        print(f"    nearest library op, not the same function (biased variance, eps inside "
              f"the sqrt): F.instance_norm over [1, B'C, H, W] NCHW {in_ms:.4f} ms, kernels "
              f"{sorted(name[:90] for name in in_ops)}")
    return times


def check_attention(gen: torch.Generator, results: dict, timer: DeviceTimer) -> dict:
    """Check the attention core at every flagship and VoxCeleb site; time the bf16 sites.

    Returns {(B', N, C, CQ): {"attention_core_fwd": (ms, plain ms, bound ms, bound by,
    library ms)}}.
    """
    import torch.nn.functional as F

    from optimalstrategiesagainstgenerativeattacks_torch.kernels import attention as k2

    sites, times = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = TOL[dtype]
        for b, n, c, cq in union(*ATTENTION_TABLES):
            def rand(*shape, scale=1.0):
                return (scale * torch.randn(*shape, generator=gen, device="cuda")).to(dtype)

            f, g, h = rand(b, n, cq, scale=0.5), rand(b, n, cq, scale=0.5), rand(b, n, c)
            dout = rand(b, n, c)
            tag = f"attention {dtype_name(dtype)} B'={b} N={n} C={c} CQ={cq}"
            print(f"  {tag} ({per_step_text((b, n, c, cq), *ATTENTION_TABLES)})")
            fwd_err = compare("fwd", k2.attention_core_cuda(f, g, h),
                              k2.attention_core_ref(f, g, h), atol, rtol)
            leaves = [t.clone().requires_grad_(True) for t in (f, g, h)]
            k2.attention_core(*leaves).backward(dout)
            leaves_ref = [t.clone().requires_grad_(True) for t in (f, g, h)]
            k2.attention_core_ref(*leaves_ref).backward(dout)
            for name, a, r_ in zip(("df", "dg", "dh"), leaves, leaves_ref):
                compare(f"bwd {name}", a.grad, r_.grad, atol, rtol)
            del leaves, leaves_ref
            r = results["attention_core_fwd"]
            r["max_abs_err"] = max(r["max_abs_err"], fwd_err)
            if dtype != torch.bfloat16:
                continue
            timer.add(f"{tag} kernel", lambda f=f, g=g, h=h: k2.attention_core_cuda(f, g, h))
            timer.add(f"{tag} plain", lambda f=f, g=g, h=h: k2.attention_core_ref(f, g, h))
            # yardstick only: standard attention with Q = g, K = f, V = h at scale 1
            timer.add(f"{tag} library", lambda f=f, g=g, h=h: F.scaled_dot_product_attention(
                g, f, h, scale=1.0))
            sites.append((tag, (b, n, c, cq)))

    print("  timing the bf16 sites (device time, L2 evicted before each call)", flush=True)
    t = timer.run()
    for tag, (b, n, c, cq) in sites:
        print(f"  {tag} ({per_step_text((b, n, c, cq), *ATTENTION_TABLES)})")
        k_ms, p_ms = t[f"{tag} kernel"][0], t[f"{tag} plain"][0]
        lib_ms, lib_ops = t[f"{tag} library"]
        b_ms, b_by = bound(k2.attention_core_bytes(b, n, c, cq, torch.bfloat16),
                           k2.attention_core_flops(b, n, c, cq), "bf16_tensor")
        site_line("fwd", k_ms, p_ms, b_ms, b_by,
                  f", library {lib_ms:.4f} ms (SDPA, {sdpa_backend(lib_ops)} backend)")
        print(f"      SDPA kernels: {sorted(name[:90] for name in lib_ops)}")
        times[(b, n, c, cq)] = {"attention_core_fwd": (k_ms, p_ms, b_ms, b_by, lib_ms)}
    return times


@contextlib.contextmanager
def kernel_sites():
    """Record the site of each kernel launch inside the block, by kernel: AdaIN's
    (B', C, H, W, input dtype) and the attention core's (B', N, C, CQ), and the
    dtypes seen."""
    from optimalstrategiesagainstgenerativeattacks_torch.kernels import adain as k1
    from optimalstrategiesagainstgenerativeattacks_torch.kernels import attention as k2

    sites = {"adain_fwd": {}, "adain_bwd": {}, "attention_core_fwd": {}, "dtypes": set()}

    def seen(name, site, dtype):
        sites[name][site] = sites[name].get(site, 0) + 1
        sites["dtypes"].add((name, site, dtype_name(dtype)))

    fwd, bwd, attention = k1.ada_in_fwd_cuda, k1.ada_in_bwd_cuda, k2.attention_core_cuda

    def fwd_(x, *args, **kw):
        seen("adain_fwd", (*x.shape, dtype_name(x.dtype)), x.dtype)
        return fwd(x, *args, **kw)

    def bwd_(x, *args, **kw):
        seen("adain_bwd", (*x.shape, dtype_name(x.dtype)), x.dtype)
        return bwd(x, *args, **kw)

    def attention_(f, g, h):
        seen("attention_core_fwd", (f.shape[0], f.shape[1], h.shape[2], f.shape[2]), h.dtype)
        return attention(f, g, h)

    k1.ada_in_fwd_cuda, k1.ada_in_bwd_cuda, k2.attention_core_cuda = fwd_, bwd_, attention_
    try:
        yield sites
    finally:
        k1.ada_in_fwd_cuda, k1.ada_in_bwd_cuda, k2.attention_core_cuda = fwd, bwd, attention


def study_config(seeds, outdir: str = "-", dataset_root: str = "-"):
    """(the multi-seed CLI's parsed defaults for ``seeds``, their ImageGameConfig at the
    first seed): the head-to-head studies' config."""
    from optimalstrategiesagainstgenerativeattacks_torch import train_multiseed_gim_on_imgs as tcli
    from optimalstrategiesagainstgenerativeattacks_torch.utils.config import ImageGameConfig

    args = tcli.build_parser().parse_args(
        ["-o", outdir, "--dataset_root", dataset_root, "--seeds", *map(str, seeds)])
    return args, ImageGameConfig.from_dict(dict(vars(args), seed=seeds[0]))


def check_study_sites(seed: int) -> None:
    """Record the kernels' sites in one train step and one eval batch (gim vs gim)
    of the study config, random weights on random images; fail unless they are the
    STUDY_* tables'."""
    from optimalstrategiesagainstgenerativeattacks_torch.eval import authentication as auth
    from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg

    _, cfg = study_config([seed])
    state = timg.create_state(cfg, *timg.build_models(cfg), cfg.seed, "cuda")
    rng = np.random.default_rng(seed)
    s, c = cfg.img_size, cfg.img_channels

    def images(b, n):
        return torch.from_numpy(rng.integers(0, 256, (b, n, s, s, c), dtype=np.uint8)).cuda()

    batch = {"real_sample": images(cfg.batch_size, cfg.n),
             "leaked_sample": images(cfg.batch_size, cfg.m),
             "si_sample": images(cfg.batch_size, cfg.k)}
    timg.train_step(state, batch)  # the kernels' first launches compile them
    with kernel_sites() as train:
        timg.train_step(state, batch)
    # one batch of the grid's gim-vs-gim row: the authenticator scores the real
    # sample, the impersonator makes the fake from the leaked one, the
    # authenticator scores it (eval/scorer.py)
    dtype = timg.compute_dtype(cfg) or torch.float32
    au = auth.get_au_function(state.au, dtype, "cuda")
    im = auth.get_im_function(state.im, dtype, cfg.remove_noise_mean, cfg.n, "cuda")
    real, si, leaked = (timg.prepare(None, images(EVAL_BATCH, n), "cuda")
                        for n in (cfg.n, cfg.k, cfg.m))
    with kernel_sites() as batch_sites:
        au(real, si)
        au(im(leaked), si)
    torch.cuda.synchronize()
    for what, got, adain, attention in (
            ("study step", train, STUDY_ADAIN_SITES, STUDY_ATTENTION_SITES),
            ("study eval batch", batch_sites, STUDY_EVAL_ADAIN_SITES, STUDY_EVAL_ATTENTION_SITES)):
        want = {"adain_fwd": adain, "adain_bwd": {} if "eval" in what else adain,
                "attention_core_fwd": attention}
        f32 = sorted((name, site) for name, site, d in got.pop("dtypes") if d == "f32")
        print(f"  {what}: recorded sites {got}; in f32: {f32}")
        if got != want:
            fail(f"{what}: the kernels' sites {got}, the tables say {want}")
    del state


def add_config(results: dict, prefix: str, tables, times: dict) -> None:
    """Sum the timed sites of one config's per-unit tables into ``results`` (an eval
    batch runs no backward)."""
    for table in tables:
        for site, per_step in table.items():
            for name, (k_ms, p_ms, b_ms, b_by, lib_ms) in times[site].items():
                if not (prefix.endswith("eval_") and name == "adain_bwd"):
                    add_site(results, prefix, name, per_step, k_ms, p_ms, b_ms, b_by, lib_ms)


def eval_launches_per_batch(adain_table: dict, attention_table: dict, baseline: str) -> dict:
    """{"<au>_vs_<im>": {kernel: launches}} of one eval batch of each pairing: the GIM
    impersonator runs every AdaIN site and its own attention sites, each GIM
    authenticator call (two a batch) its encoders' attention."""
    au_attention = 2 * AU_CALL_ATTENTION
    im_attention = sum(attention_table.values()) - au_attention
    return {f"{au}_vs_{im}": {
        "adain_fwd": sum(adain_table.values()) if im == "gim" else 0, "adain_bwd": 0,
        "attention_core_fwd": (au_attention if au == "gim" else 0)
        + (im_attention if im == "gim" else 0)}
        for au in ("gim", baseline) for im in IM_TYPES}


def report_cuda_build(so) -> None:
    """Print each kernel's registers and spills (ptxas -v, kept beside the
    library) and the tensor-core instructions of the bf16 kernel (cuobjdump)."""
    def label(name: str) -> str:
        warps = re.search(r"ILi(\d+)E", name)
        if "bf16_kernel" not in name:
            return "f32"
        return f"bf16, {warps.group(1)} warps" if warps else "bf16"

    kernel = None
    for line in open(str(so) + ".log").read().splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            kernel = label(m.group(1))
        elif kernel and ("registers" in line or "spill" in line):
            print(f"    ptxas ({kernel} kernel): {line.strip()}")
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if spills:
                n = int(spills.group(1)) + int(spills.group(2))
                print(f"    {kernel} kernel {'spills' if n else 'does not spill'}"
                      f" ({n} bytes of spill stores and loads)")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        print("    cuobjdump not found: tensor-core instructions not counted")
        return
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = label(line)
        elif kernel:
            counts[kernel] = counts.get(kernel, 0) + ("HMMA" in line)
    print(f"    cuobjdump: HMMA instructions per kernel {counts}")
    if not all(n for k, n in counts.items() if k.startswith("bf16")):
        fail("a bf16 attention kernel has no HMMA (tensor-core) instruction")


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


def check_slice(seed: int, use_img_att: bool = False) -> None:
    from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg
    from optimalstrategiesagainstgenerativeattacks_torch.utils.config import ImageGameConfig

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ImageGameConfig(compute_dtype="float32", batch_size=2, use_img_att=use_img_att)
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
    # img2img ends in tanh; img_att blends that with an unbounded SN conv block of it
    # (v2), as the reference does, so only the fake without img_att lies in [-1, 1]
    print(f"  fake range [{fake_gpu.min().item():.4f}, {fake_gpu.max().item():.4f}]")
    if not use_img_att and fake_gpu.abs().max() > 1.0:
        fail("fake images outside [-1, 1]")


def conv_site_configs(seed: int) -> dict:
    """The configs whose SN conv sites phase 4 checks: the flagship, with
    ``use_img_att``, VoxCeleb and the multi-seed CLI's defaults."""
    from optimalstrategiesagainstgenerativeattacks_torch.utils.config import ImageGameConfig

    return {"flagship": ImageGameConfig(seed=seed),
            "img_att": ImageGameConfig(seed=seed, use_img_att=True),
            "vox": ImageGameConfig(img_size=64, img_channels=3, reg_param=10.0, seed=seed),
            "cli_small": study_config([seed])[1]}


def conv_error(names: list, got, want) -> float:
    """max|got - want| / max|want| of each pair; fail above CONV_TOL; the worst."""
    worst = 0.0
    for name, a, b in zip(names, got, want):
        err = (a.float() - b).abs().max().item() / b.abs().max().item()
        if not err <= CONV_TOL:
            fail(f"{name} off by {err:.3g} of its max (limit {CONV_TOL})")
        worst = max(worst, err)
    return worst


def check_bf16_sites(seed: int) -> None:
    """Each bf16 rounding site's chain (tests/bf16_sites_support.py; random weights, norms and
    gammas randomised, biases of scale SITES_BIAS_SCALE) in bf16 on the card against
    the chain in f32 on the CPU: the mean error at most SITES_RATIO x the CPU bf16
    chain's; where XLA's compile keeps the value in f32, under the card's error with
    the value rounded; where XLA rounds, equal to that chain's output."""
    import copy

    from optimalstrategiesagainstgenerativeattacks_torch.nn import blocks as tblocks
    from optimalstrategiesagainstgenerativeattacks_torch.nn.init import init_module
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import bf16_sites_support as bs

    gen = torch.Generator().manual_seed(seed + 7)
    for cfg in (bs.FLAGSHIP, bs.VOX):
        players16, players32 = cfg.players(), cfg.players(None)
        named = bs.by_name(cfg)
        for name in bs.KEEPS_F32 + bs.ROUNDS:
            case = named[name]
            chain = copy.deepcopy(bs.TChain(case.port(*players16)))
            chain32 = copy.deepcopy(bs.TChain(case.port(*players32)))
            with torch.no_grad():
                init_module(chain, gen)
                randomise_norms_and_gammas(chain, gen)
                for m in chain.modules():
                    if isinstance(m, (tblocks.Dense, tblocks.SNConv)):
                        m.bias.copy_(SITES_BIAS_SCALE * torch.randn(m.bias.shape, generator=gen))
                chain32.load_state_dict(chain.state_dict())
                xs = [bs.to_port(x) for x in
                      bs.split(case, bs.inputs(case, cfg, np.random.default_rng(seed)))]
                ref = chain32(*xs).float()
                cpu = chain(*xs).float()
                chain.cuda()
                xs = [tuple(p.cuda() for p in x) if isinstance(x, tuple) else x.cuda()
                      for x in xs]
                card = chain(*xs).float().cpu()
                with bs.hooks(chain, bs.variants(case)["port_rounded"]):
                    rounded = chain(*xs).float().cpu()
            err = {k: (v - ref).abs().mean().item()
                   for k, v in (("card", card), ("cpu", cpu), ("rounded", rounded))}
            keeps = name in bs.KEEPS_F32
            ok = err["card"] <= SITES_RATIO * err["cpu"] and (
                err["card"] < err["rounded"] if keeps else torch.equal(card, rounded))
            print(f"  {cfg.name} {case.name}: mean error card bf16 {err['card']:.4e}, CPU bf16 "
                  f"{err['cpu']:.4e}, card with the value rounded {err['rounded']:.4e} (XLA "
                  f"{'keeps f32' if keeps else 'rounds'}; |ref| {ref.abs().mean().item():.3g})")
            if not ok:
                fail(f"bf16 site {cfg.name} {case.name}: errors {err}")
        del players16, players32


def check_conv_sites(seed: int) -> dict:
    """Every spectrally normalised conv site of one bf16 train step of each config, run
    as the port runs it (``nn/blocks.py:sn_conv`` on the card: a plain conv, the
    upsample folded into a transposed stride-2 conv, the pool folded into a stride-2
    conv, and each channel part of a split input with its kernel slice, then the
    bias) on random data, forward and backward, against the same conv in f32
    without cuDNN (the native im2col and cuBLAS path; a folded upsample as the
    plain conv of the zero-dilated input): max|err| <= CONV_TOL x max|ref| for the
    output and both gradients.  cuDNN computes some bf16 convs of one channel
    wrongly (``nn/blocks.py:conv_one_channel``); this finds any other such site.  At
    the VoxCeleb config each authenticator site also runs R1's double backward (see
    ``check_conv_double_backward``).  Returns each config's bf16 pool sites of that step
    (``recording_pools``)."""
    from optimalstrategiesagainstgenerativeattacks_torch.nn.blocks import SNConv
    from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg

    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    pool_sites = {}
    for name, cfg in conv_site_configs(seed).items():
        state = timg.create_state(cfg, *timg.build_models(cfg), cfg.seed, "cuda")
        sites, au_sites = {}, set()

        def record(player):
            def hook(mod, args):
                parts = args[0] if isinstance(args[0], tuple) else (args[0],)
                o, _, k, _ = mod.weight.shape
                k += mod.mode != "plain"  # the folded kernel's taps
                for x in parts:
                    key = (tuple(x.shape), (o, x.shape[1], k, k), mod.padding,
                           x.is_contiguous(memory_format=torch.channels_last), mod.mode,
                           len(parts) > 1)
                    sites[key] = sites.get(key, 0) + 1
                    if player == "au":
                        au_sites.add(key)
            return hook

        hooks = [m.register_forward_pre_hook(record(p)) for p, player in (("au", state.au),
                                                                         ("im", state.im))
                 for m in player.modules() if isinstance(m, SNConv)]
        rng = np.random.default_rng(seed)
        s, c = cfg.img_size, cfg.img_channels
        batch = {k: torch.from_numpy(rng.integers(0, 256, (cfg.batch_size, n, s, s, c),
                                                  dtype=np.uint8)).cuda()
                 for k, n in (("real_sample", cfg.n), ("leaked_sample", cfg.m),
                              ("si_sample", cfg.k))}
        with recording_pools() as pool_sites[name]:
            timg.train_step(state, batch)
        for h in hooks:
            h.remove()
        del state
        worst, kinds = (0.0, None), {}
        for (xs, ws, pad, cl, mode, part), count in sites.items():
            kind = f"{mode}{' part' if part else ''}"
            kinds[kind] = kinds.get(kind, 0) + 1
            x, wb, bias = conv_inputs(xs, ws, cl, gen)
            out = port_conv(x, wb, pad, mode, bias.to(torch.bfloat16))
            g = torch.randn(out.shape, device="cuda", generator=gen)
            got = (out, *torch.autograd.grad(out, (x, wb), g.to(out.dtype)))
            xf = x.detach().float().requires_grad_(True)
            wf = wb.detach().float().requires_grad_(True)
            with torch.backends.cudnn.flags(enabled=False):
                ref = reference_conv(xf, wf, pad, mode, bias)
                want = (ref, *torch.autograd.grad(ref, (xf, wf), g))
            err = conv_error([f"conv site {name} {kind} x{xs} w{ws}: {what}"
                              for what in ("output", "d input", "d weight")], got, want)
            worst = max(worst, (err, f"{kind} x{xs} w{ws}"))
        print(f"  {name}: {len(sites)} SN conv sites ({', '.join(f'{n} {k}' for k, n in kinds.items())}), "
              f"{sum(sites.values())} calls a step; worst error / max|ref| {worst[0]:.3g} "
              f"({worst[1]})")
        if cfg.reg_param > 0:
            check_conv_double_backward(name, sorted(au_sites), gen)
        torch.cuda.empty_cache()
    return pool_sites


@contextlib.contextmanager
def recording_pools():
    """Yields a dict that counts, while inside, each bf16 ``avg_pool2d`` call of the
    port's blocks by its input's (shape, strides)."""
    from optimalstrategiesagainstgenerativeattacks_torch.nn import blocks

    sites, pool = {}, blocks.avg_pool2d

    def record(x, window=2):
        if x.dtype == torch.bfloat16:
            key = (tuple(x.shape), x.stride())
            sites[key] = sites.get(key, 0) + 1
        return pool(x, window)

    blocks.avg_pool2d = record
    try:
        yield sites
    finally:
        blocks.avg_pool2d = pool


def pool_and_grads(x, ct, v, pool=None) -> tuple:
    """``pool`` (the port's ``avg_pool2d``) of ``x``: the output, the gradient at the
    cotangent ``ct`` and R1's double backward, the gradient of <gradient, v> with respect
    to ``ct``."""
    from optimalstrategiesagainstgenerativeattacks_torch.ops.image_ops import avg_pool2d

    x = x.detach().requires_grad_(True)
    ct = ct.detach().requires_grad_(True)
    y = (pool or avg_pool2d)(x)
    (g,) = torch.autograd.grad(y, x, ct, create_graph=True)
    (gg,) = torch.autograd.grad((g.float() * v).sum(), ct)
    return y.detach(), g.detach(), gg


def check_pool_sites(pool_sites: dict, device: str = "cuda", seed: int = 0) -> int:
    """The port's pool at each bf16 site (shape, strides) of ``pool_sites`` ({config:
    {site: calls a step}}), once a site, on ``device`` against the CPU on the same
    random input: the unequal values of the output, the gradient and the double
    backward, and the output's and gradient's strides against ``F.avg_pool2d``'s on
    ``device``.  Fails on any difference; returns the sites checked."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(seed + 11)
    seen = set()
    for name, sites in pool_sites.items():
        print(f"  {name}: {sum(sites.values())} bf16 pools a step at {len(sites)} shapes and "
              f"layouts" + (" (checked above)" if sites.keys() <= seen else ""))
        for (shape, strides), calls in sorted(sites.items()):
            if (shape, strides) in seen:
                continue
            seen.add((shape, strides))
            b, c, h, w = shape
            x = torch.empty_strided(shape, strides, dtype=torch.bfloat16)
            x.copy_(torch.randn(shape, generator=gen))
            ct = torch.randn(b, c, h // 2, w // 2, generator=gen).to(torch.bfloat16)
            v = torch.randn(shape, generator=gen)
            want = pool_and_grads(x, ct, v)
            xd = torch.empty_strided(shape, strides, dtype=torch.bfloat16, device=device)
            got = pool_and_grads(xd.copy_(x), ct.to(device), v.to(device))
            plain = pool_and_grads(xd, ct.to(device), v.to(device), lambda t: F.avg_pool2d(t, 2))
            unequal = [int((a.cpu() != e).sum()) for a, e in zip(got, want)]
            strides_ok = [a.stride() == p.stride() for a, p in zip(got[:2], plain[:2])]
            print(f"    pool {list(shape)} strides {strides} ({calls} a step): unequal values "
                  f"{device} vs CPU: output {unequal[0]}, gradient {unequal[1]}, double "
                  f"backward {unequal[2]}; output strides {got[0].stride()}, gradient "
                  f"{got[1].stride()}, as F.avg_pool2d's: {all(strides_ok)}")
            if any(unequal) or not all(strides_ok):
                fail(f"bf16 pool {list(shape)} strides {strides}: unequal {unequal}, strides "
                     f"{[a.stride() for a in got[:2]]} against F.avg_pool2d's "
                     f"{[p.stride() for p in plain[:2]]}")
    return len(seen)


def port_conv(x, w, pad: int, mode: str, bias):
    """An SN conv site as the port runs it: ``sn_conv``, then the bias."""
    from optimalstrategiesagainstgenerativeattacks_torch.nn.blocks import sn_conv

    return sn_conv(x, w, pad, mode) + bias[:, None, None]


def reference_conv(x, w, pad: int, mode: str, bias):
    """The same conv by another route: ``F.conv2d`` (stride 2 for "down"), and for "up"
    the conv of the 2x zero-dilated input padded by ``pad`` + 1."""
    import torch.nn.functional as F

    if mode == "up":
        b, c, h, wd = x.shape
        xd = x.new_zeros(b, c, 2 * h - 1, 2 * wd - 1)
        xd[:, :, ::2, ::2] = x
        return F.conv2d(xd, w, bias, padding=pad + 1)
    return F.conv2d(x, w, bias, stride=2 if mode == "down" else 1, padding=pad)


def conv_inputs(xs, ws, channels_last: bool, gen: torch.Generator) -> tuple:
    """Random bf16 input (a leaf that needs its gradient) and weight of one conv site,
    the weight scaled as a spectrally normalised one; the f32 bias."""
    x = torch.randn(xs, device="cuda", generator=gen).to(torch.bfloat16)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    w = torch.randn(ws, device="cuda", generator=gen) / math.sqrt(math.prod(ws[1:]))
    bias = torch.randn(ws[0], device="cuda", generator=gen)
    return x.requires_grad_(True), w.to(torch.bfloat16).requires_grad_(True), bias


def check_conv_double_backward(name: str, sites: list, gen: torch.Generator) -> None:
    """R1's pattern at each authenticator conv site, in bf16 as the port runs it:
    y = conv(x, w); gx = grad(y, x, g, create_graph=True); then the gradient of
    (gx . v).sum() with respect to w and to the cotangent g (through which R1's
    penalty reaches the layers behind the conv), against the same in f32 without
    cuDNN, each within CONV_TOL x max|ref|.  gx does not depend on x (a conv is linear
    in its input), so its gradient with respect to x is zero on both sides."""

    def double_backward(conv, x, w, g, v):
        (gx,) = torch.autograd.grad(conv(x, w), x, g, create_graph=True)
        return (gx, *torch.autograd.grad((gx.float() * v).sum(), (w, g)))

    worst = (0.0, None)
    for xs, ws, pad, cl, mode, part in sites:
        x, wb, bias = conv_inputs(xs, ws, cl, gen)
        with torch.no_grad():
            out_shape = port_conv(x, wb, pad, mode, bias.to(torch.bfloat16)).shape
        g = torch.randn(out_shape, device="cuda", generator=gen).to(torch.bfloat16)
        v = torch.randn(xs, device="cuda", generator=gen)
        got = double_backward(
            lambda x_, w_: port_conv(x_, w_, pad, mode, bias.to(torch.bfloat16)),
            x, wb, g.requires_grad_(True), v)
        xf = x.detach().float().requires_grad_(True)
        wf = wb.detach().float().requires_grad_(True)
        with torch.backends.cudnn.flags(enabled=False):
            want = double_backward(lambda x_, w_: reference_conv(x_, w_, pad, mode, bias),
                                   xf, wf, g.detach().float().requires_grad_(True), v)
        err = conv_error([f"R1 double backward, {name} authenticator {mode} site x{xs} "
                          f"w{ws}: {what}" for what in ("gx", "d weight", "d cotangent")],
                         got, want)
        worst = max(worst, (err, f"{mode} x{xs} w{ws}"))
    print(f"  {name}: R1's conv double backward (bf16 against f32 without cuDNN) at "
          f"{len(sites)} authenticator SN conv sites; worst error / max|ref| {worst[0]:.3g} "
          f"({worst[1]})")


def run_train(seed: int, n_steps: int, counters, use_img_att: bool = False) -> tuple:
    """Flagship train steps through ``train_gim_imgs_steps``; returns (launches,
    seconds a steady step)."""
    from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg
    from optimalstrategiesagainstgenerativeattacks_torch.utils.config import ImageGameConfig

    cfg = ImageGameConfig(seed=seed, use_img_att=use_img_att)  # the flagship defaults
    print(f"  config: B={cfg.batch_size} img={cfg.img_size}x{cfg.img_size}x{cfg.img_channels} "
          f"style={cfg.style_dim} m={cfg.m} n={cfg.n} k={cfg.k} {cfg.compute_dtype} "
          f"use_img_att={cfg.use_img_att}")
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
    bounded = use_img_att or fake.abs().max() <= 1.0  # img_att's blend is not tanh-bounded
    if not (torch.isfinite(fake).all() and bounded and torch.isfinite(logits).all()):
        fail("trained players give non-finite or out-of-range outputs")
    print(f"  trained players: fake range [{fake.min().item():.4f}, {fake.max().item():.4f}], "
          f"logits finite")
    images = cfg.batch_size * (cfg.m + cfg.n + cfg.k)
    print(f"  warm-up step (state build, kernel compiles, cuDNN autotune): {warm_s:.2f} s")
    print(f"  steady steps 1..{n_steps - 1}: {1.0 / step_s:.3f} steps/s, "
          f"{images / step_s:.1f} images/s ({images} batch images per step), "
          f"{step_s * 1e3:.2f} ms/step, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{smi_line()}]")
    return launches, step_s


def check_noise_draw(seed: int) -> None:
    """The impersonator's bf16 noise on the card takes the values the CPU draw takes:
    ``jax.random.normal``'s 128 bf16 values (``utils/rng.py:normal``)."""
    from optimalstrategiesagainstgenerativeattacks_torch.utils.rng import BF16_LEVELS, normal

    def values(device):
        gen = torch.Generator(device=device).manual_seed(seed)
        z = normal((1 << 16,), gen, device, torch.bfloat16)
        return torch.unique(z.float().cpu())

    card, cpu = values("cuda"), values("cpu")
    if len(cpu) != BF16_LEVELS or not torch.equal(card, cpu):
        fail(f"bf16 noise: {len(card)} values on the card, {len(cpu)} on the CPU, "
             f"equal {torch.equal(card, cpu) if len(card) == len(cpu) else False}")
    print(f"  bf16 noise draw: the card's {len(card)} values are the CPU's, from "
          f"{card.min().item():.6f} to {card.max().item():.6f}")


def check_train_launches(what: str, launches: dict, n_steps: int) -> None:
    """Fail unless ``n_steps`` flagship steps launched each kernel its per-step count."""
    print(f"  layout copies in front of the AdaIN kernels: {launches.pop('adain_nhwc_copy')}")
    expected = {
        "adain_fwd": sum(ADAIN_SITES.values()) * n_steps,
        "adain_bwd": sum(ADAIN_SITES.values()) * n_steps,
        "attention_core_fwd": sum(ATTENTION_SITES.values()) * n_steps,
    }
    print(f"  {what}: launches {launches}, expected {expected}")
    for name, want in expected.items():
        if launches[name] != want:
            fail(f"{what}: {name} {launches[name]} launches, expected {want}")


def kernel_results() -> dict:
    """Each kernel's JSON entry, its per-unit sums at zero, and its launches per eval
    batch of each pairing (the flagship grid's with the Siamese baseline, the
    VoxCeleb grid's with ArcFace)."""
    pairings = {
        "eval_": eval_launches_per_batch(EVAL_ADAIN_SITES, EVAL_ATTENTION_SITES, "siamese"),
        "vox_eval_": eval_launches_per_batch(VOX_EVAL_ADAIN_SITES, VOX_EVAL_ATTENTION_SITES,
                                             "arcface"),
    }
    return {
        name: {"name": name, "route": route, "source": src, "replaces": rep,
               "launches": 0, "vox_launches": 0, "eval_launches": 0, "vox_eval_launches": 0,
               "gaussian_launches": 0, "img_att_launches": 0, "multiseed_launches": 0,
               "inventory_launches": 0, "study_launches": 0, "dp_launches": 0,
               **{f"{p}launches_per_batch_by_pairing": {pair: n[name] for pair, n in table.items()}
                  for p, table in pairings.items()},
               "max_abs_err": 0.0,
               **{f"{p}{k}": v for p in PER_CONFIG
                  for k, v in ((launches_key(p)[len(p):], 0), ("ms", 0.0), ("plain_ms", 0.0),
                               ("library_ms", None), ("bound_ms", 0.0), ("bound_by", None),
                               ("share_of_bound", None))},
               "_bound_by": {p: {"bytes": 0.0, "operations": 0.0} for p in PER_CONFIG}}
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


def summarise(results: dict, times: dict) -> None:
    """Sum the timed sites into per-step times of each config; print them."""
    for p, adain, attention in zip(PER_CONFIG, ADAIN_TABLES, ATTENTION_TABLES):
        add_config(results, p, (adain, attention), times)
    for r in results.values():
        by = r.pop("_bound_by")
        for p in PER_CONFIG:
            if r[launches_key(p)] == 0:  # K1b in the eval batches
                continue
            r[f"{p}bound_by"] = max(by[p], key=by[p].get)
            r[f"{p}share_of_bound"] = r[f"{p}bound_ms"] / r[f"{p}ms"]
    for p, label in PER_CONFIG.items():
        print(f"  per {label}: " + "; ".join(
            f"{r['name']} x{r[launches_key(p)]} {r[p + 'ms']:.4f} ms (plain "
            f"{r[p + 'plain_ms']:.4f}, library "
            f"{'none' if r[p + 'library_ms'] is None else format(r[p + 'library_ms'], '.4f')}"
            f", bound {r[p + 'bound_ms']:.4f}, share {r[p + 'share_of_bound'] or 0.0:.3f})"
            for r in results.values()))


def check_r1(seed: int) -> None:
    """R1 penalty and authenticator gradients at the VoxCeleb widths, f32 on the card,
    against the same computation on the CPU in f64 that takes the card's branch at
    every LeakyReLU and global max pool (``Branches``).  Each of the card's
    gradients is within R1_TOL x its max|ref| + R1_TOL x 1e-3 x the player's.

    The f64 run at its own branches is another piecewise function: a
    pre-activation or a max within f32 rounding of its kink sends an f32 run down
    the other branch, and the R1 gradients of the convs in front of it jump by
    several of these limits, on either device.  The CPU's f32 run, printed
    against the plain f64 run and against the f64 run at its own branches, shows
    how far."""
    from optimalstrategiesagainstgenerativeattacks_torch.models import image as imodels
    from optimalstrategiesagainstgenerativeattacks_torch.nn.init import init_module
    from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg
    from optimalstrategiesagainstgenerativeattacks_torch.train.losses import bce_with_logits
    from optimalstrategiesagainstgenerativeattacks_torch.utils.config import ImageGameConfig

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ImageGameConfig(img_size=64, img_channels=3, reg_param=10.0, compute_dtype="float32",
                          batch_size=2)
    gen = torch.Generator().manual_seed(seed + 2)
    au = imodels.get_au(cfg.img_size, cfg.img_channels, cfg.style_dim)
    init_module(au, gen)
    randomise_norms_and_gammas(au, gen)
    b, s, c = cfg.batch_size, cfg.img_size, cfg.img_channels
    # independent images: the sets' features stay apart, so the set std's
    # gradient does not magnify rounding
    real, fake = (torch.rand(b, cfg.n, s, s, c, generator=gen) * 2 - 1 for _ in range(2))
    si = torch.rand(b, cfg.k, s, s, c, generator=gen) * 2 - 1
    names = [k for k, _ in au.named_parameters()]

    def run(device, dtype=torch.float32, branches=None):
        au_ = copy.deepcopy(au).to(device, dtype)
        real_ = real.to(device, dtype).requires_grad_(True)
        si_ = si.to(device, dtype).requires_grad_(True)
        with Branches(branches) as taken:
            out_real, out_fake = timg.au_outputs(au_, real_, fake.to(device, dtype), si_)
            reg = timg.r1_penalty(cfg, out_real, real_, si_)
            loss = (bce_with_logits(out_real, 1.0) + bce_with_logits(out_fake, 0.0) + reg).mean()
            grads = torch.autograd.grad(loss, list(au_.parameters()))
        taken.check_replayed()
        return (reg.detach().cpu().double(), {k: g.cpu().double() for k, g in zip(names, grads)},
                taken)

    def errors(got, want) -> list:
        player = max(g.abs().max().item() for g in want.values())
        return sorted((((got[k] - want[k]).abs().max().item()
                        / (R1_TOL * want[k].abs().max().item() + R1_TOL * 1e-3 * player)), k)
                      for k in names)[::-1]

    def worst(ratios) -> str:
        return ", ".join(f"{k} {r:.3f}" for r, k in ratios[:3])

    t0 = time.perf_counter()
    _, grads_cpu, cpu = run("cpu")
    _, grads_f64, plain = run("cpu", torch.float64)
    _, grads_at_cpu, at_cpu = run("cpu", torch.float64, cpu.taken)
    t1 = time.perf_counter()
    reg_gpu, grads_gpu, card = run("cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    reg_ref, grads_ref, at_card = run("cpu", torch.float64, card.taken)
    print(f"  CPU f32 against f64: at f64's own branches {worst(errors(grads_cpu, grads_f64))}; "
          f"at the CPU's ({at_cpu.flipped} of {at_cpu.points} branch points taken otherwise) "
          f"{worst(errors(grads_cpu, grads_at_cpu))} (error / limit of the worst; CPU runs "
          f"{t1 - t0:.2f} s, card {t2 - t1:.2f} s)")
    print(f"  R1 penalty per episode: card {reg_gpu.tolist()}, CPU f64 at the card's branches "
          f"{reg_ref.tolist()}")
    compare("R1 penalty (card vs CPU f64)", reg_gpu, reg_ref, 0.0, R1_TOL)
    for k in names:
        if not torch.isfinite(grads_gpu[k]).all():
            fail(f"R1: non-finite gradient of {k} on the card")
    ratios = errors(grads_gpu, grads_ref)
    print(f"  authenticator gradients, {len(ratios)} tensors, card against f64 at f64's own "
          f"branches {worst(errors(grads_gpu, grads_f64))}; at the card's ({at_card.flipped} of "
          f"{at_card.points} taken otherwise) {worst(ratios)}")
    if ratios[0][0] > 1.0:
        fail(f"R1: gradient of {ratios[0][1]} off by {ratios[0][0]:.3f} x its limit")


class Branches(torch.overrides.TorchFunctionMode):
    """Records the branch a run takes at each LeakyReLU (the sign of each input) and
    each global max pool (``amax`` over H and W: the position of each max), or, given
    a record, makes the run take those branches: a LeakyReLU input then gets the
    recorded slope and a max pool the value at the recorded position, whichever side
    of the kink the run's own value lies.  ``flipped`` counts those that lie on the
    other side, of ``points``.  Every other function runs as it is."""

    def __init__(self, taken=None):
        super().__init__()
        self.replay = taken is not None
        self.taken = taken if self.replay else []
        self.calls = self.flipped = self.points = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.nn.functional.leaky_relu:
            x, slope = args[0], args[1] if len(args) > 1 else kwargs["negative_slope"]
            if not self.replay:
                self.taken.append((x > 0).cpu())
                return func(*args, **kwargs)
            side = self._next(x > 0)
            return torch.where(side, x, x * slope)
        if func is torch.Tensor.amax and args[0].dim() == 4 and tuple(
                args[1] if len(args) > 1 else kwargs.get("dim", ())) == (2, 3):
            flat = args[0].flatten(2)
            if not self.replay:
                self.taken.append(flat.argmax(-1).cpu())
                return func(*args, **kwargs)
            at = self._next(flat.argmax(-1))
            return flat.gather(-1, at[..., None]).squeeze(-1)
        return func(*args, **kwargs)

    def _next(self, own):
        recorded = self.taken[self.calls].to(own.device)
        self.calls += 1
        self.flipped += int((own != recorded).sum())
        self.points += own.numel()
        return recorded

    def check_replayed(self) -> None:
        if self.replay and self.calls != len(self.taken):
            fail(f"R1: the f64 run took {self.calls} of the {len(self.taken)} recorded branches")


class SeededEpisodes:
    """An in-memory episodic dataset of uint8 noise images drawn from a seed:
    ``n_classes`` classes of ``per_class`` images, ``example_cnt_per_class``
    episodes a class.  It offers the interface ``EpisodicBatchLoader``, the
    device loader and the eval grid read (``__len__``, ``sample_episode``,
    ``__getitem__``, ``stacked_cache``, ``root``) without files or PIL; with
    ``mirror`` the device loader flips images, as on VoxCeleb2."""

    root = "<memory>"

    def __init__(self, cfg, n_classes: int, per_class: int, seed: int,
                 example_cnt_per_class: int = 1, mirror: bool = False):
        rng = np.random.default_rng(seed)
        self.m, self.n, self.k = cfg.m, cfg.n, cfg.k
        self.si = cfg.k
        self.example_cnt_per_class, self.mirror = example_cnt_per_class, mirror
        self.images = rng.integers(
            0, 256, (n_classes, per_class, cfg.img_size, cfg.img_size, cfg.img_channels),
            dtype=np.uint8)

    def __len__(self) -> int:
        return self.images.shape[0] * self.example_cnt_per_class

    def stacked_cache(self) -> np.ndarray:
        return self.images

    def sample_episode(self, index: int, rng: np.random.Generator) -> dict:
        cls = index // self.example_cnt_per_class
        pick = rng.choice(self.images.shape[1], size=self.m + self.n + self.k, replace=False)
        imgs = self.images[cls, pick]
        return {"leaked_sample": imgs[: self.m], "real_sample": imgs[self.m: self.m + self.n],
                "si_sample": imgs[self.m + self.n:], "class": np.int32(cls)}

    def __getitem__(self, index: int) -> dict:
        return self.sample_episode(index, np.random.default_rng(index))


class MemoryLogger:
    """The loop's logger with its scalars kept in memory and its image grids
    checked and counted, not written (no PIL, no files)."""

    def __init__(self):
        self.stats, self.grids = {}, 0

    def add_scalar(self, category: str, k: str, v: float, global_step: int) -> None:
        self.stats.setdefault(category, {}).setdefault(k, []).append((int(global_step), float(v)))

    def add_imgs(self, imgs, category: str, k: str, global_step: int, nrow: int = 5) -> None:
        if not (np.isfinite(imgs).all() and imgs.min() >= 0.0 and imgs.max() <= 1.0):
            fail(f"image grid {category}/{k}: values outside [0, 1]")
        self.grids += 1


def eval_indices(n: int) -> int:
    """How many episodes the loop's image dump samples from a dataset of n."""
    return len(range(0, n, max(1, n // 10)))


def expected_launches(calls: dict) -> dict:
    """{kernel: launches} of ``calls`` {entry point: count} at the VoxCeleb config."""
    return {name: sum(n * VOX_LAUNCHES[fn][name] for fn, n in calls.items())
            for name in VOX_LAUNCHES["train_step"]}


def check_launches(what: str, counters, calls: dict) -> dict:
    got = {c.name: c.count for c in counters}
    copies = got.pop("adain_nhwc_copy")
    want = expected_launches(calls)
    print(f"  {what}: launches {got}, expected {want}; layout copies in front of the AdaIN "
          f"kernels {copies}")
    if got != want:
        fail(f"{what}: launches {got}, expected {want}")
    if copies:
        fail(f"{what}: {copies} layout copies in front of the AdaIN kernels")
    return got


def run_vox(seed: int, counters):
    """The VoxCeleb config through the loop, sample, eval, steady steps and a resume.

    Returns (launches of the loop, the run's directory, its config): the
    directory, with args.json written here and the checkpoints, serves the
    VoxCeleb eval grid (phase 9), which deletes it."""
    import dataclasses

    from optimalstrategiesagainstgenerativeattacks_torch.data.episodic import EpisodicBatchLoader
    from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg
    from optimalstrategiesagainstgenerativeattacks_torch.train.checkpoints import get_latest_ckpt
    from optimalstrategiesagainstgenerativeattacks_torch.utils.config import (
        ImageGameConfig,
        save_args,
    )

    outdir = os.path.join(BUILD_DIR, "chip_smoke_vox")
    shutil.rmtree(outdir, ignore_errors=True)
    # the VoxCeleb2 paper hparams (train_gim_on_imgs.py:6-8); epochs of one
    # step, so that the checkpoint of step 2 resumes for one step
    cfg = ImageGameConfig(img_size=64, img_channels=3, au_lr=1e-4, im_lr=1e-4,
                          env_noise_mapping_lr=1e-6, reg_param=10.0, seed=seed, outdir=outdir,
                          n_epochs=4, save_every=2, log_every=1, log_enc_every=1000,
                          eval_every=1000, save_imgs_every=1000)
    print(f"  config: B={cfg.batch_size} img={cfg.img_size}x{cfg.img_size}x{cfg.img_channels} "
          f"style={cfg.style_dim} m={cfg.m} n={cfg.n} k={cfg.k} reg_param={cfg.reg_param} "
          f"lr au/im/noise {cfg.au_lr}/{cfg.im_lr}/{cfg.env_noise_mapping_lr} {cfg.compute_dtype}")
    per_class = cfg.m + cfg.n + cfg.k + 1
    train_ds = SeededEpisodes(cfg, cfg.batch_size, per_class, seed, mirror=True)
    val_ds = SeededEpisodes(cfg, cfg.batch_size, per_class, seed + 1, mirror=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.reset()
    logger = MemoryLogger()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        state = timg.train_gim_imgs(cfg, train_ds, val_ds, logger=logger, progress=False,
                                    device="cuda")
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    print("  loop says: " + "; ".join(out.getvalue().strip().splitlines()))
    if "device-resident dataset" not in out.getvalue():  # device_data="auto", a uniform set
        fail("loop: the VoxCeleb loop did not take the device loader")
    launches = check_launches(
        f"loop ({cfg.n_epochs} steps; at step 0 diagnostics, images and eval)", counters,
        {"train_step": cfg.n_epochs, "diag": 1, "eval_step": len(val_ds) // cfg.batch_size,
         "sample": eval_indices(len(train_ds)) + eval_indices(len(val_ds))})
    if state.step != cfg.n_epochs - 1:
        fail(f"loop: state.step {state.step} after {cfg.n_epochs} steps")
    ckpt_dir = os.path.join(outdir, cfg.ckpt_dir_name)
    ckpts = sorted(os.listdir(ckpt_dir))
    if ckpts != ["model_00000000", "model_00000002", "model_00000003"]:
        fail(f"loop: checkpoints {ckpts}")
    losses = logger.stats["train_losses"]
    for gs, v in losses["dis_loss"]:
        print(f"  step {gs}: dis_loss={v:.4f} dis_reg={dict(losses['dis_reg'])[gs]:.4f} "
              f"gen_loss={dict(losses['gen_loss'])[gs]:.4f}")
    bad = [(cat, k) for cat, d in logger.stats.items() for k, pts in d.items()
           if not all(math.isfinite(v) for _, v in pts)]
    if bad:
        fail(f"loop: non-finite metrics {bad}")
    print(f"  loop: {loop_s:.2f} s in all (state build, compiles, cuDNN heuristics, step-0 "
          f"extras, {len(ckpts)} checkpoints); {logger.grids} image grids; checkpoints {ckpts}")

    loader = EpisodicBatchLoader(train_ds, cfg.batch_size, seed=seed)
    batches = []
    for epoch in (cfg.n_epochs, cfg.n_epochs + 1):  # batches the loop has not seen
        loader.set_epoch(epoch)
        batches.append({k: torch.from_numpy(v).cuda() for k, v in next(iter(loader)).items()
                        if k != "class"})
    for c in counters:
        c.reset()
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    fake = timg.sample(state, batches[0]["leaked_sample"][:1], gen)
    check_launches("sample (one episode)", counters, {"sample": 1})
    if tuple(fake.shape) != (1, cfg.n, cfg.img_size, cfg.img_size, cfg.img_channels):
        fail(f"sample: fake shape {tuple(fake.shape)}")
    if not (torch.isfinite(fake).all() and fake.abs().max() <= 1.0):
        fail("sample: fake non-finite or outside [-1, 1]")
    for c in counters:
        c.reset()
    metrics = {k: float(v) for k, v in timg.eval_step(state, batches[0], gen).items()}
    check_launches("eval_step", counters, {"eval_step": 1})
    if not all(math.isfinite(v) for v in metrics.values()):
        fail(f"eval_step: non-finite metrics {metrics}")
    print("  eval_step: " + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))

    torch.cuda.synchronize()
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    state, steady = timg.train_gim_imgs_steps(cfg, itertools.cycle(batches), VOX_STEPS,
                                              state=state)
    step_s = (time.perf_counter() - t0) / VOX_STEPS
    check_launches(f"{VOX_STEPS} steady steps", counters, {"train_step": VOX_STEPS})
    if not all(math.isfinite(v) for m in steady for v in m.values()):
        fail("steady steps: non-finite metrics")
    peak = torch.cuda.max_memory_allocated() / 2**30
    images = cfg.batch_size * (cfg.m + cfg.n + cfg.k)
    print(f"  steady steps: {1.0 / step_s:.3f} steps/s, {images / step_s:.1f} images/s "
          f"({images} batch images per step), {step_s * 1e3:.2f} ms/step, peak memory "
          f"{peak:.2f} GiB (torch.cuda.max_memory_allocated, loop and steady steps)  "
          f"[{smi_line()}]")
    del state, steady

    for c in counters:
        c.reset()
    resume_logger = MemoryLogger()
    resumed = timg.train_gim_imgs(
        dataclasses.replace(cfg, resume_from_ckpt=os.path.join(cfg.ckpt_dir_name, "model_00000002"),
                            n_epochs=3),
        train_ds, val_ds, logger=resume_logger, progress=False, device="cuda")
    check_launches("resume from model_00000002 (one step)", counters, {"train_step": 1})
    if resumed.step != 3 or not get_latest_ckpt(ckpt_dir).endswith("model_00000003"):
        fail(f"resume: state.step {resumed.step}")
    got = {k: dict(v)[3] for k, v in resume_logger.stats["train_losses"].items()}
    if not all(math.isfinite(v) for v in got.values()):
        fail(f"resume: non-finite metrics {got}")
    # the checkpoint of step 2 was saved in epoch 2, which the resumed run
    # takes again (the reference's epoch bookkeeping): its step 3 sees the
    # batch of the loop's step 2
    print("  resumed step 3 (epoch 2 again): " + ", ".join(
        f"{k}={got[k]:.5f}" for k in sorted(got)))
    del resumed
    save_args(cfg, outdir)
    return launches, outdir, cfg


def check_gaussian_step(seed: int) -> None:
    """One f32 Gaussian step at the Nash-check config, card against CPU, reg 0 and 5:
    the same weights (both from the seed), batch and z."""
    from optimalstrategiesagainstgenerativeattacks_torch.train import gaussian as tg
    from optimalstrategiesagainstgenerativeattacks_torch.utils.config import GaussianGameConfig

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for reg in (0.0, 5.0):
        cfg = GaussianGameConfig(**GAUSS_CONFIG, reg_param=reg, seed=seed)
        gen = torch.Generator().manual_seed(seed + 10)
        batch = tg.synth_batch(cfg, gen, "cpu")
        z = torch.randn((cfg.batch_size, cfg.n, cfg.src_dim), generator=gen)
        devices = {"card": "cuda", "host": "cpu"}
        states = {side: tg.create_state(cfg, d) for side, d in devices.items()}
        got = {side: {k: float(v) for k, v in tg.train_step(
                   states[side], {k: v.to(d) for k, v in batch.items()}, z.to(d)).items()}
               for side, d in devices.items()}
        worst = []
        for k, ref in got["host"].items():
            err = abs(got["card"][k] - ref)
            limit = 2.0 / cfg.batch_size if "acc" in k else GAUSS_TOL * max(1.0, abs(ref))
            if not math.isfinite(got["card"][k]) or err > limit:
                fail(f"gaussian step, reg {reg}: {k} card {got['card'][k]} CPU {ref}")
            worst.append((err / limit, k))
        print(f"  reg {reg}: au_reg card {got['card']['au_reg']:.6f} CPU "
              f"{got['host']['au_reg']:.6f}, au_loss {got['card']['au_loss']:.6f}; "
              f"15 metrics, worst error / limit {max(worst)[0]:.3f} ({max(worst)[1]})")
        for player, lr in (("au", cfg.au_lr), ("im", cfg.im_lr)):
            params = {side: dict(getattr(st, player).named_parameters())
                      for side, st in states.items()}
            opt = getattr(states["host"], f"opt_{player}")
            grads = {k: opt.state[p]["exp_avg"] for k, p in params["host"].items()}
            floor = 1e-6 * max(g.abs().max().item() for g in grads.values())
            ratios = []
            for k, want in params["host"].items():
                err = (params["card"][k].detach().cpu() - want.detach()).abs()
                big = grads[k].abs() > floor
                limit = GAUSS_TOL * want.abs().max().item()
                if not (bool((err[big] <= limit).all()) and bool((err[~big] <= 2 * lr).all())):
                    fail(f"gaussian step, reg {reg}: {player} {k} off by {err.max().item():.3e}")
                ratios.append((err[big].max().item() / limit if big.any() else 0.0, k))
            print(f"    {player}: {len(ratios)} parameters after Adam, worst error / limit "
                  f"{max(ratios)[0]:.3f} ({max(ratios)[1]})")


def run_gaussian(seed: int, counters) -> dict:
    """The Gaussian loop through ``train_gim_gaussian`` at the Nash-check config, a
    resume from its checkpoint inside the run, then timed chunks; returns the
    kernels' launches over all three (the game has no kernel: 0 expected)."""
    import dataclasses

    from optimalstrategiesagainstgenerativeattacks_torch.theory import game_value_mnk
    from optimalstrategiesagainstgenerativeattacks_torch.train import gaussian as tg
    from optimalstrategiesagainstgenerativeattacks_torch.utils.config import GaussianGameConfig

    outdir = os.path.join(BUILD_DIR, "chip_smoke_gaussian")
    shutil.rmtree(outdir, ignore_errors=True)
    cfg = GaussianGameConfig(**GAUSS_CONFIG, n_iters=GAUSS_STEPS, save_every=GAUSS_SAVE_EVERY,
                             seed=seed, outdir=outdir)
    print(f"  config: d={cfg.src_dim} m={cfg.m} n={cfg.n} k={cfg.k} B={cfg.batch_size} "
          f"au_stat={cfg.au_stat} au_hidden_scale={cfg.au_hidden_scale} reg={cfg.reg_param} "
          f"lr {cfg.au_lr}/{cfg.im_lr} log_every={cfg.log_every}")
    for c in counters:
        c.reset()
    torch.cuda.synchronize()
    logger = MemoryLogger()
    t0 = time.perf_counter()
    state = tg.train_gim_gaussian(cfg, logger=logger, progress=False, device="cuda")
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    ckpts = sorted(os.listdir(os.path.join(outdir, "ckpts")))
    want_ckpts = [f"model_{s:08d}" for s in range(GAUSS_SAVE_EVERY - 1, GAUSS_STEPS,
                                                   GAUSS_SAVE_EVERY)]
    if state.step != GAUSS_STEPS - 1 or ckpts != want_ckpts:
        fail(f"gaussian loop: state.step {state.step}, checkpoints {ckpts}")
    acc = logger.stats["train_accuracy"]["au_acc"]
    if len(acc) != GAUSS_STEPS or not all(math.isfinite(v) for cat in logger.stats.values()
                                          for pts in cat.values() for _, v in pts):
        fail(f"gaussian loop: {len(acc)} steps logged, or non-finite scalars")
    last = [v for _, v in acc[-cfg.log_every:]]
    print(f"  loop: {GAUSS_STEPS} steps in {loop_s:.2f} s ({GAUSS_STEPS / loop_s:.1f} steps/s "
          f"with the state build, the host's logging and {len(ckpts)} checkpoints); "
          f"checkpoints {ckpts}")
    print(f"  au_acc over the last {cfg.log_every} steps {statistics.mean(last):.4f} (step "
          f"{acc[-1][0]}: {acc[-1][1]:.4f}); closed-form Nash value game_value_mnk(1, 5, 10, 10) "
          f"= {game_value_mnk(m=1, n=5, d=10, k=10):.4f} (a record: the game plateaus after "
          f"~1e5 steps)")

    resume_at = GAUSS_STEPS - GAUSS_SAVE_EVERY - 1
    resumed = tg.train_gim_gaussian(
        dataclasses.replace(cfg, resume_from_ckpt=os.path.join("ckpts", f"model_{resume_at:08d}")),
        logger=MemoryLogger(), progress=False, device="cuda")
    if resumed.step != state.step:
        fail(f"gaussian resume: state.step {resumed.step}")
    diff = max((a - b).abs().max().item()
               for player in ("au", "im")
               for a, b in zip(getattr(resumed, player).parameters(),
                               getattr(state, player).parameters()))
    print(f"  resume from model_{resume_at:08d}: {resumed.step - resume_at} steps to step "
          f"{resumed.step}; largest parameter difference from the uninterrupted run {diff:.3e}")
    if not math.isfinite(diff):
        fail("gaussian resume: non-finite parameters")

    tg.train_chunk(state, cfg.log_every).cpu()  # warm
    t0 = time.perf_counter()
    for _ in range(GAUSS_TIMED_CHUNKS):
        tg.train_chunk(state, cfg.log_every).cpu()  # the loop's one read a chunk
    step_s = (time.perf_counter() - t0) / (GAUSS_TIMED_CHUNKS * cfg.log_every)
    print(f"  steady: {1.0 / step_s:.1f} steps/s, {cfg.batch_size / step_s:.0f} episodes/s "
          f"({GAUSS_TIMED_CHUNKS} chunks of {cfg.log_every} steps, each ending in the host's "
          f"read of its metrics), {step_s * 1e3:.3f} ms/step  [{smi_line()}]")
    shutil.rmtree(outdir, ignore_errors=True)
    return {c.name: c.count for c in counters}


class SeededFaces:
    """An in-memory classification dataset of uint8 noise images drawn from a
    seed: ``n_classes`` identities of ``per_class`` images.  It offers what
    ``train_arcface`` reads (``__len__``, ``__getitem__`` -> (image, label),
    ``n_classes``)."""

    def __init__(self, n_classes: int, per_class: int, img_size: int, img_channels: int,
                 seed: int):
        rng = np.random.default_rng(seed)
        self.n_classes, self.per_class = n_classes, per_class
        self.images = rng.integers(0, 256, (n_classes * per_class, img_size, img_size,
                                            img_channels), dtype=np.uint8)

    def __len__(self) -> int:
        return self.images.shape[0]

    def __getitem__(self, index: int):
        return self.images[index], index // self.per_class


def time_train_steps(name: str, step, args, n: int, batch: int) -> None:
    """Steps/s of a baseline's train step over ``n`` steps after one, ending when the
    host has read the loss."""
    step(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        metrics = step(*args)
    loss = float(metrics["loss"])
    step_s = (time.perf_counter() - t0) / n
    if not math.isfinite(loss):
        fail(f"{name}: non-finite loss")
    print(f"  {name}: {1.0 / step_s:.3f} steps/s, {step_s * 1e3:.2f} ms/step ({n} steps after "
          f"one, batch {batch}), loss {loss:.4f}  [{smi_line()}]")


def check_authenticators_card_vs_cpu(agents, ds, n_episodes: int) -> None:
    """Scores of one batch of ``ds``'s episodes, f32, TF32 off: each authenticator
    built on the card against the same built on the CPU."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    episodes = [ds[i] for i in range(n_episodes)]
    test, si = (np.stack([e[k] for e in episodes]).astype(np.float32) / 127.5 - 1.0
                for k in ("real_sample", "si_sample"))
    for name, build in agents:
        got = build(EVAL_DEVICE).act(test_sample=test, si_sample=si)[0]
        want = build("cpu").act(test_sample=test, si_sample=si)[0]
        compare(f"{name} scores of {n_episodes} episodes (card vs CPU)", torch.from_numpy(got),
                torch.from_numpy(want), SLICE_TOL, SLICE_TOL)


def run_grid(label: str, ds, gim_dir: str, baseline_type, baseline_dir, tables,
             counters, outdir: str) -> tuple:
    """``eval_authentication_task`` over ``ds`` in batches of EVAL_BATCH with the
    calibration columns and the score dumps (without a baseline when
    ``baseline_type`` is None); checks the CSV, the scores and every launch count,
    and prints each row's seconds and episodes/s.  Returns the grid's launches and
    its rows."""
    from optimalstrategiesagainstgenerativeattacks_torch.eval import authentication as auth

    n_rows = len(IM_TYPES) * (1 if baseline_type is None else 2)
    n_batches = -(-len(ds) // EVAL_BATCH)
    per_batch = eval_launches_per_batch(*tables, baseline_type)
    csv_path = os.path.join(outdir, f"{label}_results.csv")
    dump_dir = os.path.join(outdir, f"{label}_scores")
    # each row's seconds, the seconds of building its two agents (the GIM ones
    # restore a checkpoint) and its launches: the task calls eval_game_for_pair
    # once a row, which builds the agents, then rolls the game out
    seen, originals, build_s = [], {}, [0.0]

    def timed(name):
        fn = originals[name] = getattr(auth, name)

        def call(*args, **kw):
            before = {c.name: c.count for c in counters}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            if name == "eval_game_for_pair":
                seen.append((seconds, build_s[0],
                             {c.name: c.count - before[c.name] for c in counters}))
                build_s[0] = 0.0
            else:
                build_s[0] += seconds
            return out
        return call

    for c in counters:
        c.reset()
    for name in ("eval_game_for_pair", "get_authenticator", "get_impersonator"):
        setattr(auth, name, timed(name))
    t0 = time.perf_counter()
    try:
        rows = auth.eval_authentication_task(
            ds=ds, m=ds.m, n=ds.n, k=ds.si, batch_size=EVAL_BATCH, num_workers=0,
            gim_exp_dir=gim_dir, csv_file_path=csv_path, baseline_exp_dir=baseline_dir,
            baseline_type=baseline_type, calibrate_q=0.95, dump_scores_dir=dump_dir,
            device=EVAL_DEVICE)
    finally:
        for name, fn in originals.items():
            setattr(auth, name, fn)
    grid_s = time.perf_counter() - t0
    launches = {c.name: c.count for c in counters}
    copies = launches.pop("adain_nhwc_copy")

    with open(csv_path, newline="") as f:
        lines = list(csv.reader(f))
    header = [""] + list(auth.CSV_COLS) + list(auth.CAL_COLS)
    if lines[0] != header or len(lines) != n_rows + 1 or not len(rows) == len(seen) == n_rows:
        fail(f"{label} grid: CSV header {lines[0]} and {len(lines) - 1} rows, "
             f"{len(rows)} rows returned")
    want_total = {name: 0 for name in launches}
    for line, row, (seconds, agents_s, got) in zip(lines[1:], rows, seen):
        au, im = row["au_type"], row["im_type"]
        if line[1:3] != [au, im]:
            fail(f"{label} grid: CSV row {line[:3]} for {au} vs {im}")
        scores = np.load(os.path.join(dump_dir, f"scores_{au}_{im}.npz"))
        for key in ("score_real", "score_fake"):
            if scores[key].shape != (len(ds),) or not np.isfinite(scores[key]).all():
                fail(f"{label} grid, {au} vs {im}: {key} of shape {scores[key].shape}, "
                     f"or not finite")
        if not (0.0 <= row["auc"] <= 1.0 and all(math.isfinite(row[c]) for c in auth.CAL_COLS)):
            fail(f"{label} grid, {au} vs {im}: auc {row['auc']} or a calibration column")
        want = {name: n_batches * n for name, n in per_batch[f"{au}_vs_{im}"].items()}
        copies = got.pop("adain_nhwc_copy")
        print(f"  {au} vs {im}: acc {row['acc']:.4f} (fake {row['acc_on_fake']:.4f}, real "
              f"{row['acc_on_real']:.4f}), auc {row['auc']:.4f}, acc_cal {row['acc_cal']:.4f}; "
              f"{seconds:.3f} s, {len(ds) / seconds:.1f} episodes/s; building the agents "
              f"{agents_s:.3f} s, the rollout {len(ds) / (seconds - agents_s):.1f} episodes/s; "
              f"launches {got} "
              f"(expected {want}), layout copies {copies}")
        if got != want or copies:
            fail(f"{label} grid, {au} vs {im}: launches {got}, expected {want}, "
                 f"{copies} layout copies")
        for name, n in want.items():
            want_total[name] += n
    agents_s = sum(a for _, a, _ in seen)
    print(f"  {label} grid: {grid_s:.3f} s for {n_rows} rows of {len(ds)} episodes "
          f"({n_batches} batches of {EVAL_BATCH}, the last padded), "
          f"{n_rows * len(ds) / grid_s:.1f} episodes/s; building the agents {agents_s:.3f} s; "
          f"launches {launches}  [{smi_line()}]")
    if launches != want_total or copies:
        fail(f"{label} grid: launches {launches}, expected {want_total}; {copies} layout copies")
    return launches, rows


def run_eval_flagship(cfg, counters) -> dict:
    """Phase 8: a 2-step checkpoint of ``cfg`` (the flagship) and a Siamese baseline,
    then the grid."""
    from optimalstrategiesagainstgenerativeattacks_torch.baselines import training as btrain
    from optimalstrategiesagainstgenerativeattacks_torch.data.episodic import EpisodicBatchLoader
    from optimalstrategiesagainstgenerativeattacks_torch.eval import authentication as auth
    from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg
    from optimalstrategiesagainstgenerativeattacks_torch.train.checkpoints import CheckpointIO
    from optimalstrategiesagainstgenerativeattacks_torch.utils.config import save_args

    outdir = os.path.join(BUILD_DIR, "chip_smoke_eval")
    shutil.rmtree(outdir, ignore_errors=True)
    gim_dir, siam_dir = os.path.join(outdir, "gim"), os.path.join(outdir, "siamese")
    seed = cfg.seed
    rng = np.random.default_rng(seed + 4)
    batches = [{key: rng.integers(0, 256, (cfg.batch_size, n, cfg.img_size, cfg.img_size,
                                           cfg.img_channels), dtype=np.uint8)
                for key, n in (("real_sample", cfg.n), ("leaked_sample", cfg.m),
                               ("si_sample", cfg.k))} for _ in range(2)]
    state, _ = timg.train_gim_imgs_steps(cfg, iter(batches), 2, device=EVAL_DEVICE)
    save_args(cfg, gim_dir)
    ckpt = CheckpointIO(os.path.join(gim_dir, cfg.ckpt_dir_name)).save(state, state.step)
    del state
    print(f"  GIM: 2 flagship steps (B={cfg.batch_size}, {cfg.compute_dtype}) -> "
          f"{os.path.relpath(ckpt, outdir)}")

    per_class = cfg.m + cfg.n + cfg.k + 1
    siam_cfg = dict(outdir=siam_dir, img_size=cfg.img_size, img_channels=cfg.img_channels,
                    lr=1e-3, batch_size=EVAL_BATCH, n_epochs=1, save_every=10**6, seed=seed)
    siam_ds = SeededEpisodes(cfg, 4 * EVAL_BATCH, per_class, seed + 5)
    t0 = time.perf_counter()
    model, metrics = btrain.train_siamese(siam_cfg, siam_ds, progress=False, device=EVAL_DEVICE)
    print(f"  Siamese: train_siamese, 4 batch-hard steps of {EVAL_BATCH} episodes "
          f"({EVAL_BATCH * (cfg.m + cfg.n + cfg.k)} images): {time.perf_counter() - t0:.2f} s "
          f"with the build and a checkpoint; loss {metrics['loss']:.4f} acc {metrics['acc']:.4f}")
    batch = next(iter(EpisodicBatchLoader(siam_ds, EVAL_BATCH, seed=seed)))
    pool = np.concatenate([batch[k] for k in ("real_sample", "si_sample", "leaked_sample")], 1)
    time_train_steps("Siamese batch-hard step",
                     btrain.make_siamese_batchhard_step(
                         model, torch.optim.Adam(model.parameters(), lr=1e-3)), (pool,), 5,
                     EVAL_BATCH)
    del model

    ds = SeededEpisodes(cfg, EVAL_EPISODES, per_class, seed + 6)
    launches, _ = run_grid("flagship", ds, gim_dir, "siamese", siam_dir,
                        (EVAL_ADAIN_SITES, EVAL_ATTENTION_SITES), counters, outdir)
    gim_args = dict(auth.load_args(gim_dir), compute_dtype="float32")
    siam_ckpt, siam_args = auth.get_exp_args_from_dir(siam_dir)
    check_authenticators_card_vs_cpu((
        ("gim", lambda device: auth.get_gim_authenticator(ckpt, gim_args, device)),
        ("siamese", lambda device: auth.get_siamese_authenticator(siam_ckpt, siam_args, device)),
    ), ds, 8)
    auth._RESTORE_CACHE.clear()
    shutil.rmtree(outdir, ignore_errors=True)
    return launches


def run_eval_vox(seed: int, counters, vox_dir: str, vox_cfg) -> dict:
    """Phase 9: ArcFace at the VoxCeleb widths, then the grid against phase 7's checkpoint."""
    from optimalstrategiesagainstgenerativeattacks_torch.baselines import training as btrain
    from optimalstrategiesagainstgenerativeattacks_torch.eval import authentication as auth

    outdir = os.path.join(BUILD_DIR, "chip_smoke_eval")
    shutil.rmtree(outdir, ignore_errors=True)
    arc_dir = os.path.join(outdir, "arcface")
    arc_cfg = dict(outdir=arc_dir, num_layers=50, dropout=0.6, img_size=vox_cfg.img_size,
                   img_channels=vox_cfg.img_channels, emb_dim=512, th=1.5, lr=1e-3,
                   batch_size=ARCFACE_BATCH, n_epochs=1, save_every=10**6, seed=seed)
    # 3 steps: 3/4 of a batch of identities, 4 images each
    faces = SeededFaces(3 * ARCFACE_BATCH // 4, 4, vox_cfg.img_size, vox_cfg.img_channels,
                        seed + 8)
    t0 = time.perf_counter()
    model, metrics = btrain.train_arcface(arc_cfg, faces, progress=False, device=EVAL_DEVICE)
    print(f"  ArcFace (ir_se, 50 layers, {vox_cfg.img_size}x{vox_cfg.img_size}x"
          f"{vox_cfg.img_channels}, emb 512, {faces.n_classes} identities): train_arcface, "
          f"{len(faces) // ARCFACE_BATCH} steps of {ARCFACE_BATCH}: {time.perf_counter() - t0:.2f} s with the build "
          f"and a checkpoint; loss {metrics['loss']:.4f} acc {metrics['acc']:.4f}")
    batch = {"image": faces.images[:ARCFACE_BATCH],
             "label": np.arange(ARCFACE_BATCH) // faces.per_class}
    time_train_steps("ArcFace step", btrain.make_arcface_train_step(
        model, torch.optim.Adam(model.parameters(), lr=1e-3)),
        (batch, torch.Generator(device=EVAL_DEVICE).manual_seed(seed)), 3, ARCFACE_BATCH)
    del model

    per_class = vox_cfg.m + vox_cfg.n + vox_cfg.k + 1
    ds = SeededEpisodes(vox_cfg, VOX_EVAL_EPISODES, per_class, seed + 9)
    launches, _ = run_grid("VoxCeleb", ds, vox_dir, "arcface", arc_dir,
                        (VOX_EVAL_ADAIN_SITES, VOX_EVAL_ATTENTION_SITES), counters, outdir)
    arc_ckpt, arc_args = auth.get_exp_args_from_dir(arc_dir)
    check_authenticators_card_vs_cpu((
        ("arcface", lambda device: auth.get_arcface_authenticator(arc_ckpt, arc_args, device)),
    ), ds, 4)
    auth._RESTORE_CACHE.clear()
    for d in (outdir, vox_dir):
        shutil.rmtree(d, ignore_errors=True)
    return launches


def flagship_per_step() -> dict:
    """K1, K1b and K2 launches of one flagship train step."""
    return {"adain_fwd": sum(ADAIN_SITES.values()), "adain_bwd": sum(ADAIN_SITES.values()),
            "attention_core_fwd": sum(ATTENTION_SITES.values())}


def feed_config(name: str, seed: int):
    """The flagship (ImageGameConfig's defaults) or the VoxCeleb2 paper hparams."""
    from optimalstrategiesagainstgenerativeattacks_torch.utils.config import ImageGameConfig

    if name == "flagship":
        return ImageGameConfig(seed=seed)
    return ImageGameConfig(img_size=64, img_channels=3, au_lr=1e-4, im_lr=1e-4,
                           env_noise_mapping_lr=1e-6, reg_param=10.0, seed=seed)


def feed_dataset(name: str, cfg, seed: int) -> SeededEpisodes:
    """Phase 12's set of a config (FEED_SETS), ds_n_examples_per_cls episodes a class.
    The flagship's host path is the Omniglot reader's batched gather
    (``OmniglotGIMDataSet.sample_batch``); the VoxCeleb set is mirrored and its
    host path assembles episode by episode, as ``ImgGIMDataSet`` does."""
    from optimalstrategiesagainstgenerativeattacks_torch.data.episodic import OmniglotGIMDataSet

    n_classes, per_class = FEED_SETS[name]
    ds = SeededEpisodes(cfg, n_classes, per_class, seed, FEED_EXAMPLES_PER_CLASS,
                        mirror=name == "vox")
    if name == "flagship":
        ds._stacked = ds.images
        ds.sample_batch = OmniglotGIMDataSet.sample_batch.__get__(ds)
    return ds


def check_device_batches(name: str, loader, ds, seed: int) -> None:
    """The device loader's batches: on the card, each image one frame of its
    episode's class (flipped or not), the frames of an episode distinct, flips
    seen where the set mirrors; each epoch's classes the numpy permutation's."""
    take = ds.m + ds.n + ds.k
    loader.set_epoch(0)
    flipped = plain = 0
    with contextlib.closing(iter(loader)) as it:
        for _, batch in zip(range(2), it):
            if any(v.device.type != torch.device(FEED_DEVICE).type for v in batch.values()):
                fail(f"{name}: a device batch off the card")
            e = FEED_CHECKED_EPISODES
            cls = batch["class"][:e].long()
            ep = torch.cat([batch[k][:e] for k in ("leaked_sample", "real_sample", "si_sample")],
                           1).flatten(2)
            if ep.shape[1] != take or batch["real_sample"].dtype != torch.uint8:
                fail(f"{name}: device batch of {ep.shape[1]} images an episode")
            frames = loader.data[cls]
            same = (ep[:, :, None] == frames.flatten(2)[:, None]).all(-1)  # [e, take, t]
            flip = (ep[:, :, None] == frames.flip(3).flatten(2)[:, None]).all(-1)
            hits = same | flip
            if not bool((hits.sum(-1) == 1).all()):
                fail(f"{name}: a device-batch image is no single frame of its class")
            frame = hits.int().argmax(-1).sort(1).values
            if bool((frame[:, 1:] == frame[:, :-1]).any()):
                fail(f"{name}: an episode repeats a frame")
            flipped += int(flip.any(-1).sum())
            plain += int(same.any(-1).sum())
    if (ds.mirror and not (flipped and plain)) or (not ds.mirror and flipped):
        fail(f"{name}: {flipped} flipped and {plain} plain images, mirror={ds.mirror}")
    n = len(ds)
    epochs = (0, 1) if name == "flagship" else (0,)
    for epoch in epochs:
        loader.set_epoch(epoch)
        got = torch.cat([b["class"] for b in loader]).cpu().numpy()
        want = np.random.default_rng((seed, epoch)).permutation(n) // ds.example_cnt_per_class
        if got.dtype != np.int32 or not np.array_equal(got, want[:len(got)]):
            fail(f"{name}: epoch {epoch}'s classes differ from the numpy permutation")
    print(f"  device batches: {2 * FEED_CHECKED_EPISODES} episodes of {take} images, each a "
          f"distinct frame of its class ({flipped} flipped, {plain} plain); epochs {epochs}: "
          f"{len(loader)} batches each, classes equal to "
          f"np.random.default_rng((seed, epoch)).permutation({n}) // {ds.example_cnt_per_class}")


def check_prefetch_bytes(name: str, cfg, ds, seed: int) -> None:
    """Batches through device_prefetch (side stream, pinned copies) equal the host
    loader's byte for byte while the current stream is kept busy before each use."""
    from optimalstrategiesagainstgenerativeattacks_torch.data.episodic import EpisodicBatchLoader
    from optimalstrategiesagainstgenerativeattacks_torch.data.prefetch import device_prefetch

    host = EpisodicBatchLoader(ds, cfg.batch_size, seed=seed, num_workers=cfg.num_workers)
    host.set_epoch(5)
    want = [b for _, b in zip(range(FEED_PREFETCH_CHECKED), host)]
    host.set_epoch(5)
    a = torch.randn(4096, 4096, device=FEED_DEVICE, dtype=torch.bfloat16)
    out = torch.empty_like(a)
    got = []
    with contextlib.closing(device_prefetch(iter(host), FEED_DEVICE, cfg.prefetch_depth)) as it:
        for _, batch in zip(range(FEED_PREFETCH_CHECKED), it):
            for _ in range(100):  # ~20 ms on the stream that reads the batch next
                torch.mm(a, a, out=out)
            got.append({k: v.clone() for k, v in batch.items()})
            del batch
    for i, (g, w) in enumerate(zip(got, want)):
        for k in w:
            on_device = g[k].device.type == torch.device(FEED_DEVICE).type
            if not (on_device and np.array_equal(g[k].cpu().numpy(), w[k])):
                fail(f"{name}: prefetched batch {i} {k} differs from the host loader's")
    print(f"  device_prefetch (depth {cfg.prefetch_depth}, pinned, side stream): "
          f"{FEED_PREFETCH_CHECKED} batches equal to the host loader's, byte for byte")


def run_feed(name: str, seed: int, counters) -> SeededEpisodes:
    """Phase 12 at one config: the loaders' checks, then train steps fed by the device
    loader, the host loader with prefetch and with prefetch_depth 0, in the order
    FEED_ORDER, the same steps each; every run's launches checked.  Returns the set."""
    from optimalstrategiesagainstgenerativeattacks_torch.data.device_sampler import (
        DeviceEpisodicLoader,
    )
    from optimalstrategiesagainstgenerativeattacks_torch.data.episodic import EpisodicBatchLoader
    from optimalstrategiesagainstgenerativeattacks_torch.data.prefetch import device_prefetch
    from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg

    cfg = feed_config(name, seed)
    ds = feed_dataset(name, cfg, seed)
    per_step = flagship_per_step() if name == "flagship" else VOX_LAUNCHES["train_step"]
    n_steps = FEED_STEPS[name]
    batch_mb = cfg.batch_size * (cfg.m + cfg.n + cfg.k) * cfg.img_size ** 2 * cfg.img_channels / 1e6
    print(f"  {name}: {ds.images.shape[0]} classes x {ds.images.shape[1]} images of "
          f"{cfg.img_size}x{cfg.img_size}x{cfg.img_channels}, {ds.images.nbytes / 1e6:.1f} MB "
          f"uint8; {ds.example_cnt_per_class} episodes a class; batch {cfg.batch_size} "
          f"episodes, {batch_mb:.2f} MB uint8; mirror {ds.mirror}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    device_loader = DeviceEpisodicLoader(ds, cfg.batch_size, seed=seed, device=FEED_DEVICE)
    torch.cuda.synchronize()
    print(f"  upload of the set: {time.perf_counter() - t0:.3f} s")
    host_loader = EpisodicBatchLoader(ds, cfg.batch_size, seed=seed, num_workers=cfg.num_workers)
    check_device_batches(name, device_loader, ds, seed)
    check_prefetch_bytes(name, cfg, ds, seed)

    device_loader.set_epoch(1)
    with contextlib.closing(iter(device_loader)) as it:
        next(it)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(FEED_ASSEMBLY_BATCHES):
            next(it)
        end.record()
        end.synchronize()
    print(f"  device loader alone: {start.elapsed_time(end) / FEED_ASSEMBLY_BATCHES:.4f} ms a "
          f"batch (CUDA events over {FEED_ASSEMBLY_BATCHES} batches, back to back)")

    device_loader.set_epoch(2)
    state, _ = timg.train_gim_imgs_steps(cfg, iter(device_loader), 1, device=FEED_DEVICE)
    rates = {kind: [] for kind in dict.fromkeys(FEED_ORDER)}
    for run, kind in enumerate(FEED_ORDER):
        loader = device_loader if kind == "device" else host_loader
        loader.set_epoch(10 + run)
        if kind == "device":
            batches = iter(loader)
        else:
            depth = cfg.prefetch_depth if kind == "prefetch" else 0
            batches = device_prefetch(iter(loader), FEED_DEVICE, depth)
        with contextlib.closing(batches):
            state, _ = timg.train_gim_imgs_steps(cfg, batches, 1, state=state)  # fills the pipeline
            torch.cuda.synchronize()
            for c in counters:
                c.reset()
            t0 = time.perf_counter()
            state, history = timg.train_gim_imgs_steps(cfg, batches, n_steps, state=state)
            step_s = (time.perf_counter() - t0) / n_steps
        launches = {c.name: c.count for c in counters}
        copies = launches.pop("adain_nhwc_copy")
        want = {k: n * n_steps for k, n in per_step.items()}
        if launches != want or copies:
            fail(f"{name}, {kind} run: launches {launches}, expected {want}, {copies} copies")
        if not all(math.isfinite(v) for m in history for v in m.values()):
            fail(f"{name}, {kind} run: non-finite metrics")
        rates[kind].append(1.0 / step_s)
        print(f"  run {run + 1}, {kind}: {1.0 / step_s:.3f} steps/s ({step_s * 1e3:.2f} ms/step "
              f"over {n_steps} steps after one); launches {launches}")
    print(f"  {name} steps/s, mean of two runs each: " + ", ".join(
        f"{kind} {statistics.mean(r):.3f} ({' / '.join(f'{x:.3f}' for x in r)})"
        for kind, r in rates.items()) + f"  [{smi_line()}]")
    del state, device_loader
    torch.cuda.empty_cache()
    return ds


def seed_dirs_ok(outdir: str, seeds, ckpts: list) -> None:
    """Each seed's directory holds its args.json (its own seed and outdir, no
    multi-seed lists) and exactly ``ckpts``."""
    from optimalstrategiesagainstgenerativeattacks_torch.utils.config import load_args

    for s in seeds:
        seed_dir = os.path.join(outdir, f"seed_{s}")
        args = load_args(seed_dir)
        got = sorted(os.listdir(os.path.join(seed_dir, "ckpts")))
        if (args["seed"] != s or args["outdir"] != seed_dir or {"seeds", "au_lrs", "im_lrs"} & set(args)
                or got != ckpts):
            fail(f"multi-seed: {seed_dir}: args seed {args['seed']}, checkpoints {got}")


def timed_multisteps(ms, ds, n: int, epoch: int) -> tuple:
    """Seconds a multi-seed step over ``n`` steps after one, each seed on its own
    device loader over one resident copy of ``ds``, ending in the host's read of
    the seeds' au_acc; returns (seconds, metrics, fake) of the last step."""
    from optimalstrategiesagainstgenerativeattacks_torch.data.device_sampler import (
        DeviceEpisodicLoader,
    )
    from optimalstrategiesagainstgenerativeattacks_torch.train import multiseed as tms

    bs = ms.states[0].cfg.batch_size
    first = DeviceEpisodicLoader(ds, bs, seed=ms.seeds[0], device=FEED_DEVICE)
    loaders = [first] + [DeviceEpisodicLoader(ds, bs, seed=s, device=FEED_DEVICE, data=first.data)
                         for s in ms.seeds[1:]]
    for loader in loaders:
        loader.set_epoch(epoch)
    iters = [iter(loader) for loader in loaders]
    tms.multiseed_train_step(ms, tms.stack_batches([next(it) for it in iters]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        metrics, fake = tms.multiseed_train_step(ms, tms.stack_batches([next(it) for it in iters]))
    metrics["au_acc"].cpu()
    return (time.perf_counter() - t0) / n, metrics, fake


def run_multiseed(seed: int, counters, ds, flagship_step_s: float) -> dict:
    """Phase 13 at the flagship: ``train_multiseed_gim_imgs`` with MULTISEED_SEEDS
    seeds on ``ds`` (phase 12's flagship set), its launches, a seed's checkpoint
    through the eval restore, then timed multi-steps.  Returns the launches."""
    from optimalstrategiesagainstgenerativeattacks_torch.eval import authentication as teval
    from optimalstrategiesagainstgenerativeattacks_torch.train import multiseed as tms
    from optimalstrategiesagainstgenerativeattacks_torch.utils.config import ImageGameConfig

    outdir = os.path.join(BUILD_DIR, "chip_smoke_multiseed")
    shutil.rmtree(outdir, ignore_errors=True)
    cfg = ImageGameConfig(seed=seed)
    seeds = [seed + i for i in range(MULTISEED_SEEDS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    ms, readings = tms.train_multiseed_gim_imgs(cfg, seeds, ds, outdir, MULTISEED_STEPS,
                                                save_every=2, log_every=2, device=FEED_DEVICE)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = {c.name: c.count for c in counters}
    copies = launches.pop("adain_nhwc_copy")
    want = {k: n * MULTISEED_SEEDS * MULTISEED_STEPS for k, n in flagship_per_step().items()}
    print(f"  train_multiseed_gim_imgs: {len(seeds)} seeds x {MULTISEED_STEPS} steps in "
          f"{loop_s:.2f} s (states, loaders, first-step warm-up, checkpoints); launches "
          f"{launches}, expected {want} ({len(seeds)} seeds x {MULTISEED_STEPS} steps x "
          f"{flagship_per_step()})")
    if launches != want or copies:
        fail(f"multi-seed: launches {launches}, expected {want}, {copies} layout copies")
    if len(readings) != MULTISEED_STEPS // 2 or not all(np.isfinite(a).all() and a.shape == (
            len(seeds),) for _, a in readings):
        fail(f"multi-seed: au_acc readings {readings}")
    seed_dirs_ok(outdir, seeds, [f"model_{s:08d}" for s in range(2, MULTISEED_STEPS + 1, 2)])

    # the last seed's checkpoint through the eval CLI's restore, scored beside its state
    seed_dir = os.path.join(outdir, f"seed_{seeds[-1]}")
    ckpt, args = teval.get_exp_args_from_dir(seed_dir)
    au = teval.get_gim_authenticator(ckpt, args, FEED_DEVICE)
    episodes = [ds.sample_episode(i, np.random.default_rng(i)) for i in range(8)]
    test, si = (np.stack([e[k] for e in episodes]).astype(np.float32) / 127.5 - 1.0
                for k in ("real_sample", "si_sample"))
    got = au.act(test_sample=test, si_sample=si)[0]
    with torch.no_grad():
        want_scores = ms.states[-1].au(*(torch.from_numpy(x).to(FEED_DEVICE).to(torch.bfloat16)
                                         for x in (test, si)))
    compare(f"eval restore of {os.path.basename(ckpt)} (seed {seeds[-1]}) against its state, "
            f"scores of 8 episodes", torch.from_numpy(got), want_scores.float().cpu(),
            *TOL[torch.bfloat16])

    step_s, metrics, fake = timed_multisteps(ms, ds, MULTISEED_TIMED, epoch=50)
    if tuple(fake.shape) != (len(seeds), cfg.batch_size, cfg.n, cfg.img_size, cfg.img_size,
                             cfg.img_channels) or not (
            torch.isfinite(fake).all() and fake.abs().max() <= 1.0):
        fail(f"multi-seed: fake of shape {tuple(fake.shape)}, or non-finite or outside [-1, 1]")
    if not all(bool(torch.isfinite(v).all()) and v.shape == (len(seeds),) for v in metrics.values()):
        fail("multi-seed: non-finite metrics, or not one a seed")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  steady: {1.0 / step_s:.3f} multi-steps/s = {len(seeds) / step_s:.3f} seed-steps/s "
          f"({step_s * 1e3:.2f} ms a multi-step over {MULTISEED_TIMED} after one; one seed's "
          f"step in phase 6 of this call {flagship_step_s * 1e3:.2f} ms, x{len(seeds)} = "
          f"{len(seeds) * flagship_step_s * 1e3:.2f} ms); peak memory {peak:.2f} GiB  "
          f"[{smi_line()}]")
    del ms, au
    shutil.rmtree(outdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def check_multiseed_f32(seed: int, ds) -> None:
    """Each seed of two f32 multi-seed steps against a single-seed run at that seed on
    the same batches, on the card, with cuDNN's deterministic algorithms (its
    default ones sum in a run-dependent order, and the first Adam steps turn
    rounding into lr-sized moves): metrics within MULTISEED_TOL of max(1, |ref|)
    (accuracies 2 / B); parameters within MULTISEED_TOL of each tensor's max|ref|
    where the gradient is above 1e-6 of the player's largest, else 2 lr a step,
    and at most MULTISEED_FLIPS entries a tensor held to 2 lr a step only."""
    import dataclasses

    from optimalstrategiesagainstgenerativeattacks_torch.data.device_sampler import (
        DeviceEpisodicLoader,
    )
    from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg
    from optimalstrategiesagainstgenerativeattacks_torch.train import multiseed as tms
    from optimalstrategiesagainstgenerativeattacks_torch.utils.config import ImageGameConfig

    cfg = ImageGameConfig(seed=seed, compute_dtype="float32")
    seeds, n_steps = [seed, seed + 1], 2
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    batches = []
    for s in seeds:
        loader = DeviceEpisodicLoader(ds, cfg.batch_size, seed=s, device=FEED_DEVICE)
        loader.set_epoch(3)
        batches.append([b for _, b in zip(range(n_steps), loader)])
    ms = tms.create_multiseed_state(cfg, seeds, FEED_DEVICE)
    history = [tms.multiseed_train_step(ms, tms.stack_batches([b[t] for b in batches]))[0]
               for t in range(n_steps)]
    for i, s in enumerate(seeds):
        seed_cfg = dataclasses.replace(cfg, seed=s)
        single = timg.create_state(seed_cfg, *timg.build_models(seed_cfg), s, FEED_DEVICE)
        single_history = [timg.train_step(single, b)[0] for b in batches[i]]
        worst, exact, flips = [], True, 0
        for t, (got, want) in enumerate(zip(history, single_history)):
            for k, ref in want.items():
                ref, g = ref.item(), got[k][i].item()
                limit = 2.0 / cfg.batch_size if "acc" in k else MULTISEED_TOL * max(1.0, abs(ref))
                if not (math.isfinite(g) and abs(g - ref) <= limit):
                    fail(f"multi-seed f32, seed {s}, step {t}: {k} {g} against {ref}")
                worst.append((abs(g - ref) / limit, k))
                exact &= g == ref
        for player, lrs in (("au", (cfg.au_lr,)), ("im", (cfg.im_lr, cfg.env_noise_mapping_lr))):
            mine = dict(getattr(ms.states[i], player).named_parameters())
            ref_params = dict(getattr(single, player).named_parameters())
            opt = getattr(single, f"opt_{player}")
            grads = {k: opt.state[p]["exp_avg"] for k, p in ref_params.items()}
            floor = 1e-6 * max(g.abs().max().item() for g in grads.values())
            for k, want in ref_params.items():
                err = (mine[k] - want).detach().abs()
                lr = lrs[1] if k.startswith("env_noise_mapper.") else lrs[0]
                limit = MULTISEED_TOL * want.abs().max().item()
                big = (grads[k].abs() > floor) & (err > limit)
                flips += int(big.sum())
                if int(big.sum()) > MULTISEED_FLIPS or not bool((err <= max(
                        limit, 2 * lr * n_steps)).all()):
                    fail(f"multi-seed f32, seed {s}: {player} {k} off by {err.max().item():.3e} "
                         f"({int(big.sum())} entries with a gradient above the floor)")
                worst.append((min(err.max().item(), limit) / limit, k))
                exact &= bool((err == 0).all())
        print(f"  f32, seed {s}: {n_steps} multi-seed steps against a single-seed run on the "
              f"same batches: {len(worst)} metrics and parameters, worst error / limit "
              f"{max(worst)[0]:.3f} ({max(worst)[1]}); entries held to 2 lr a step only: "
              f"{flips}; bit-equal: {exact}")
        del single
    del ms
    torch.backends.cudnn.deterministic = deterministic
    torch.cuda.empty_cache()


def run_multiseed_small(seed: int, counters) -> None:
    """The multi-seed CLI's own defaults (the head-to-head studies' config) with
    SMALL_SEEDS seeds: a single-seed step's launches and steps/s, then
    ``train_multiseed_gim_imgs`` (launches: seeds x steps x one step's) and timed
    multi-steps."""
    from optimalstrategiesagainstgenerativeattacks_torch.data.device_sampler import (
        DeviceEpisodicLoader,
    )
    from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg
    from optimalstrategiesagainstgenerativeattacks_torch.train import multiseed as tms

    outdir = os.path.join(BUILD_DIR, "chip_smoke_multiseed_small")
    shutil.rmtree(outdir, ignore_errors=True)
    seeds = [seed + i for i in range(SMALL_SEEDS)]
    args, cfg = study_config(seeds, outdir, SeededEpisodes.root)
    ds = SeededEpisodes(cfg, *FEED_SETS["flagship"], seed + 11, FEED_EXAMPLES_PER_CLASS)
    print(f"  config (the CLI's defaults): B={cfg.batch_size} img={cfg.img_size}x{cfg.img_size}x"
          f"{cfg.img_channels} style={cfg.style_dim} m={cfg.m} n={cfg.n} k={cfg.k} "
          f"{cfg.compute_dtype} lr {cfg.au_lr}/{cfg.im_lr}/{cfg.env_noise_mapping_lr}; "
          f"{len(seeds)} seeds; a set of {ds.images.shape[0]} x {ds.images.shape[1]}")

    single = timg.create_state(cfg, *timg.build_models(cfg), seed, FEED_DEVICE)
    loader = DeviceEpisodicLoader(ds, cfg.batch_size, seed=seed, device=FEED_DEVICE)
    it = iter(loader)
    timg.train_step(single, next(it))
    torch.cuda.synchronize()
    for c in counters:
        c.reset()
    timg.train_step(single, next(it))
    per_step = {c.name: c.count for c in counters}
    per_step.pop("adain_nhwc_copy")
    t0 = time.perf_counter()
    for _ in range(SMALL_TIMED):
        metrics, _ = timg.train_step(single, next(it))
    metrics["au_acc"].cpu()
    single_s = (time.perf_counter() - t0) / SMALL_TIMED
    it.close()
    del single, loader, it

    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    ms, readings = tms.train_multiseed_gim_imgs(cfg, seeds, ds, outdir, SMALL_STEPS,
                                                save_every=args.save_every, log_every=5,
                                                args=vars(args), device=FEED_DEVICE)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = {c.name: c.count for c in counters}
    copies = launches.pop("adain_nhwc_copy")
    want = {k: n * len(seeds) * SMALL_STEPS for k, n in per_step.items()}
    print(f"  one single-seed step launches {per_step}; train_multiseed_gim_imgs: "
          f"{SMALL_STEPS} steps in {loop_s:.2f} s, launches {launches}, expected {want}")
    if launches != want or copies:
        fail(f"multi-seed (CLI config): launches {launches}, expected {want}")
    if not all(np.isfinite(a).all() for _, a in readings):
        fail("multi-seed (CLI config): non-finite au_acc")
    seed_dirs_ok(outdir, seeds, [f"model_{SMALL_STEPS:08d}"])
    step_s, metrics, _ = timed_multisteps(ms, ds, SMALL_TIMED, epoch=50)
    if not all(bool(torch.isfinite(v).all()) for v in metrics.values()):
        fail("multi-seed (CLI config): non-finite metrics")
    print(f"  steady: {1.0 / step_s:.3f} multi-steps/s = {len(seeds) / step_s:.3f} seed-steps/s "
          f"({step_s * 1e3:.2f} ms a multi-step); one seed alone {1.0 / single_s:.3f} steps/s "
          f"({single_s * 1e3:.2f} ms a step, x{len(seeds)} = "
          f"{len(seeds) * single_s * 1e3:.2f} ms)  [{smi_line()}]")
    del ms
    shutil.rmtree(outdir, ignore_errors=True)
    torch.cuda.empty_cache()


# ---- phase 14: the rest of the inventory

LEGACY_B = 640  # B' of the flagship generator: 128 episodes x n = 5
LEGACY_STEPS = 10  # timed bf16 steps of the legacy AdaIN stack, after one warm-up step
INVENTORY_CHECK_B = 8  # B' of the f32 card-against-CPU checks at the full widths
SG_B, SG_STYLE = 640, 512
BLUR_SITES = ((512, 8), (256, 16), (128, 32), (1, 32))  # (C, H = W) of blur3x3 at B' = 640
REST_B = 128  # sets of the authenticator's width (512) in the last checks
REST_LR = 1e-4


def legacy_widths() -> list:
    """The channel count of each AdaIN of the legacy stack, in order: 5 res blocks x 2,
    then each up block's input and output."""
    up = [(512, 256), (256, 128), (128, 1)]
    return [512] * 10 + [w for pair in up for w in pair]


class LegacyStack(torch.nn.Module):
    """The flagship generator's AdaIN sites on the legacy blocks: 5 ``AdaResBlock`` at
    4x4x512, then ``AdaResBlockUp`` 512 -> 256 -> 128 -> 1 (the last with 9x9 convs,
    padding 4); each AdaIN's [B', 2C] style is a ``Dense`` of one 512-wide style."""

    def __init__(self, dtype):
        from optimalstrategiesagainstgenerativeattacks_torch.nn.blocks import (
            AdaResBlock,
            AdaResBlockUp,
            Dense,
        )

        super().__init__()
        self.res = torch.nn.ModuleList(AdaResBlock(512, dtype=dtype) for _ in range(5))
        self.up = torch.nn.ModuleList(
            AdaResBlockUp(ci, co, dtype=dtype, **(dict(conv_size=9, padding=4) if co == 1 else {}))
            for ci, co in ((512, 256), (256, 128), (128, 1)))
        self.styles = torch.nn.ModuleList(Dense(512, 2 * w, dtype=dtype) for w in legacy_widths())

    def forward(self, x, style):
        s = [m(style) for m in self.styles]
        for i, blk in enumerate([*self.res, *self.up]):
            x = blk(x, s[2 * i], s[2 * i + 1])
        return x


def legacy_inputs(b: int, gen: torch.Generator, dtype) -> tuple:
    x = torch.randn(b, 512, 4, 4, generator=gen).to(dtype)
    return x.contiguous(memory_format=torch.channels_last), torch.randn(b, 512, generator=gen)


def inventory_module(make, seed: int) -> torch.nn.Module:
    from optimalstrategiesagainstgenerativeattacks_torch.nn.init import init_module

    module = make()
    init_module(module, torch.Generator().manual_seed(seed))
    return module


def check_tensors(what: str, names: list, card: list, ref: list, cpu32: list) -> None:
    """The card's f32 tensors against the CPU's run in f64 (``ref``; the plain versions
    take AdaIN's and instance norm's statistics in f32): each within phase 5's rule,
    |err| <= R1_TOL x its max|ref| + R1_TOL x 1e-3 x the largest max|ref| of all, or
    no further from ``ref`` than twice the CPU's own f32 run (``cpu32``).  Where a
    gradient is the small residue of terms that cancel (a conv in front of a norm, a
    style near 0), f32 rounding alone moves it further than the rule: on the legacy
    stack the CPU's f32 run misses the rule by ~10x there."""
    player = max(w.abs().max().item() for w in ref)
    ratios, yardstick = [], 0
    for k, a, w, c in zip(names, card, ref, cpu32):
        if not torch.isfinite(a).all():
            fail(f"{what}: non-finite {k} on the card")
        w = w.double()
        err = (a.cpu().double() - w).abs().max().item()
        own = (c.double() - w).abs().max().item()
        limit = R1_TOL * w.abs().max().item() + R1_TOL * 1e-3 * player
        if err > limit and err <= 2.0 * own:
            yardstick += 1
            continue
        ratios.append((err / limit, err, own, k))
    ratios.sort(reverse=True)
    print(f"    {what}, {len(names)} tensors against the f64 CPU run; {yardstick} within twice "
          f"the CPU f32 run's own error; error / limit of the worst others: "
          + ", ".join(f"{k} {r:.3f} (CPU f32 {o / (e / r):.3f})" for r, e, o, k in ratios[:3]))
    if ratios and ratios[0][0] > 1.0:
        fail(f"{what}: {ratios[0][3]} off by {ratios[0][0]:.3f} x its limit")


def run_legacy_bf16(seed: int, counters) -> dict:
    """The legacy AdaIN stack at the flagship generator's widths in bf16: steps of
    power iteration, forward, backward and Adam; returns the launches of the run."""
    from optimalstrategiesagainstgenerativeattacks_torch.ops.spectral import power_iterate

    stack = inventory_module(lambda: LegacyStack(torch.bfloat16), seed).cuda()
    opt = torch.optim.Adam(stack.parameters(), lr=1e-4, betas=(0.0, 0.99))
    x, style = (t.cuda() for t in legacy_inputs(LEGACY_B, torch.Generator().manual_seed(seed),
                                                torch.bfloat16))

    def step():
        power_iterate(stack)
        out = stack(x, style)
        loss = out.float().square().mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return out, loss

    torch.cuda.synchronize()
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(LEGACY_STEPS):
        out, loss = step()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / LEGACY_STEPS
    launches = {c.name: c.count for c in counters}
    if tuple(out.shape) != (LEGACY_B, 1, 32, 32) or not torch.isfinite(out).all():
        fail(f"legacy stack: output {tuple(out.shape)} non-finite or of the wrong shape")
    bad = [k for k, p in stack.named_parameters() if not torch.isfinite(p.grad).all()]
    if not math.isfinite(loss.item()) or bad:
        fail(f"legacy stack: non-finite loss or gradients {bad[:3]}")
    steps = LEGACY_STEPS + 1
    per_step = sum(ADAIN_SITES.values())
    print(f"  layout copies in front of the AdaIN kernels: {launches.pop('adain_nhwc_copy')}")
    expected = {"adain_fwd": per_step * steps, "adain_bwd": per_step * steps,
                "attention_core_fwd": 0}
    print(f"  legacy stack, {steps} steps: launches {launches}, expected {expected} "
          f"({per_step} + {per_step} a step at phase 3's flagship AdaIN sites)")
    if launches != expected:
        fail(f"legacy stack: launches {launches}, expected {expected}")
    print(f"  legacy stack bf16 B'={LEGACY_B}: output and gradients finite; warm-up step "
          f"{warm_s:.2f} s; steady {1.0 / step_s:.3f} steps/s, {step_s * 1e3:.2f} ms/step "
          f"(power iteration, forward, backward, Adam)  [{smi_line()}]")
    return launches


def check_legacy_f32(seed: int) -> None:
    """The legacy stack in f32, TF32 off, card against CPU: output and parameter
    gradients, then grad2_penalty of a score and its parameter gradients."""
    from optimalstrategiesagainstgenerativeattacks_torch.kernels import adain as k1
    from optimalstrategiesagainstgenerativeattacks_torch.train.losses import grad2_penalty

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(seed + 5)
    stack = inventory_module(lambda: LegacyStack(None), seed + 5)
    x, style = legacy_inputs(INVENTORY_CHECK_B, gen, torch.float32)
    w = torch.randn(INVENTORY_CHECK_B, 1, 32, 32, generator=gen)
    names = [k for k, _ in stack.named_parameters()]

    def run(device, dtype):
        module = copy.deepcopy(stack).to(device, dtype)
        xd, sd, wd = (t.to(device, dtype) for t in (x, style, w))
        out = module(xd, sd)
        grads = torch.autograd.grad(out.square().mean(), list(module.parameters()))

        def score(a, s):
            return torch.sin(module(a, s) * wd).sum(dim=(1, 2, 3))[:, None]

        before = k1.BWD_LAUNCHES.count
        pen = grad2_penalty(score, (xd, sd))
        first = k1.BWD_LAUNCHES.count - before
        pen_grads = torch.autograd.grad(pen.mean(), list(module.parameters()))
        second = k1.BWD_LAUNCHES.count - before - first
        return ([out.detach().cpu()], [g.cpu() for g in grads], [pen.detach().cpu()],
                [g.cpu() for g in pen_grads], (first, second))

    ref, cpu32 = run("cpu", torch.float64), run("cpu", torch.float32)
    card = run("cuda", torch.float32)
    print(f"  legacy stack f32 B'={INVENTORY_CHECK_B}, card (TF32 off) against the CPU in f64:")
    for i, (what, names_i) in enumerate((("output", ["output"]), ("parameter gradients", names),
                                         ("grad2_penalty", ["penalty"]),
                                         ("grad2_penalty's parameter gradients", names))):
        check_tensors(what, names_i, card[i], ref[i], cpu32[i])
    first, second = card[4]
    print(f"  grad2_penalty through the stack: card {card[2][0].tolist()}, CPU f64 "
          f"{ref[2][0].tolist()}; K1b launches: {first} in the first-order pass (one a site: "
          f"{len(legacy_widths())}), {second} in the parameter gradients' pass")
    if first != len(legacy_widths()) or ref[4] != (0, 0):
        fail(f"grad2_penalty: K1b launches {card[4]} on the card, {ref[4]} on the CPU")


class SGStack(torch.nn.Module):
    """The StyleGAN kit at 32x32, style 512: ``SGConstInputBlock`` (4x4x512), decoders to
    512 (8x8), 256 (16x16) and 128 (32x32), ``SGToImgBlock(1)``; then ``SGFromImgBlock``,
    two ``SGEncoderBlock``s and an ``SGDisBlock`` back down to 4x4x512."""

    def __init__(self, dtype, use_noise: bool):
        from optimalstrategiesagainstgenerativeattacks_torch.nn import blocks as b

        super().__init__()
        self.const = b.SGConstInputBlock(512, 4, SG_STYLE, use_noise=use_noise, dtype=dtype)
        self.dec = torch.nn.ModuleList(
            b.SGDecoderBlock(ci, co, SG_STYLE, use_noise=use_noise, dtype=dtype)
            for ci, co in ((512, 512), (512, 256), (256, 128)))
        self.to_img = b.SGToImgBlock(128, 1, dtype=dtype)
        self.from_img = b.SGFromImgBlock(1, 128, dtype=dtype)
        self.enc = torch.nn.ModuleList((b.SGEncoderBlock(128, 128, 256, SG_STYLE, dtype=dtype),
                                        b.SGEncoderBlock(256, 256, 512, SG_STYLE, dtype=dtype)))
        self.dis = b.SGDisBlock(512, 512, 512, dtype=dtype)

    def forward(self, style, generator=None):
        x = self.const(style, style, generator)
        for blk in self.dec:
            x = blk(x, style, style, generator)
        img = self.to_img(x)
        h, styles = self.from_img(img), []
        for blk in self.enc:
            h, s1, s2 = blk(h)
            styles += [s1, s2]
        return img, self.dis(h), torch.cat(styles, dim=1)


@torch.no_grad()
def randomise_sg(module: torch.nn.Module, gen: torch.Generator) -> None:
    """Random constant images and noise weights (ones and zeros at init)."""
    from optimalstrategiesagainstgenerativeattacks_torch.nn.blocks import NoiseLayer

    for m in module.modules():
        if isinstance(m, NoiseLayer):
            m.weight.copy_(0.5 * torch.randn(m.weight.shape, generator=gen))
    module.const.init_img.copy_(0.5 * torch.randn(module.const.init_img.shape, generator=gen))


def inject_noise(module: torch.nn.Module, seed: int) -> None:
    """Give each noise layer of ``module`` its own noise, drawn on the CPU from ``seed``
    and the layer's place, cast to the input's device and dtype (``noise=``)."""
    from optimalstrategiesagainstgenerativeattacks_torch.nn.blocks import NoiseLayer

    def hook(i):
        def inject(mod, args, kwargs):
            x = args[0]
            noise = torch.randn((x.shape[0], 1, *x.shape[2:]),
                                generator=torch.Generator().manual_seed(seed * 1000 + i))
            return args, dict(kwargs, noise=noise.to(x.device, x.dtype))
        return inject

    layers = [m for m in module.modules() if isinstance(m, NoiseLayer)]
    for i, m in enumerate(layers):
        m.register_forward_pre_hook(hook(i), with_kwargs=True)


def check_sg_kit(seed: int, counters) -> None:
    """The StyleGAN kit: bf16 at B=640 (finite, no kernel launched); f32 card against CPU
    with the same noise injected into both; blur3x3 in bf16 against f32 without cuDNN
    (the native conv), as phase 4 holds the SN convs."""
    from optimalstrategiesagainstgenerativeattacks_torch.ops.image_ops import blur3x3

    stack = inventory_module(lambda: SGStack(torch.bfloat16, True), seed + 6).cuda()
    style = torch.randn(SG_B, SG_STYLE, generator=torch.Generator().manual_seed(seed)).cuda()
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    outs = stack(style, torch.Generator(device="cuda").manual_seed(seed))
    sum(o.float().square().mean() for o in outs).backward()
    torch.cuda.synchronize()
    launches = {c.name: c.count for c in counters}
    bad = [k for k, p in stack.named_parameters() if not torch.isfinite(p.grad).all()]
    if any(not torch.isfinite(o).all() for o in outs) or bad:
        fail(f"SG kit bf16: non-finite outputs or gradients {bad[:3]}")
    print(f"  SG kit bf16 B={SG_B}: outputs {[tuple(o.shape) for o in outs]} finite, "
          f"gradients finite, forward + backward {time.perf_counter() - t0:.2f} s (first "
          f"call); launches {launches}  [{smi_line()}]")
    if any(launches.values()):
        fail(f"SG kit: kernels launched {launches}")
    del stack, outs
    torch.cuda.empty_cache()

    gen = torch.Generator().manual_seed(seed + 7)
    stack = inventory_module(lambda: SGStack(None, True), seed + 7)
    randomise_sg(stack, gen)
    style = torch.randn(INVENTORY_CHECK_B, SG_STYLE, generator=gen)
    names = [k for k, _ in stack.named_parameters()]

    def run(device, dtype, moved: bool = False):
        module = copy.deepcopy(stack).to(device, dtype)
        if moved:  # each parameter moved by about one f32 rounding
            with torch.no_grad():
                for q in module.parameters():
                    q.mul_(1 + 2.0 ** -24 * torch.randn(q.shape, generator=gen, dtype=dtype))
        inject_noise(module, seed + 8)
        outs = module(style.to(device, dtype))
        grads = torch.autograd.grad(sum(o.square().mean() for o in outs),
                                    list(module.parameters()))
        return [o.detach().cpu() for o in outs], [g.cpu() for g in grads]

    ref, cpu32 = run("cpu", torch.float64), run("cpu", torch.float32)
    card = run("cuda", torch.float32)
    print(f"  SG kit f32 B={INVENTORY_CHECK_B}, card (TF32 off) against the CPU in f64, the "
          f"same noise injected into both:")
    check_tensors("outputs", ["image", "discriminator map", "encoder styles"], card[0], ref[0],
                  cpu32[0])
    # the gradients are printed, not held: behind each lrelu sits an instance norm, and
    # a kink that one f32 rounding flips moves them past phase 5's rule, in f64 too
    player = max(w.abs().max().item() for w in ref[1])

    def worst(got):
        return max(((a.double() - w.double()).abs().max().item()
                    / (R1_TOL * w.abs().max().item() + R1_TOL * 1e-3 * player), k)
                   for k, a, w in zip(names, got, ref[1]))

    print("    parameter gradients against the f64 CPU run, error / phase 5's limit of the "
          "worst tensor (not held): " + "; ".join(
              f"{what} {r:.3f} ({k})" for what, (r, k) in (
                  ("card f32", worst(card[1])), ("CPU f32", worst(cpu32[1])),
                  ("CPU f64 with the parameters moved by 2^-24", worst(run("cpu", torch.float64,
                                                                           True)[1])))))

    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    worst = (0.0, None)
    for c, h in BLUR_SITES:
        for fmt in (torch.contiguous_format, torch.channels_last):
            x = torch.randn(SG_B, c, h, h, device="cuda", generator=gen).to(torch.bfloat16)
            x = x.contiguous(memory_format=fmt).requires_grad_(True)
            out = blur3x3(x)
            g = torch.randn(out.shape, device="cuda", generator=gen)
            got = (out, *torch.autograd.grad(out, x, g.to(out.dtype)))
            xf = x.detach().float().requires_grad_(True)
            with torch.backends.cudnn.flags(enabled=False):
                ref = blur3x3(xf)
                want = (ref, *torch.autograd.grad(ref, xf, g))
            for what, a, r in zip(("output", "d input"), got, want):
                err = (a.float() - r).abs().max().item() / r.abs().max().item()
                if not err <= CONV_TOL:
                    fail(f"blur3x3 bf16 [{SG_B},{c},{h},{h}] {fmt}: {what} off by {err:.3g} "
                         f"of its max (limit {CONV_TOL})")
                worst = max(worst, (err, f"{what} at C={c} {h}x{h} {str(fmt)[6:]}"))
    print(f"  blur3x3 bf16 (cuDNN) against f32 without cuDNN at {len(BLUR_SITES)} sites x 2 "
          f"layouts: worst error / max|ref| {worst[0]:.3g} ({worst[1]}; limit {CONV_TOL})")


def check_rest(seed: int) -> None:
    """The set stats, ResMLP/ResMLP2, pixel_norm, the pools, and accumulate and freeze
    over one Adam step, f32 at the authenticator's width (512), card against CPU."""
    from optimalstrategiesagainstgenerativeattacks_torch.nn import blocks, stats
    from optimalstrategiesagainstgenerativeattacks_torch.ops import image_ops
    from optimalstrategiesagainstgenerativeattacks_torch.ops.adain import pixel_norm
    from optimalstrategiesagainstgenerativeattacks_torch.train import utils

    gen = torch.Generator().manual_seed(seed + 10)
    sets = torch.randn(REST_B, 5, 512, generator=gen)
    vec = torch.randn(REST_B, 512, generator=gen)
    img = torch.randn(REST_B, 512, 8, 8, generator=gen)
    atol, rtol = TOL[torch.float32]
    cases = {
        **{name: (getattr(stats, name)(), sets) for name in
           ("MeanStat", "StdStat", "LogVarStat", "MeanStdStat", "MeanLogVarStat")},
        "DoubleFCStat": (inventory_module(lambda: stats.DoubleFCStat(
            512, 2, (1024,), (1024,)), seed + 11), sets),
        "ResMLP": (inventory_module(lambda: blocks.ResMLP([512, 1024, 512]), seed + 12), vec),
        "ResMLP2": (inventory_module(lambda: blocks.ResMLP2([512, 1024, 512]), seed + 13), vec),
    }
    ops = {"pixel_norm": pixel_norm, "max_pool2d": image_ops.max_pool2d,
           "max_pool2d 3/2": lambda t: image_ops.max_pool2d(t, 3, 2),
           "adaptive_avg_pool": image_ops.adaptive_avg_pool}
    print(f"  f32 at width 512, card vs CPU (TF32 off; atol {atol}, rtol {rtol}):")
    for name, (module, x) in cases.items():
        compare(name, copy.deepcopy(module).cuda()(x.cuda()).cpu(), module(x).detach(), atol,
                rtol)
    for name, op in ops.items():
        compare(name, op(img.cuda()).cpu(), op(img), atol, rtol)

    model = inventory_module(lambda: blocks.ResMLP([512, 1024, 512]), seed + 14)
    target = torch.randn(REST_B, 512, generator=gen)
    mask = utils.freeze_mask(model, lambda name: name.startswith("linear."))

    def run(device):
        m = copy.deepcopy(model).to(device)
        ema = copy.deepcopy(m)
        opt = utils.freeze(lambda ps: torch.optim.Adam(ps, lr=REST_LR), m, mask)
        torch.square(m(vec.to(device)) - target.to(device)).mean().backward()
        opt.step()
        utils.accumulate(ema, m, 0.99)
        for (k, p), p0 in zip(m.named_parameters(), model.parameters()):
            if mask[k] != (p not in opt.state) or (mask[k] and not torch.equal(p.cpu(), p0)):
                fail(f"freeze on {device}: {k} frozen {mask[k]} but moved or holds state")
        return [p.detach().cpu() for p in (*m.parameters(), *ema.parameters())]

    card, cpu = run("cuda"), run("cpu")
    worst = max(((a - r).abs().max().item(), k) for a, r, k in zip(
        card, cpu, [f"{w}{k}" for w in ("", "ema ") for k, _ in model.named_parameters()]))
    print(f"    freeze (linear.*) + Adam (lr {REST_LR}) one step, then accumulate (0.99): "
          f"parameters and EMA, worst |err| {worst[0]:.3e} ({worst[1]}; limit 2 lr, Adam's "
          f"first step is lr g / (|g| + eps))")
    if not worst[0] <= 2 * REST_LR:
        fail(f"freeze/accumulate: {worst[1]} off by {worst[0]}")


def run_inventory(seed: int, counters) -> dict:
    """Phase 14; returns the launches of the legacy stack's bf16 run."""
    t0 = time.perf_counter()
    launches = run_legacy_bf16(seed, counters)
    check_legacy_f32(seed)
    check_sg_kit(seed, counters)
    check_rest(seed)
    print(f"  phase 14: {time.perf_counter() - t0:.1f} s")
    return launches


# ---- phase 15: a short training run on the hard glyph set

HARD_DIR = os.path.join(BUILD_DIR, "chip_smoke_hard")
HARD_SEED, HARD_STEPS = 2, 400  # the head-to-head's first seed and first checkpoint
HARD_REPLAY_AUC = 0.9  # at step 400 all 11 recorded seeds of both implementations read >= 0.979
HARD_SET_TIMEOUT = 900  # seconds to wait for the set's build (about 70 on one core)


def study_script():
    """``scripts/torch_hard_head_to_head.py`` as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        "torch_hard_head_to_head.py")
    spec = importlib.util.spec_from_file_location("torch_hard_head_to_head", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def start_hard_set() -> subprocess.Popen:
    """Start building phase 15's set (the generator at its defaults, the study's
    command) in the background; the process is stopped at exit if still running."""
    import atexit

    shutil.rmtree(HARD_DIR, ignore_errors=True)
    os.makedirs(HARD_DIR)
    with open(os.path.join(HARD_DIR, "make_set.log"), "w") as log:
        proc = subprocess.Popen(study_script().set_command(os.path.join(HARD_DIR, "ds")),
                                cwd=os.path.dirname(os.path.abspath(__file__)), stdout=log,
                                stderr=subprocess.STDOUT)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    atexit.register(stop)
    return proc


def run_hard_study(counters, set_proc: subprocess.Popen) -> dict:
    """Phase 15: HARD_STEPS steps of seed HARD_SEED at the study config on the hard
    glyph set through ``train_multiseed_gim_imgs``, then the eval grid on its val
    split; fails on a non-finite metric, a launch count off the STUDY_* tables or a
    replay AUC under HARD_REPLAY_AUC.  Returns the training run's launches."""
    from optimalstrategiesagainstgenerativeattacks_torch import train_multiseed_gim_on_imgs as tcli
    from optimalstrategiesagainstgenerativeattacks_torch.eval import authentication as auth
    from optimalstrategiesagainstgenerativeattacks_torch.train import multiseed as tms

    t_phase = time.perf_counter()
    ds_root, outdir = os.path.join(HARD_DIR, "ds"), os.path.join(HARD_DIR, "runs")
    if set_proc.wait(timeout=HARD_SET_TIMEOUT) != 0:
        fail(f"the hard set's build exited {set_proc.returncode} "
             f"({os.path.join(HARD_DIR, 'make_set.log')})")
    h2h = study_script()
    digest, n_images = h2h.set_digest(ds_root)
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), h2h.DOCS_DIR,
                           "port_hard_set.json")) as f:
        study = json.load(f)["sha256_paths_and_pixels"]
    print(f"  set: {n_images} images, sha256 of paths and pixels {digest} "
          f"({'the' if digest == study else 'NOT the'} study's set); ready "
          f"{time.perf_counter() - t_phase:.1f} s into the phase", flush=True)

    args, cfg = study_config([HARD_SEED], outdir, ds_root)
    ds = tcli.make_train_dataset(cfg)
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    _, readings = tms.train_multiseed_gim_imgs(cfg, [HARD_SEED], ds, outdir, HARD_STEPS,
                                               save_every=HARD_STEPS, log_every=50,
                                               args=vars(args), device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {c.name: c.count for c in counters}
    copies = launches.pop("adain_nhwc_copy")
    want = {"adain_fwd": sum(STUDY_ADAIN_SITES.values()) * HARD_STEPS,
            "adain_bwd": sum(STUDY_ADAIN_SITES.values()) * HARD_STEPS,
            "attention_core_fwd": sum(STUDY_ATTENTION_SITES.values()) * HARD_STEPS}
    print(f"  {HARD_STEPS} steps of seed {HARD_SEED} ({len(ds.data)} classes): {train_s:.1f} s, "
          f"{HARD_STEPS / train_s:.3f} steps/s with the state's build and the first compiles; "
          f"launches {launches}, expected {want}; layout copies {copies}  [{smi_line()}]")
    if launches != want or copies:
        fail(f"hard study: launches {launches}, expected {want}; {copies} layout copies")
    if not all(np.isfinite(a).all() for _, a in readings):
        fail("hard study: non-finite au_acc")

    val = auth.get_dataset(ds_root, "val", "omniglot", example_cnt_per_class=5,
                           img_channels=cfg.img_channels, img_size=cfg.img_size,
                           m=cfg.m, n=cfg.n, k=cfg.k)
    _, rows = run_grid("hard", val, os.path.join(outdir, f"seed_{HARD_SEED}"), None, None,
                       (STUDY_EVAL_ADAIN_SITES, STUDY_EVAL_ATTENTION_SITES), counters, HARD_DIR)
    auth._RESTORE_CACHE.clear()
    by_im = {r["im_type"]: r for r in rows}
    print(f"  step {HARD_STEPS}, val split ({len(val)} episodes): " + "; ".join(
        f"{im} AUC {by_im[im]['auc']:.4f} acc {by_im[im]['acc']:.4f}" for im in IM_TYPES)
        + f" (replay gate: AUC >= {HARD_REPLAY_AUC})  [{smi_line()}]")
    if not all(math.isfinite(r[k]) for r in rows for k in ("acc", "acc_on_fake", "acc_on_real")):
        fail("hard study: a non-finite accuracy")
    if not by_im["replay"]["auc"] >= HARD_REPLAY_AUC:
        fail(f"hard study: replay AUC {by_im['replay']['auc']} under {HARD_REPLAY_AUC}")
    shutil.rmtree(HARD_DIR, ignore_errors=True)
    print(f"  phase 15: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---- phases 16 and 17: data parallel, the model axis

def data_parallel_script():
    """``scripts/torch_data_parallel.py`` as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        "torch_data_parallel.py")
    spec = importlib.util.spec_from_file_location("torch_data_parallel", path)
    dp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(dp)
    return dp


def run_data_parallel(seed: int) -> dict:
    """Phase 16 (``scripts/torch_data_parallel.py check``); returns rank 0's launches
    over its bf16 steps."""
    dp = data_parallel_script()
    try:
        summary = dp.check(seed)
    except SystemExit as e:
        fail(f"data parallel: {e}")
    dp.print_check(summary)
    if not summary["ok"]:
        fail("data parallel: " + "; ".join(summary["problems"]))
    return summary["launches"][0]


def run_model_axis(seed: int) -> dict:
    """Phase 17 (``scripts/torch_data_parallel.py check --model_parallel 2``); returns
    rank 0's launches over its VoxCeleb steps."""
    dp = data_parallel_script()
    try:
        summary = dp.tp_check(seed, 2)
    except SystemExit as e:
        fail(f"model axis: {e}")
    dp.print_tp_check(summary)
    if not summary["ok"]:
        fail("model axis: " + "; ".join(summary["problems"]))
    return {k: v for k, v in summary["launches"][0].items() if k != "adain_nhwc_copy"}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args()
    if args.steps < 2:
        fail("--steps must be at least 2 (the first step is warm-up)")

    print(f"[1/{N_PHASES}] card", flush=True)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    print(f"  {smi_line()}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    print(f"[2/{N_PHASES}] build", flush=True)
    from optimalstrategiesagainstgenerativeattacks_torch.kernels import adain as k1
    from optimalstrategiesagainstgenerativeattacks_torch.kernels import attention as k2
    from optimalstrategiesagainstgenerativeattacks_torch.kernels import build

    t0 = time.perf_counter()
    so = build.build_cuda_library("attention")
    build.load_cuda_library("attention")
    print(f"  attention.cu -> {so.name}: {time.perf_counter() - t0:.2f} s")
    report_cuda_build(so)
    t0 = time.perf_counter()
    x = torch.randn(2, 4, 4, 4, device="cuda").contiguous(memory_format=torch.channels_last)
    s = torch.randn(2, 4, device="cuda")
    k1.ada_in_fwd_cuda(x, s, s)
    k1.ada_in_bwd_cuda(x, s, x)
    torch.cuda.synchronize()
    print(f"  triton adain kernels (first f32 compile): {time.perf_counter() - t0:.2f} s",
          flush=True)

    results = kernel_results()
    hard_set = start_hard_set()  # phase 15's set, built while phases 3-14 run

    print(f"[3/{N_PHASES}] kernels vs plain versions at the flagship, VoxCeleb and study "
          f"sites, train and eval (f32 atol/rtol {TOL[torch.float32]}, bf16 "
          f"{TOL[torch.bfloat16]}; pass: max|err| <= atol + rtol*max|ref|)", flush=True)
    check_study_sites(args.seed)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    timer = DeviceTimer()
    times = {**check_adain(gen, results, timer), **check_attention(gen, results, timer)}
    del timer
    torch.cuda.synchronize()
    summarise(results, times)

    print(f"[4/{N_PHASES}] slice parity: flagship widths, f32, TF32 off, B=2, fixed z "
          f"(tol {SLICE_TOL} x max(1, max|ref|)); then every SN conv site of a bf16 step of "
          f"{', '.join(conv_site_configs(args.seed))} against f32 without cuDNN (tol "
          f"{CONV_TOL} x max|ref|); then the bf16 rounding sites, card bf16 against CPU f32 "
          f"(mean error <= {SITES_RATIO} x the CPU bf16 chain's); then the bf16 pool at every "
          f"pool site of those steps, card against CPU bit for bit", flush=True)
    check_slice(args.seed)
    pool_sites = check_conv_sites(args.seed)
    check_bf16_sites(args.seed)
    check_pool_sites(pool_sites, seed=args.seed)

    print(f"[5/{N_PHASES}] R1 parity: VoxCeleb widths (64x64x3, style 512), f32, TF32 off, B=2, "
          f"against the CPU in f64 at the card's branches (penalty tol {R1_TOL} x max|ref|; each "
          f"gradient {R1_TOL} x its max|ref| + {R1_TOL * 1e-3:g} x the player's)", flush=True)
    check_r1(args.seed)

    counters = (k1.FWD_LAUNCHES, k1.BWD_LAUNCHES, k2.FWD_LAUNCHES, k1.NHWC_COPIES)
    print(f"[6/{N_PHASES}] train: {args.steps} flagship steps", flush=True)
    launches, flagship_step_s = run_train(args.seed, args.steps, counters)
    check_train_launches("train", launches, args.steps)
    check_noise_draw(args.seed)
    for name, n in launches.items():
        results[name]["launches"] = n

    print(f"[7/{N_PHASES}] vox: the VoxCeleb config through train_gim_imgs, then sample, "
          f"eval_step, {VOX_STEPS} steady steps and a resume", flush=True)
    vox_launches, vox_dir, vox_cfg = run_vox(args.seed, counters)
    for name, n in vox_launches.items():
        results[name]["vox_launches"] = n

    from optimalstrategiesagainstgenerativeattacks_torch.utils.config import ImageGameConfig

    print(f"[8/{N_PHASES}] eval grid, flagship: a 2-step checkpoint, a Siamese baseline, then "
          f"eval_authentication_task over {EVAL_EPISODES} episodes in batches of {EVAL_BATCH}",
          flush=True)
    for name, n in run_eval_flagship(ImageGameConfig(seed=args.seed), counters).items():
        results[name]["eval_launches"] = n

    print(f"[9/{N_PHASES}] eval grid, VoxCeleb: ArcFace (ir_se 50) trained at 64x64x3, then "
          f"eval_authentication_task against phase 7's checkpoint over {VOX_EVAL_EPISODES} "
          f"episodes", flush=True)
    for name, n in run_eval_vox(args.seed, counters, vox_dir, vox_cfg).items():
        results[name]["vox_eval_launches"] = n

    print(f"[10/{N_PHASES}] gaussian: one f32 step card vs CPU (TF32 off, reg 0 and 5; metrics "
          f"{GAUSS_TOL} x max(1, |ref|), accuracies 2/B; parameters {GAUSS_TOL} x max|ref|, "
          f"2 lr where the gradient is rounding noise), then train_gim_gaussian for "
          f"{GAUSS_STEPS} steps, a resume and timed chunks", flush=True)
    check_gaussian_step(args.seed)
    launches = run_gaussian(args.seed, counters)
    copies = launches.pop("adain_nhwc_copy")
    print(f"  launches {launches} (expected none), layout copies {copies}")
    if any(launches.values()) or copies:
        fail(f"gaussian: kernels launched {launches}")
    for name, n in launches.items():
        results[name]["gaussian_launches"] = n

    print(f"[11/{N_PHASES}] use_img_att: the flagship impersonator with img_att, f32 card vs CPU "
          f"(tol {SLICE_TOL} x max(1, max|ref|)), then {args.steps} bf16 flagship steps",
          flush=True)
    check_slice(args.seed, use_img_att=True)
    launches, img_att_step_s = run_train(args.seed, args.steps, counters, use_img_att=True)
    check_train_launches("train with img_att", launches, args.steps)
    for name, n in launches.items():
        results[name]["img_att_launches"] = n
    print(f"  steady steps/s: with img_att {1.0 / img_att_step_s:.3f}, without (phase 6, this "
          f"call) {1.0 / flagship_step_s:.3f}; img_att adds "
          f"{(img_att_step_s - flagship_step_s) * 1e3:.2f} ms/step  [{smi_line()}]")

    print(f"[12/{N_PHASES}] feed: the device loader, the host loader with prefetch depth 2 and "
          f"with depth 0 feeding train steps at the flagship and VoxCeleb sizes "
          f"(runs {' '.join(FEED_ORDER)})", flush=True)
    feed_sets = {name: run_feed(name, args.seed, counters) for name in FEED_SETS}

    print(f"[13/{N_PHASES}] multiseed: train_multiseed_gim_imgs at the flagship, {MULTISEED_SEEDS} "
          f"seeds; f32 multi-seed steps against single-seed runs (metrics {MULTISEED_TOL} x "
          f"max(1, |ref|), accuracies 2/B; parameters {MULTISEED_TOL} x max|ref|, 2 lr a step "
          f"where the gradient is rounding noise); the CLI's config with {SMALL_SEEDS} seeds",
          flush=True)
    for name, n in run_multiseed(args.seed, counters, feed_sets["flagship"],
                                 flagship_step_s).items():
        results[name]["multiseed_launches"] = n
    check_multiseed_f32(args.seed, feed_sets["flagship"])
    run_multiseed_small(args.seed, counters)

    print(f"[14/{N_PHASES}] inventory: the legacy AdaIN stack (flagship widths, B'={LEGACY_B}, "
          f"bf16: {LEGACY_STEPS + 1} steps; f32 card vs CPU f64 and grad2_penalty through it, "
          f"phase 5's rule), the StyleGAN kit (bf16 B={SG_B}; f32 card vs CPU f64; blur3x3 bf16 "
          f"against f32, tol {CONV_TOL} x max|ref|), the stats, ResMLPs, pixel_norm, pools, "
          f"freeze and accumulate at width 512", flush=True)
    for name, n in run_inventory(args.seed, counters).items():
        results[name]["inventory_launches"] = n

    print(f"[15/{N_PHASES}] hard study: {HARD_STEPS} steps of seed {HARD_SEED} at the study "
          f"config on the hard glyph set (scripts/make_hard_glyph_ds.py at its defaults), "
          f"then the eval grid on its val split", flush=True)
    for name, n in run_hard_study(counters, hard_set).items():
        results[name]["study_launches"] = n

    print(f"[16/{N_PHASES}] data parallel: the flagship step on every visible card, or two "
          f"ranks on one card over gloo; ranks against one process (the JAX suite's mesh "
          f"tolerances) and against each other (bit for bit)", flush=True)
    for name, n in run_data_parallel(args.seed).items():
        results[name]["dp_launches"] = n

    print(f"[17/{N_PHASES}] model axis: the head's six matrices sharded over two ranks (one "
          f"card: gloo, data 1 x model 2; four cards: NCCL, data 2 x model 2); flagship f32 "
          f"against one process (the JAX suite's mesh tolerances), VoxCeleb bf16 R1 steps, "
          f"ranks bit-equal", flush=True)
    for name, n in run_model_axis(args.seed).items():
        results[name]["tp_launches"] = n

    print(smi_line())
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
