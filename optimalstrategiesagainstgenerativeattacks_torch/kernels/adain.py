"""K1: fused AdaIN, forward and backward, as Triton kernels for Hopper.

Replaces the Pallas TPU kernel
``optimalstrategiesagainstgenerativeattacks_tpu/ops/pallas/adain_pallas.py``
at commit 79a0a33: ``_fwd_kernel`` (launched by ``_run_fwd``) and
``_bwd_kernel`` (launched by ``_run_bwd``) under ``ada_in_pallas``.

What it computes, per (sample b, channel c) of an NHWC feature map x:
    mu = mean_hw x,   sigma = sqrt(sum_hw (x - mu)^2 / max(HW - 1, 1))  (unbiased)
    y  = std_s * (x - mu) / (sigma + eps) + mean_s
with f32 statistics whatever the activation dtype.  The backward returns,
in one kernel, dx, dmean_s = sum_hw g and dstd_s = sum_hw g (x - mu)/(sigma + eps).

What bounds it on the card: memory traffic.  Each element costs a handful of
flops against 2 (bf16) or 4 (f32) bytes read and written, far below the
H100's ~295 flops/byte ridge; ``ada_in_fwd_bytes`` and ``ada_in_bwd_bytes``
count the bytes each kernel must move (each input read once, each output
written once).  At the flagship sites the backward moves 34.7 MB at
[640, 4, 4, 512] (10.4 us at 3.35 TB/s) down to 3.9 MB at [640, 32, 32, 1].

One tile planner (``tile_config``) serves both kernels, with three modes:
resident, flat (C < 8) and loop (maps past RESIDENT_MAX elements a tile).
Each direction differs only in how many elements a thread holds
(``PER_THREAD``).

Forward: one pass over a resident tile.  One program owns one (sample,
channel block) tile of H*W rows of a channels-last tensor (contiguous along
C, so each thread loads 16-byte vectors), loads x once, takes mu and then
the centred sum (x - mu)^2 from its registers, loads the two style rows and
writes y: it moves the bound's bytes and no more, where the loop it
replaces read x three times.  Holding x alone, each thread takes 128
elements on the backward's 1, 2, 4 warps at the flagship sites (16 rows x
256 channels on one warp at 4x4x512).  A tile row narrower than 64
channels (128 bytes of bf16) reads part of a cache line and costs time:
on an H100 at [640, 16, 16, 128] the 256 x 64 tile takes 35 us, 256 x 32
41 us and 256 x 8 164 us (scripts/torch_adain_tiles.py).  Below 8
channels it takes the backward's flat tile along H*W*C (one warp per 1024
elements, the fastest there), and maps past the resident limit loop over
H*W three times, re-reading x from L2.

Backward: one pass over a resident tile.  Where a (sample, channel block)
tile of H*W rows fits in registers (H*W <= 1024 at every flagship site),
each program loads its tile of x and g once, takes mu, the two-pass centred
sums sum (x - mu)^2 and sum g (x - mu) and sum g from the registers, and
writes dx, dmean_s and dstd_s: it moves the bound's bytes and no more.  Each
thread holds 64 elements of x and of g, and programs are small (1 to 4
warps at the flagship sites, e.g. 16 rows x 128 channels on one warp at
4x4x512, 12 KB moved): the reductions then stay inside a thread and a
warp, and many programs per SM keep enough loads in flight.  Below 8
channels the tile runs along the flattened H*W*C axis instead (contiguous,
vectorised), with each channel's sums taken under a mask: on an H100 at
[640, 32, 32, 1] it takes 3.9 us where the resident 1024 x 1 tile on 8
warps takes 4.5 us (chip_smoke.py phase 3, both in one run).  Larger maps
(the VoxCeleb config's 64x64) keep a variant that loops over H*W and
re-reads x and g from L2.

The TPU kernel held a whole sample's [H, W, C] tile in VMEM and reduced it
in one grid step; on Hopper registers hold a few thousand elements per
program, so the tile is cut along C.

Zero variance: when sigma == 0 the centred values are all 0 and the
sigma-term of dx (c_i/sigma * sum g c) tends to 0; the kernel and its plain
version drop it there, so dx stays finite.  The Pallas backward divided by
sigma and autodiff through sqrt(0) both give non-finite dx at that point.
Differentiated again, sigma is held constant where it is 0: the same limit.

Double backward (an R1 penalty through AdaIN): the backward is itself a
function, ``AdaINBackward``, whose forward launches the backward kernel and
whose backward differentiates the closed form ``ada_in_bwd_ref`` with torch
ops, as the attention core's backward is differentiated again
(``kernels/attention.py:attention_core_bwd``).  The kernel's outputs alone
carry no graph, so a double backward through them would lose every term
that passes through AdaIN.

Plain PyTorch versions of the same functions (``ada_in_ref`` and the
closed-form ``ada_in_bwd_ref``) sit below; the wrappers run them for tensors
on the CPU, and the closed form's derivative on either device.
"""

from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from optimalstrategiesagainstgenerativeattacks_torch.kernels.build import (
    LaunchCounter,
    import_triton,
)

FWD_LAUNCHES = LaunchCounter("adain_fwd")
BWD_LAUNCHES = LaunchCounter("adain_bwd")
NHWC_COPIES = LaunchCounter("adain_nhwc_copy")  # layout copies in front of the kernels

_SUPPORTED = (torch.float32, torch.bfloat16)
_TRITON = {}

# elements of each input (x; x and g) a thread holds in the (resident, flat)
# tile, by direction, from sweeps on an H100 at the flagship sites: the
# backward's fastest of 1-16 warps and 8-512 channels; the forward within
# 4 % of its fastest of 32, 64, 128 a thread on 1-8 warps
# (scripts/torch_adain_tiles.py).  A map whose tile would pass RESIDENT_MAX
# elements loops over H*W instead.
PER_THREAD = {"fwd": (128, 32), "bwd": (64, 32)}
RESIDENT_MAX = 16384
_RESIDENT, _FLAT, _LOOP = 0, 1, 2
MODE_NAMES = ("resident", "flat", "loop")


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _triton_kernels():
    """JIT-define the two Triton kernels (once per process)."""
    if _TRITON:
        return _TRITON
    triton, tl = import_triton()

    @triton.jit
    def adain_fwd_kernel(x_ptr, ms_ptr, ss_ptr, out_ptr, B, HW, inv_n, inv_nm1, eps,
                         C: tl.constexpr, MODE: tl.constexpr, BLOCK_B: tl.constexpr,
                         BLOCK_HW: tl.constexpr, BLOCK_C: tl.constexpr):
        if MODE == 0:
            # resident tile: [BLOCK_HW >= HW rows, BLOCK_C channels] of one sample
            b = tl.program_id(0).to(tl.int64)
            cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
            cmask = cols < C
            rows = tl.arange(0, BLOCK_HW)
            mask = (rows[:, None] < HW) & cmask[None, :]
            offs = b * HW * C + rows[:, None] * C + cols[None, :]
            x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            mean = tl.sum(x, axis=0) * inv_n
            d = tl.where(mask, x - mean[None, :], 0.0)
            sigma = tl.sqrt(tl.sum(d * d, axis=0) * inv_nm1)
            ms = tl.load(ms_ptr + b * C + cols, mask=cmask, other=0.0).to(tl.float32)
            ss = tl.load(ss_ptr + b * C + cols, mask=cmask, other=0.0).to(tl.float32)
            y = d * (ss / (sigma + eps))[None, :] + ms[None, :]
            tl.store(out_ptr + offs, y.to(out_ptr.dtype.element_ty), mask=mask)
        elif MODE == 1:
            # flat resident tile for C < 8: BLOCK_B samples x BLOCK_HW >= HW*C
            # elements along the contiguous H*W*C axis; channel c = element % C
            bs = tl.program_id(0) * BLOCK_B + tl.arange(0, BLOCK_B)
            bmask = bs < B
            e = tl.arange(0, BLOCK_HW)
            mask = bmask[:, None] & (e[None, :] < HW * C)
            offs = bs[:, None].to(tl.int64) * (HW * C) + e[None, :]
            x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            y = tl.zeros([BLOCK_B, BLOCK_HW], dtype=tl.float32)
            for c in tl.static_range(C):
                sel = mask & ((e % C) == c)[None, :]
                mean = tl.sum(tl.where(sel, x, 0.0), axis=1) * inv_n
                d = tl.where(sel, x - mean[:, None], 0.0)
                sigma = tl.sqrt(tl.sum(d * d, axis=1) * inv_nm1)
                ms = tl.load(ms_ptr + bs * C + c, mask=bmask, other=0.0).to(tl.float32)
                ss = tl.load(ss_ptr + bs * C + c, mask=bmask, other=0.0).to(tl.float32)
                y += tl.where(sel, d * (ss / (sigma + eps))[:, None] + ms[:, None], 0.0)
            tl.store(out_ptr + offs, y.to(out_ptr.dtype.element_ty), mask=mask)
        else:
            # maps too large for registers: loop over H*W three times (mean,
            # centred sum of squares, output), re-reading x from L2
            b = tl.program_id(0).to(tl.int64)
            cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
            cmask = cols < C
            base = b * HW * C
            rows0 = tl.arange(0, BLOCK_HW)
            acc = tl.zeros([BLOCK_C], dtype=tl.float32)
            for start in range(0, HW, BLOCK_HW):
                rows = start + rows0
                mask = (rows[:, None] < HW) & cmask[None, :]
                offs = base + rows[:, None] * C + cols[None, :]
                x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
                acc += tl.sum(x, axis=0)
            mean = acc * inv_n
            acc2 = tl.zeros([BLOCK_C], dtype=tl.float32)
            for start in range(0, HW, BLOCK_HW):
                rows = start + rows0
                mask = (rows[:, None] < HW) & cmask[None, :]
                offs = base + rows[:, None] * C + cols[None, :]
                x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
                d = tl.where(mask, x - mean[None, :], 0.0)
                acc2 += tl.sum(d * d, axis=0)
            sigma = tl.sqrt(acc2 * inv_nm1)
            ms = tl.load(ms_ptr + b * C + cols, mask=cmask, other=0.0).to(tl.float32)
            ss = tl.load(ss_ptr + b * C + cols, mask=cmask, other=0.0).to(tl.float32)
            scale = ss / (sigma + eps)
            for start in range(0, HW, BLOCK_HW):
                rows = start + rows0
                mask = (rows[:, None] < HW) & cmask[None, :]
                offs = base + rows[:, None] * C + cols[None, :]
                x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
                y = (x - mean[None, :]) * scale[None, :] + ms[None, :]
                tl.store(out_ptr + offs, y.to(out_ptr.dtype.element_ty), mask=mask)

    @triton.jit
    def _bwd_coefs(sg, sdd, sgd, ss, inv_n, inv_nm1, eps):
        """(a, coef, mean g, dstd): dx = a (g - mean g) - coef (x - mu)."""
        sigma = tl.sqrt(sdd * inv_nm1)
        f = sigma + eps
        # sigma-term of dx, dropped where sigma == 0 (its limit)
        safe_sigma = tl.where(sigma > 0.0, sigma, 1.0)
        coef = tl.where(sigma > 0.0, ss / (f * f) * sgd * inv_nm1 / safe_sigma, 0.0)
        return ss / f, coef, sg * inv_n, sgd / f

    @triton.jit
    def adain_bwd_kernel(x_ptr, ss_ptr, g_ptr, dx_ptr, dm_ptr, ds_ptr, B, HW, inv_n, inv_nm1,
                         eps, C: tl.constexpr, MODE: tl.constexpr, BLOCK_B: tl.constexpr,
                         BLOCK_HW: tl.constexpr, BLOCK_C: tl.constexpr):
        if MODE == 0:
            # resident tile: [BLOCK_HW >= HW rows, BLOCK_C channels] of one sample
            b = tl.program_id(0).to(tl.int64)
            cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
            cmask = cols < C
            rows = tl.arange(0, BLOCK_HW)
            mask = (rows[:, None] < HW) & cmask[None, :]
            offs = b * HW * C + rows[:, None] * C + cols[None, :]
            x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            mean = tl.sum(x, axis=0) * inv_n
            d = tl.where(mask, x - mean[None, :], 0.0)
            sg = tl.sum(g, axis=0)
            sgd = tl.sum(g * d, axis=0)
            ss = tl.load(ss_ptr + b * C + cols, mask=cmask, other=0.0).to(tl.float32)
            a, coef, g_mean, dstd = _bwd_coefs(sg, tl.sum(d * d, axis=0), sgd, ss, inv_n,
                                               inv_nm1, eps)
            dx = a[None, :] * (g - g_mean[None, :]) - coef[None, :] * d
            tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=mask)
            tl.store(dm_ptr + b * C + cols, sg, mask=cmask)
            tl.store(ds_ptr + b * C + cols, dstd, mask=cmask)
        elif MODE == 1:
            # flat resident tile for C < 8: BLOCK_B samples x BLOCK_HW >= HW*C
            # elements along the contiguous H*W*C axis; channel c = element % C
            bs = tl.program_id(0) * BLOCK_B + tl.arange(0, BLOCK_B)
            bmask = bs < B
            e = tl.arange(0, BLOCK_HW)
            mask = bmask[:, None] & (e[None, :] < HW * C)
            offs = bs[:, None].to(tl.int64) * (HW * C) + e[None, :]
            x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            dx = tl.zeros([BLOCK_B, BLOCK_HW], dtype=tl.float32)
            for c in tl.static_range(C):
                sel = mask & ((e % C) == c)[None, :]
                mean = tl.sum(tl.where(sel, x, 0.0), axis=1) * inv_n
                d = tl.where(sel, x - mean[:, None], 0.0)
                gc = tl.where(sel, g, 0.0)
                sg = tl.sum(gc, axis=1)
                sgd = tl.sum(gc * d, axis=1)
                ss = tl.load(ss_ptr + bs * C + c, mask=bmask, other=0.0).to(tl.float32)
                a, coef, g_mean, dstd = _bwd_coefs(sg, tl.sum(d * d, axis=1), sgd, ss, inv_n,
                                                   inv_nm1, eps)
                dx += tl.where(sel, a[:, None] * (g - g_mean[:, None]) - coef[:, None] * d, 0.0)
                tl.store(dm_ptr + bs * C + c, sg, mask=bmask)
                tl.store(ds_ptr + bs * C + c, dstd, mask=bmask)
            tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=mask)
        else:
            # maps too large for registers: loop over H*W, re-reading x and g
            b = tl.program_id(0).to(tl.int64)
            cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
            cmask = cols < C
            base = b * HW * C
            rows0 = tl.arange(0, BLOCK_HW)
            sx = tl.zeros([BLOCK_C], dtype=tl.float32)
            sg = tl.zeros([BLOCK_C], dtype=tl.float32)
            for start in range(0, HW, BLOCK_HW):
                rows = start + rows0
                mask = (rows[:, None] < HW) & cmask[None, :]
                offs = base + rows[:, None] * C + cols[None, :]
                sx += tl.sum(tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32), axis=0)
                sg += tl.sum(tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32), axis=0)
            mean = sx * inv_n
            sdd = tl.zeros([BLOCK_C], dtype=tl.float32)
            sgd = tl.zeros([BLOCK_C], dtype=tl.float32)
            for start in range(0, HW, BLOCK_HW):
                rows = start + rows0
                mask = (rows[:, None] < HW) & cmask[None, :]
                offs = base + rows[:, None] * C + cols[None, :]
                x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
                g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
                d = tl.where(mask, x - mean[None, :], 0.0)
                sdd += tl.sum(d * d, axis=0)
                sgd += tl.sum(g * d, axis=0)
            ss = tl.load(ss_ptr + b * C + cols, mask=cmask, other=0.0).to(tl.float32)
            a, coef, g_mean, dstd = _bwd_coefs(sg, sdd, sgd, ss, inv_n, inv_nm1, eps)
            for start in range(0, HW, BLOCK_HW):
                rows = start + rows0
                mask = (rows[:, None] < HW) & cmask[None, :]
                offs = base + rows[:, None] * C + cols[None, :]
                x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
                g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
                dx = a[None, :] * (g - g_mean[None, :]) - coef[None, :] * (x - mean[None, :])
                tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=mask)
            tl.store(dm_ptr + b * C + cols, sg, mask=cmask)
            tl.store(ds_ptr + b * C + cols, dstd, mask=cmask)

    _TRITON["fwd"] = adain_fwd_kernel
    _TRITON["bwd"] = adain_bwd_kernel
    return _TRITON


def _blocks(hw: int, c: int):
    """Looping tiles: up to 64 channels (128 B of bf16) by enough rows for ~4k elements."""
    block_c = max(2, min(64, _next_pow2(c)))
    block_hw = max(16, min(4096 // block_c, _next_pow2(hw)))
    return block_hw, block_c


def tile_config(b: int, hw: int, c: int, per_thread: tuple, warps: int | None = None) -> dict:
    """Mode, grid, tile and warps of an AdaIN kernel over a [b, hw, c] map.

    ``per_thread`` is (resident, flat): the elements of each input a thread
    holds.  Resident (C >= 8): one (sample, channel block) tile of
    BLOCK_HW >= H*W rows, by default on 1, 2, 4, 8 warps at H*W = 16, 64,
    256, 1024, with as many channels as fill each thread, e.g. 16 rows x
    128 channels on one warp at 4x4x512 for 64 a thread.  Flat (C < 8):
    BLOCK_B samples x BLOCK_HW >= H*W*C elements, on as many warps as the
    sample needs and at least one.  Loop: maps past RESIDENT_MAX elements.
    ``warps`` replaces the default warps (the tile sweep sets it).
    """
    if c < 8 and hw * c <= RESIDENT_MAX:
        block_e = _next_pow2(hw * c)
        warps = warps or max(1, min(8, block_e // (32 * per_thread[1])))
        block_b = max(1, per_thread[1] * 32 * warps // block_e)
        return dict(MODE=_FLAT, grid=(-(-b // block_b),), BLOCK_B=block_b, BLOCK_HW=block_e,
                    BLOCK_C=1, num_warps=warps)
    block_hw = _next_pow2(hw)
    if block_hw * 8 <= RESIDENT_MAX:
        warps = warps or min(8, max(1, math.isqrt(block_hw) // 4))
        block_c = min(_next_pow2(c), max(8, per_thread[0] * 32 * warps // block_hw))
        return dict(MODE=_RESIDENT, grid=(b, -(-c // block_c)), BLOCK_B=1, BLOCK_HW=block_hw,
                    BLOCK_C=block_c, num_warps=warps)
    block_hw, block_c = _blocks(hw, c)
    return dict(MODE=_LOOP, grid=(b, -(-c // block_c)), BLOCK_B=1, BLOCK_HW=block_hw,
                BLOCK_C=block_c, num_warps=warps or 4)


def ada_in_fwd_bytes(b: int, h: int, w: int, c: int, dtype: torch.dtype) -> int:
    """Bytes the forward must move: x and both styles read, y written, in ``dtype``."""
    return (2 * b * h * w * c + 2 * b * c) * dtype.itemsize


def ada_in_bwd_bytes(b: int, h: int, w: int, c: int, dtype: torch.dtype) -> int:
    """Bytes the backward must move: x, g and std_s read and dx written in ``dtype``,
    dmean_s and dstd_s written in f32."""
    return (3 * b * h * w * c + b * c) * dtype.itemsize + 2 * b * c * 4


def ada_in_fwd_flops(b: int, h: int, w: int, c: int) -> int:
    """f32 operations of the forward: 5 per element (sum, centre, square-add, scale-shift)."""
    return 5 * b * h * w * c


def ada_in_bwd_flops(b: int, h: int, w: int, c: int) -> int:
    """f32 operations of the backward: 11 per element (four sums, centre, dx)."""
    return 11 * b * h * w * c


def _check_cuda(name, *tensors):
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: all tensors must be on the same CUDA device")
        if t.dtype not in _SUPPORTED:
            raise TypeError(f"{name}: dtype {t.dtype} not supported (float32, bfloat16)")


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW tensor -> contiguous [B, H, W, C] (a view for channels_last input;
    any other layout is copied, and ``NHWC_COPIES`` counts the copy)."""
    xh = x.permute(0, 2, 3, 1)
    if not xh.is_contiguous():
        NHWC_COPIES.add()
        xh = xh.contiguous()
    return xh


def _stats_args(x: torch.Tensor):
    hw = x.shape[2] * x.shape[3]
    return hw, 1.0 / hw, 1.0 / max(hw - 1, 1)


def ada_in_fwd_cuda(x, mean_s, std_s, eps: float = 1e-5, tile: dict | None = None):
    """Launch the forward kernel.  x: NCHW (ideally channels_last); styles [B, C].

    ``tile``: a plan from ``tile_config`` to launch in place of the planner's
    own (the tile sweep passes its candidates).
    """
    _check_cuda("ada_in", x, mean_s, std_s)
    b, c = x.shape[0], x.shape[1]
    if mean_s.shape != (b, c) or std_s.shape != (b, c):
        raise ValueError(f"ada_in: style shapes {mean_s.shape}, {std_s.shape} != {(b, c)}")
    k = _triton_kernels()
    hw, inv_n, inv_nm1 = _stats_args(x)
    xh = _nhwc(x)
    out = torch.empty_like(xh)
    cfg = dict(tile or tile_config(b, hw, c, PER_THREAD["fwd"]))
    k["fwd"][cfg.pop("grid")](xh, mean_s.contiguous(), std_s.contiguous(), out, b, hw, inv_n,
                              inv_nm1, eps, C=c, **cfg)
    FWD_LAUNCHES.add()
    return out.permute(0, 3, 1, 2)


def ada_in_bwd_cuda(x, std_s, g, eps: float = 1e-5):
    """Launch the backward kernel; returns (dx [x's dtype], dmean_s f32, dstd_s f32)."""
    _check_cuda("ada_in backward", x, std_s, g)
    b, c = x.shape[0], x.shape[1]
    if g.shape != x.shape or std_s.shape != (b, c):
        raise ValueError(f"ada_in backward: shapes x {x.shape}, g {g.shape}, std_s {std_s.shape}")
    k = _triton_kernels()
    hw, inv_n, inv_nm1 = _stats_args(x)
    xh = _nhwc(x)
    gh = _nhwc(g.to(x.dtype))
    dx = torch.empty_like(xh)
    dm = torch.empty((b, c), device=x.device, dtype=torch.float32)
    ds = torch.empty((b, c), device=x.device, dtype=torch.float32)
    cfg = tile_config(b, hw, c, PER_THREAD["bwd"])
    k["bwd"][cfg.pop("grid")](xh, std_s.contiguous(), gh, dx, dm, ds, b, hw, inv_n, inv_nm1,
                              eps, C=c, **cfg)
    BWD_LAUNCHES.add()
    return dx.permute(0, 3, 1, 2), dm, ds


def ada_in_ref(x, mean_s, std_s, eps: float = 1e-5):
    """Plain PyTorch AdaIN over NCHW (the kernel's math; two-pass f32 stats)."""
    n = x.shape[2] * x.shape[3]
    f = x.float()
    mean = f.mean(dim=(2, 3), keepdim=True)
    centred = f - mean
    var = centred.square().sum(dim=(2, 3), keepdim=True) / max(n - 1, 1)
    out = std_s.float()[:, :, None, None] * centred / (var.sqrt() + eps)
    return (out + mean_s.float()[:, :, None, None]).to(x.dtype)


def ada_in_bwd_ref(x, std_s, g, eps: float = 1e-5):
    """Closed-form AdaIN backward (the backward kernel's math).

    Returns (dx in x's dtype, dmean_s f32 [B, C], dstd_s f32 [B, C]); the
    sigma-term of dx is dropped where sigma == 0 (see the module docstring).
    Every op is differentiable, and where sigma == 0 sigma has a zero
    derivative, so the second order keeps the same limit.
    """
    n = x.shape[2] * x.shape[3]
    nm1 = max(n - 1, 1)
    f = x.float()
    gf = g.float()
    centred = f - f.mean(dim=(2, 3), keepdim=True)
    var = centred.square().sum(dim=(2, 3), keepdim=True) / nm1
    live = var > 0
    ones, zeros = torch.ones_like(var), torch.zeros_like(var)
    sigma = torch.where(live, torch.where(live, var, ones).sqrt(), zeros)
    denom = sigma + eps
    s = std_s.float()[:, :, None, None]
    g_dot_c = (gf * centred).sum(dim=(2, 3), keepdim=True)
    safe_sigma = torch.where(live, sigma, ones)
    coef = torch.where(live, s / denom.square() * g_dot_c / (nm1 * safe_sigma), zeros)
    dx = s / denom * (gf - gf.mean(dim=(2, 3), keepdim=True)) - coef * centred
    return dx.to(x.dtype), gf.sum(dim=(2, 3)), (g_dot_c / denom).flatten(1)


def _fwd(x, mean_s, std_s, eps):
    if x.is_cuda:
        return ada_in_fwd_cuda(x, mean_s, std_s, eps)
    if x.device.type == "cpu":
        return ada_in_ref(x, mean_s, std_s, eps)
    raise ValueError(f"ada_in: no kernel for device {x.device}")


def _bwd(x, std_s, g, eps):
    if x.is_cuda:
        return ada_in_bwd_cuda(x, std_s, g, eps)
    if x.device.type == "cpu":
        return ada_in_bwd_ref(x, std_s, g, eps)
    raise ValueError(f"ada_in backward: no kernel for device {x.device}")


class AdaINBackward(torch.autograd.Function):
    """(x, std_s, g) -> (dx, dmean_s, dstd_s): the backward kernel as forward; as
    backward, autograd of the closed form (once: a third order raises)."""

    @staticmethod
    def forward(ctx, x, std_s, g, eps):
        ctx.save_for_backward(x, std_s, g)
        ctx.eps = eps
        return _bwd(x, std_s, g, eps)

    @staticmethod
    @once_differentiable
    def backward(ctx, ddx, ddm, dds):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            grads = torch.autograd.grad(ada_in_bwd_ref(*inputs, ctx.eps), inputs,
                                        (ddx, ddm, dds))
        return (*grads, None)


class AdaINFunction(torch.autograd.Function):
    """AdaIN with the fused kernels as forward and backward."""

    @staticmethod
    def forward(ctx, x, mean_s, std_s, eps):
        ctx.save_for_backward(x, std_s)
        ctx.eps = eps
        ctx.mean_dtype = mean_s.dtype
        return _fwd(x, mean_s, std_s, eps)

    @staticmethod
    def backward(ctx, g):
        x, std_s = ctx.saved_tensors
        dx, dm, ds = AdaINBackward.apply(x, std_s, g, ctx.eps)
        return dx, dm.to(ctx.mean_dtype), ds.to(std_s.dtype), None


def ada_in(x, mean_s, std_s, eps: float = 1e-5):
    """AdaIN over NCHW x with [B, C] style mean/std; output in x's dtype."""
    return AdaINFunction.apply(x, mean_s, std_s, eps)
