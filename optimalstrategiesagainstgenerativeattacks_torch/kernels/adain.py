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
H100's ~295 flops/byte ridge, and the largest flagship site moves
640*32*32*128 bf16 values.  The design therefore reads x in coalesced tiles
of a channels-last tensor (contiguous along C), keeps all statistics in
registers, and writes y once: no statistic or centred copy ever reaches
device memory.  One program owns one (sample, channel block) and loops over
H*W, so any spatial size works with a fixed register footprint.  The
variance is two-pass (mean first, then the centred sum of squares); the
re-reads of x for the later passes hit L2 at these sizes.

The TPU kernel held a whole sample's [H, W, C] tile in VMEM and reduced it
in one grid step; on Hopper a block has far less fast memory, so the loop
over H*W replaces the resident tile.

Zero variance: when sigma == 0 the centred values are all 0 and the
sigma-term of dx (c_i/sigma * sum g c) tends to 0; the kernel and its plain
version drop it there, so dx stays finite.  The Pallas backward divided by
sigma and autodiff through sqrt(0) both give non-finite dx at that point.

Plain PyTorch versions of the same functions (``ada_in_ref`` and the
closed-form ``ada_in_bwd_ref``) sit below; the wrapper runs them only for
tensors on the CPU.
"""

from __future__ import annotations

import torch

from optimalstrategiesagainstgenerativeattacks_torch.kernels.build import (
    LaunchCounter,
    import_triton,
)

FWD_LAUNCHES = LaunchCounter("adain_fwd")
BWD_LAUNCHES = LaunchCounter("adain_bwd")

_SUPPORTED = (torch.float32, torch.bfloat16)
_TRITON = {}


def _triton_kernels():
    """JIT-define the two Triton kernels (once per process)."""
    if _TRITON:
        return _TRITON
    triton, tl = import_triton()

    @triton.jit
    def adain_fwd_kernel(x_ptr, ms_ptr, ss_ptr, out_ptr, HW, C, inv_n, inv_nm1, eps,
                         BLOCK_HW: tl.constexpr, BLOCK_C: tl.constexpr):
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
    def adain_bwd_kernel(x_ptr, ss_ptr, g_ptr, dx_ptr, dm_ptr, ds_ptr, HW, C, inv_n,
                         inv_nm1, eps, BLOCK_HW: tl.constexpr, BLOCK_C: tl.constexpr):
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
        g_mean = sg * inv_n
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
        sigma = tl.sqrt(sdd * inv_nm1)
        f = sigma + eps
        ss = tl.load(ss_ptr + b * C + cols, mask=cmask, other=0.0).to(tl.float32)
        a = ss / f
        # sigma-term of dx, dropped where sigma == 0 (its limit)
        safe_sigma = tl.where(sigma > 0.0, sigma, 1.0)
        coef = tl.where(sigma > 0.0, ss / (f * f) * sgd * inv_nm1 / safe_sigma, 0.0)
        for start in range(0, HW, BLOCK_HW):
            rows = start + rows0
            mask = (rows[:, None] < HW) & cmask[None, :]
            offs = base + rows[:, None] * C + cols[None, :]
            x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            dx = a[None, :] * (g - g_mean[None, :]) - coef[None, :] * (x - mean[None, :])
            tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=mask)
        tl.store(dm_ptr + b * C + cols, sg, mask=cmask)
        tl.store(ds_ptr + b * C + cols, sgd / f, mask=cmask)

    _TRITON["fwd"] = adain_fwd_kernel
    _TRITON["bwd"] = adain_bwd_kernel
    _TRITON["cdiv"] = triton.cdiv
    return _TRITON


def _blocks(hw: int, c: int):
    """Tile sizes: up to 64 channels (128 B of bf16) by enough rows for ~4k elements."""
    block_c = max(2, min(64, 1 << (c - 1).bit_length()))
    block_hw = max(16, min(4096 // block_c, 1 << (hw - 1).bit_length()))
    return block_hw, block_c


def _check_cuda(name, *tensors):
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: all tensors must be on the same CUDA device")
        if t.dtype not in _SUPPORTED:
            raise TypeError(f"{name}: dtype {t.dtype} not supported (float32, bfloat16)")


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW tensor -> contiguous [B, H, W, C] (a view for channels_last input)."""
    return x.permute(0, 2, 3, 1).contiguous()


def _stats_args(x: torch.Tensor):
    hw = x.shape[2] * x.shape[3]
    return hw, 1.0 / hw, 1.0 / max(hw - 1, 1)


def ada_in_fwd_cuda(x, mean_s, std_s, eps: float = 1e-5):
    """Launch the forward kernel.  x: NCHW (ideally channels_last); styles [B, C]."""
    _check_cuda("ada_in", x, mean_s, std_s)
    b, c = x.shape[0], x.shape[1]
    if mean_s.shape != (b, c) or std_s.shape != (b, c):
        raise ValueError(f"ada_in: style shapes {mean_s.shape}, {std_s.shape} != {(b, c)}")
    k = _triton_kernels()
    hw, inv_n, inv_nm1 = _stats_args(x)
    xh = _nhwc(x)
    out = torch.empty_like(xh)
    block_hw, block_c = _blocks(hw, c)
    grid = (b, k["cdiv"](c, block_c))
    k["fwd"][grid](xh, mean_s.contiguous(), std_s.contiguous(), out, hw, c, inv_n, inv_nm1,
                   eps, BLOCK_HW=block_hw, BLOCK_C=block_c, num_warps=4)
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
    block_hw, block_c = _blocks(hw, c)
    grid = (b, k["cdiv"](c, block_c))
    k["bwd"][grid](xh, std_s.contiguous(), gh, dx, dm, ds, hw, c, inv_n, inv_nm1, eps,
                   BLOCK_HW=block_hw, BLOCK_C=block_c, num_warps=4)
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
    """
    n = x.shape[2] * x.shape[3]
    nm1 = max(n - 1, 1)
    f = x.float()
    gf = g.float()
    centred = f - f.mean(dim=(2, 3), keepdim=True)
    sigma = (centred.square().sum(dim=(2, 3), keepdim=True) / nm1).sqrt()
    denom = sigma + eps
    s = std_s.float()[:, :, None, None]
    g_dot_c = (gf * centred).sum(dim=(2, 3), keepdim=True)
    safe_sigma = torch.where(sigma > 0, sigma, torch.ones_like(sigma))
    coef = torch.where(sigma > 0, s / denom.square() * g_dot_c / (nm1 * safe_sigma),
                       torch.zeros_like(sigma))
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
        dx, dm, ds = _bwd(x, std_s, g, ctx.eps)
        return dx, dm.to(ctx.mean_dtype), ds.to(std_s.dtype), None


def ada_in(x, mean_s, std_s, eps: float = 1e-5):
    """AdaIN over NCHW x with [B, C] style mean/std; output in x's dtype."""
    return AdaINFunction.apply(x, mean_s, std_s, eps)
