"""Frozen work counts of the port's hand-written kernels, and the card's peaks.

Copied from the program as the yardstick, so that a later change to the
program's own copies cannot move it: the byte and flop counts of
``kernels/adain.py`` (K1 forward, K1b backward) and ``kernels/attention.py``
(K2), and ``chip_smoke.py``'s bound.  A kernel's least time is the larger of
its bytes over the HBM rate and its operations over the peak of the units it
runs on: AdaIN's f32 arithmetic on CUDA cores, the attention's bf16 products
on tensor cores.

A configuration lists the launch sites of one train step under
``kernel_sites`` (``chip_smoke.py``'s per-step tables): AdaIN as
[B', C, H, W, dtype, launches] (the backward launches as often as the
forward), the attention core as [B', N, C, CQ, launches].
"""

from __future__ import annotations

from typing import Optional

# NVIDIA H100 SXM data sheet: HBM rate, dense bf16 tensor-core and f32 CUDA-core peaks
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16_tensor": 989e12, "f32": 67e12}
ITEMSIZE = {"f32": 4, "bf16": 2}


def ada_in_fwd_bytes(b: int, h: int, w: int, c: int, itemsize: int) -> int:
    """x and both styles read, y written."""
    return (2 * b * h * w * c + 2 * b * c) * itemsize


def ada_in_bwd_bytes(b: int, h: int, w: int, c: int, itemsize: int) -> int:
    """x, g and std_s read and dx written in the input's dtype, dmean_s and dstd_s in f32."""
    return (3 * b * h * w * c + b * c) * itemsize + 2 * b * c * 4


def ada_in_fwd_flops(b: int, h: int, w: int, c: int) -> int:
    return 5 * b * h * w * c


def ada_in_bwd_flops(b: int, h: int, w: int, c: int) -> int:
    return 11 * b * h * w * c


def attention_core_bytes(b: int, n: int, c: int, cq: int, itemsize: int) -> int:
    """f, g and h read once, the output written once."""
    return b * n * (2 * cq + 2 * c) * itemsize


def attention_core_flops(b: int, n: int, c: int, cq: int) -> int:
    """The two products, S = f g^T and P^T h."""
    return 2 * b * n * n * (cq + c)


def bound_s(n_bytes: int, flops: int, rate: str) -> float:
    """Least seconds for this much work on the card."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[rate])


def step_bounds(sites: dict) -> dict:
    """{kernel: (least seconds a step, launches a step)} for a configuration's
    ``kernel_sites``; kernels "adain_fwd", "adain_bwd", "attention_core"."""
    out = {"adain_fwd": [0.0, 0], "adain_bwd": [0.0, 0], "attention_core": [0.0, 0]}
    for b, c, h, w, dtype, launches in sites.get("adain", []):
        size = ITEMSIZE[dtype]
        out["adain_fwd"][0] += launches * bound_s(ada_in_fwd_bytes(b, h, w, c, size),
                                                  ada_in_fwd_flops(b, h, w, c), "f32")
        out["adain_bwd"][0] += launches * bound_s(ada_in_bwd_bytes(b, h, w, c, size),
                                                  ada_in_bwd_flops(b, h, w, c), "f32")
        out["adain_fwd"][1] += launches
        out["adain_bwd"][1] += launches
    for b, n, c, cq, launches in sites.get("attention", []):
        out["attention_core"][0] += launches * bound_s(
            attention_core_bytes(b, n, c, cq, ITEMSIZE["bf16"]),
            attention_core_flops(b, n, c, cq), "bf16_tensor")
        out["attention_core"][1] += launches
    return {k: tuple(v) for k, v in out.items()}


def roofline_share(ctx: dict, kernels) -> Optional[float]:
    """Percent of its roofline that the named kernels reach over the profiled stretch:
    the frozen least time of every launch over the kernels' device time.  None where
    the stretch does not hold the launches the configuration's sites say (the port
    runs other sites, or the kernel is off its path)."""
    prof = ctx.get("profile")
    if not prof:
        return None
    bounds = step_bounds(ctx["config"].get("kernel_sites", {}))
    least, device_s = 0.0, 0.0
    for kernel in kernels:
        per_step, launches = bounds[kernel]
        events = [d for name, d in prof["kernels"] if kernel in name]
        if launches == 0 or len(events) != launches * prof["steps"]:
            return None
        least += per_step * prof["steps"]
        device_s += sum(events)
    return 100.0 * least / device_s if device_s > 0 else None
