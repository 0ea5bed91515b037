"""Percent of the card's dense bf16 peak (989 TFLOP/s, H100 SXM) that the whole step
reaches: the model FLOPs of a step (``counts/model_flops.py``: the frozen reference's
step with the folded convs counted in the folded form the program runs) times the steps
of the trace run's unprofiled stretch, over its seconds.  Layer: device."""

from cudabench.counts.kernels import PEAK_FLOPS

UNIT = "%"


def read(ctx):
    s, flops = ctx.get("unprofiled"), ctx.get("flops_per_step")
    if not s or not flops or s["seconds"] <= 0:
        return None
    return 100.0 * flops * s["steps"] / s["seconds"] / PEAK_FLOPS["bf16_tensor"]
