"""Reading a torch.profiler trace of whole train steps.

``busy_us`` and ``CATEGORIES`` are frozen copies of
``scripts/torch_profile_step.py``'s: the device is busy in the union of its
kernels', memcpys' and memsets' intervals, and a kernel's category is the
first whose substrings its name holds.

The stretch is the span of a ``record_function(WINDOW)`` that ends in a
synchronize; every device activity that starts inside it is the stretch's.
An idle gap of the device is put down to what the host was launching when it
ended: the op that issued the last launch call before the next activity,
beside the outermost op above it.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

WINDOW = "cudabench.window"
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx",
                "cudaMemcpyAsync", "cudaMemsetAsync", "cudaLaunchCooperativeKernel")
TOP = 10
NAME_CHARS = 120  # a kernel's name in the breakdown, cut after its template's start

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


def _label(launch) -> str:
    parent = launch.cpu_parent
    if parent is None:
        return "(no op)"
    top = parent
    while top.cpu_parent is not None:
        top = top.cpu_parent
    return parent.name if top is parent else f"{top.name} / {parent.name}"


def read_profile(prof, steps: int) -> dict:
    """{"steps", "window_s", "busy_s", "kernels": [(name, s)], "activities",
    "device_ops": [[name, s]], "idle_gaps": [[label, s]], "categories": {label: s}}
    of the stretch, or {} where the trace holds no device activity there."""
    events = prof.events()
    spans = [e for e in events if e.name == WINDOW]
    if not spans:
        return {}
    w0, w1 = spans[-1].time_range.start, spans[-1].time_range.end
    device = sorted(
        ((e.time_range.start, e.time_range.end, e.name) for e in events
         if e.device_type == torch.autograd.DeviceType.CUDA
         and not getattr(e, "is_user_annotation", False)
         and w0 <= e.time_range.start < w1),
        key=lambda t: t[0])
    if not device:
        return {}
    busy = busy_us((s, e) for s, e, _ in device)
    by_name, by_cat = defaultdict(float), defaultdict(float)
    for s, e, name in device:
        by_name[name[:NAME_CHARS]] += (e - s) * 1e-6
        by_cat[category(name)] += (e - s) * 1e-6
    launches = sorted(((e.time_range.start, e) for e in events
                       if e.device_type == torch.autograd.DeviceType.CPU
                       and e.name in LAUNCH_CALLS and w0 <= e.time_range.start < w1),
                      key=lambda t: t[0])
    starts = [t for t, _ in launches]
    gaps = defaultdict(float)
    end = w0
    for s, e, _ in device + [(w1, w1, None)]:
        if s > end:
            i = bisect.bisect_right(starts, s) - 1
            gaps[_label(launches[i][1]) if i >= 0 else "(before any launch)"] += (s - end) * 1e-6
        end = max(end, e)
    return {
        "steps": steps,
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy * 1e-6,
        "activities": len(device),
        "kernels": [(name, (e - s) * 1e-6) for s, e, name in device],
        "device_ops": [[n, t] for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[n, t] for n, t in sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]],
        "categories": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
    }
