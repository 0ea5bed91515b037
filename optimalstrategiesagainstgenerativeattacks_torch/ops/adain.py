"""Adaptive instance normalisation and instance norm over NCHW tensors.

Counterpart of ``optimalstrategiesagainstgenerativeattacks_tpu/ops/adain.py``.
Two estimators, as in the reference:

  * ``ada_in``: the *unbiased* (N-1) feature std with eps added to the
    std; it runs the fused AdaIN kernel (``kernels/adain.py``) on CUDA
    tensors and its plain version on CPU tensors;
  * ``instance_norm``: the *biased* variance with eps added to the
    variance (torch ``InstanceNorm2d`` semantics).
"""

from __future__ import annotations

import torch

from optimalstrategiesagainstgenerativeattacks_torch.kernels.adain import ada_in

__all__ = ["ada_in", "instance_norm"]


def instance_norm(x, weight=None, bias=None, eps: float = 1e-5):
    """InstanceNorm2d over NCHW x in f32; optional [C] affine; output in x's dtype."""
    f = x.float()
    mean = f.mean(dim=(2, 3), keepdim=True)
    var = f.var(dim=(2, 3), unbiased=False, keepdim=True)
    out = (f - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight.float()[:, None, None]
    if bias is not None:
        out = out + bias.float()[:, None, None]
    return out.to(x.dtype)
