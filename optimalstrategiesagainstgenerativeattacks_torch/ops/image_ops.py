"""Spatial image ops over NCHW tensors.

Counterpart of ``optimalstrategiesagainstgenerativeattacks_tpu/ops/image_ops.py``
(nearest upscale, average and max pooling, global max and mean pooling, the
StyleGAN [1,2,1] blur, LeakyReLU(0.2)).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


def upscale2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upscale of NCHW by an integer factor."""
    if factor == 1:
        return x
    return F.interpolate(x, scale_factor=factor, mode="nearest")


def avg_pool2d(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Average pooling with a square window (at least 2) equal to its stride (valid padding).

    A bf16 input is summed in bf16, as the reference sums it (``mean(..., dtype=x.dtype)``
    over a window view) and XLA's compile adds it: ``Bf16Pool``.  Any other dtype goes
    through ``F.avg_pool2d``."""
    if x.dtype == torch.bfloat16:
        return Bf16Pool.apply(x, window)
    return F.avg_pool2d(x, window)


def _layout(nhwc: bool) -> torch.memory_format:
    return torch.channels_last if nhwc else torch.contiguous_format


class Bf16Pool(torch.autograd.Function):
    """The window's values added one by one into a bf16 sum, row-major, each partial sum
    rounded, then divided by the window's size: XLA's compile of the reference's pool,
    bit for bit, on the CPU and the card alike (elementwise bf16 ops round the same on
    both).  The output takes the layout ``F.avg_pool2d`` gives (channels_last for a
    channels_last input, and for an NHWC image of one channel viewed NCHW), so the conv
    behind it reads no transform.  Its gradient is ``Bf16Unpool``, whose gradient is
    this pool again, so R1's double backward pools as the reference does."""

    @staticmethod
    def forward(ctx, x, window):
        b, c, h, w = x.shape
        sb, sc, sh, sw = x.stride()
        nhwc = sc == 1 and x.is_contiguous(memory_format=torch.channels_last)
        ctx.window, ctx.nhwc = window, nhwc
        # [i, j, b, c, h/w, w/w]: the window's value at row i, column j
        v = x.as_strided((window, window, b, c, h // window, w // window),
                         (sh, sw, sb, sc, sh * window, sw * window))
        terms = [t for row in v.unbind() for t in row.unbind()]
        s = torch.empty((b, c, h // window, w // window), dtype=x.dtype, device=x.device,
                        memory_format=_layout(nhwc))
        torch.add(terms[0], terms[1], out=s)
        for t in terms[2:]:
            s.add_(t)
        return s.div_(window * window)

    @staticmethod
    def backward(ctx, g):
        return Bf16Unpool.apply(g, ctx.window, ctx.nhwc), None


class Bf16Unpool(torch.autograd.Function):
    """``g / w²`` broadcast over each window (exact for a window of 2) in one launch, in the
    pooled input's layout; its gradient is ``Bf16Pool``."""

    @staticmethod
    def forward(ctx, g, window, nhwc):
        ctx.window = window
        b, c, h, w = g.shape
        out = torch.empty((b, c, h * window, w * window), dtype=g.dtype, device=g.device,
                          memory_format=_layout(nhwc))
        ob, oc, oh, ow = out.stride()
        gb, gc, gh, gw = g.stride()
        shape = (b, c, h, window, w, window)
        torch.div(g.as_strided(shape, (gb, gc, gh, 0, gw, 0)),
                  window * window,
                  out=out.as_strided(shape, (ob, oc, oh * window, oh, ow * window, ow)))
        return out

    @staticmethod
    def backward(ctx, gg):
        return Bf16Pool.apply(gg, ctx.window), None, None


def max_pool2d(x: torch.Tensor, window: int = 2, stride: int | None = None) -> torch.Tensor:
    """Max pooling with a square window (valid padding); the stride defaults to the window."""
    return F.max_pool2d(x, window, stride or window)


def adaptive_max_pool(x: torch.Tensor) -> torch.Tensor:
    """Global spatial max: NCHW -> [B, C]."""
    return x.amax(dim=(2, 3))


def adaptive_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Global spatial mean: NCHW -> [B, C]."""
    return x.mean(dim=(2, 3))


def blur3x3(x: torch.Tensor, normalize: bool = True, stride: int = 1) -> torch.Tensor:
    """Depthwise [1,2,1] x [1,2,1] blur (StyleGAN's BlurLayer), padding 1, in x's dtype.

    A conv with ``groups=C``, each group one channel to one channel.
    """
    k1d = torch.tensor([1.0, 2.0, 1.0])
    k = torch.outer(k1d, k1d)
    if normalize:
        k = k / k.sum()
    c = x.shape[1]
    kernel = k.to(device=x.device, dtype=x.dtype).expand(c, 1, 3, 3)
    return F.conv2d(x, kernel, stride=stride, padding=1, groups=c)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """LeakyReLU with the project-wide default slope of 0.2, the slope rounded to x's
    dtype: the reference multiplies by a weakly typed constant, so a bf16 input by
    bf16(0.2) = 0.2001953125 (``F.leaky_relu`` multiplies by 0.2 in f32)."""
    return F.leaky_relu(x, _slope(negative_slope, x.dtype))


@functools.lru_cache(maxsize=None)
def _slope(negative_slope: float, dtype: torch.dtype) -> float:
    return torch.tensor(negative_slope, dtype=dtype).item()


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> NCHW view; a contiguous input gives channels_last memory."""
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> [B, H, W, C] view."""
    return x.permute(0, 2, 3, 1)
