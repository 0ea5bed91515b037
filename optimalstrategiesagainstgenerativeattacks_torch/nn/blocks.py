"""Building blocks of the image game, NCHW (channels_last memory inside).

Counterpart of ``optimalstrategiesagainstgenerativeattacks_tpu/nn/blocks.py``
for the blocks the image game's main path uses.  Submodule and parameter
names follow the Flax names, so ``port/transplant.py`` maps one tree onto the
other by rule.

Compute dtype policy (as in the reference): parameters stay f32; every conv
and linear casts its input and its (normalised) weight to ``dtype`` when one
is given, so a bf16 game runs bf16 convs and matmuls with f32 parameters and
f32 normalisation statistics.  No ``torch.autocast``.

The blocks run in the plain torch order (conv then pool, upsample then conv,
a channel concat for two-part inputs).  The reference folds some of these
into single convs (exact algebra: ``nn/blocks.py`` ``_fold_kernel_for_*``,
the 1x1 skip conv moved before pooling or upsampling, the tuple input); the
folds are left for measurement on the H100.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from optimalstrategiesagainstgenerativeattacks_torch.kernels.attention import attention_core
from optimalstrategiesagainstgenerativeattacks_torch.nn.init import (
    kaiming_normal_,
    torch_default_,
)
from optimalstrategiesagainstgenerativeattacks_torch.ops.adain import ada_in, instance_norm
from optimalstrategiesagainstgenerativeattacks_torch.ops.image_ops import (
    avg_pool2d,
    leaky_relu,
    upscale2d,
)
from optimalstrategiesagainstgenerativeattacks_torch.ops.spectral import (
    l2_normalize,
    power_iterate_,
    sigma,
    weight_matrix,
)


class Dense(nn.Module):
    """Linear layer, weight [out, in]; ``init`` is "torch" or "kaiming" (a=0.2, zero bias)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: Optional[torch.dtype] = None, init: str = "torch"):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        self.dtype = dtype
        self.init = init

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.init == "kaiming":
            kaiming_normal_(self.weight, self.bias, generator)
        else:
            torch_default_(self.weight, self.bias, generator)

    def forward(self, x):
        if self.dtype is None:
            return F.linear(x, self.weight, self.bias)
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class SNConv(nn.Module):
    """Spectrally normalised conv: weight / sigma(weight), bias not normalised.

    Buffers ``u`` [out] and ``v`` [in*kh*kw] hold the power-iteration state;
    ``power_iterate_`` advances them (once per player per step) and the
    forward uses sigma = u^T W v from the stored vectors.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 padding: int = 0, dtype: Optional[torch.dtype] = None, eps: float = 1e-12):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size, kernel_size)
        )
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.register_buffer("u", torch.zeros(out_channels))
        self.register_buffer("v", torch.zeros(in_channels * kernel_size * kernel_size))
        self.padding = padding
        self.dtype = dtype
        self.eps = eps

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        torch_default_(self.weight, self.bias, generator)
        u0 = torch.randn(self.u.shape, generator=generator)
        self.u.copy_(l2_normalize(u0, self.eps))
        self.v.copy_(l2_normalize(weight_matrix(self.weight).t() @ self.u, self.eps))

    def power_iterate_(self) -> None:
        power_iterate_(self.weight, self.u, self.v, self.eps)

    def forward(self, x):
        w = self.weight / sigma(self.weight, self.u, self.v)
        b = self.bias
        if self.dtype is not None:
            x, w, b = x.to(self.dtype), w.to(self.dtype), b.to(self.dtype)
        return conv2d(x, w, b, self.padding)


def conv2d(x, w, b, padding: int):
    """``F.conv2d``, except on the card for one input and one output channel."""
    if x.is_cuda and w.shape[:2] == (1, 1):
        return conv_one_channel(x, w, b, padding)
    return F.conv2d(x, w, b, padding=padding)


def conv_one_channel(x, w, b, padding: int):
    """``F.conv2d`` of one input channel to one output channel, as im2col and a matmul.

    cuDNN 9.22 (torch 2.11, cu128) on an H100 gets bf16 convs of one channel
    to one channel wrong: the flagship env decoder's last conv ([640, 1, 32,
    32] in, 3x3) comes out off by as much as the output's own size, and NaN
    once other convs have run.  The same sums through ``F.unfold`` and one
    matmul (cuBLAS) are right up to bf16 rounding, forward and backward.
    """
    k = w.shape[-1]
    h, wd = (x.shape[2] + 2 * padding - k + 1, x.shape[3] + 2 * padding - k + 1)
    cols = F.unfold(x, k, padding=padding)  # [B, k*k, h*wd]
    out = torch.matmul(w.reshape(1, -1), cols) + b.reshape(1, 1, 1)
    return out.reshape(x.shape[0], 1, h, wd)


class InstanceNorm(nn.Module):
    """InstanceNorm2d with affine ``weight``/``bias`` (Flax ``scale``/``bias``)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        return instance_norm(x, self.weight, self.bias, self.eps)


class MLP(nn.Module):
    """Linear + LeakyReLU(0.2) stack with a linear head; ``layer_dims`` includes the input."""

    def __init__(self, layer_dims: Sequence[int], dtype: Optional[torch.dtype] = None,
                 init: str = "torch"):
        super().__init__()
        dims = list(layer_dims)
        self.layers = nn.ModuleList(
            Dense(i, o, dtype=dtype, init=init) for i, o in zip(dims[:-1], dims[1:])
        )

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = leaky_relu(layer(x))
        return self.layers[-1](x)


class ResBlockDown(nn.Module):
    """SN residual down block: left 1x1 conv -> pool; right lrelu, conv, lrelu, conv, pool."""

    def __init__(self, in_channels: int, out_channels: int, conv_size: int = 3,
                 padding: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv_l1 = SNConv(in_channels, out_channels, 1, padding=0, dtype=dtype)
        self.conv_r1 = SNConv(in_channels, out_channels, conv_size, padding=padding,
                              dtype=dtype)
        self.conv_r2 = SNConv(out_channels, out_channels, conv_size, padding=padding,
                              dtype=dtype)

    def forward(self, x):
        res = avg_pool2d(self.conv_l1(x))
        out = self.conv_r1(leaky_relu(x))
        out = avg_pool2d(self.conv_r2(leaky_relu(out)))
        return res + out


class SelfAttention(nn.Module):
    """SAGAN self-attention over spatial tokens; softmax over the source axis.

    f, g, h are 1x1 SN convs; the core runs the attention kernel on CUDA
    tensors (``kernels/attention.py``).
    """

    def __init__(self, channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        cq = max(channels // 8, 1)
        self.conv_f = SNConv(channels, cq, 1, padding=0, dtype=dtype)
        self.conv_g = SNConv(channels, cq, 1, padding=0, dtype=dtype)
        self.conv_h = SNConv(channels, channels, 1, padding=0, dtype=dtype)
        self.gamma = nn.Parameter(torch.zeros(1))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.gamma.zero_()

    def forward(self, x):
        b, c, h, w = x.shape

        def tokens(t):  # [B, C', H, W] -> [B, H*W, C']
            return t.permute(0, 2, 3, 1).reshape(b, h * w, t.shape[1])

        out = attention_core(tokens(self.conv_f(x)), tokens(self.conv_g(x)),
                             tokens(self.conv_h(x)))
        out = out.reshape(b, h, w, c).permute(0, 3, 1, 2).to(x.dtype)
        return self.gamma * out + x


class ResBlockUp(nn.Module):
    """SN residual 2x up block with instance norm.

    left: upsample -> 1x1 conv; right: IN, lrelu, upsample, conv, IN, lrelu, conv.
    """

    def __init__(self, in_channels: int, out_channels: int, conv_size: int = 3,
                 padding: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv_l1 = SNConv(in_channels, out_channels, 1, padding=0, dtype=dtype)
        self.in1 = InstanceNorm(in_channels)
        self.conv_r1 = SNConv(in_channels, out_channels, conv_size, padding=padding,
                              dtype=dtype)
        self.in2 = InstanceNorm(out_channels)
        self.conv_r2 = SNConv(out_channels, out_channels, conv_size, padding=padding,
                              dtype=dtype)

    def forward(self, x):
        res = self.conv_l1(upscale2d(x))
        out = leaky_relu(self.in1(x))
        out = self.conv_r1(upscale2d(out))
        out = self.conv_r2(leaky_relu(self.in2(out)))
        return out + res


class AdaResBlock2(nn.Module):
    """AdaIN residual block; style mapped by four linears to two (mean, std) pairs."""

    def __init__(self, channels: int, style_dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.lin1_mean = Dense(style_dim, channels, dtype=dtype)
        self.lin1_std = Dense(style_dim, channels, dtype=dtype)
        self.lin2_mean = Dense(style_dim, channels, dtype=dtype)
        self.lin2_std = Dense(style_dim, channels, dtype=dtype)
        self.conv1 = SNConv(channels, channels, 3, padding=1, dtype=dtype)
        self.conv2 = SNConv(channels, channels, 3, padding=1, dtype=dtype)

    def forward(self, x, style):
        res = x
        x = ada_in(self.conv1(x), self.lin1_mean(style), self.lin1_std(style))
        x = self.conv2(leaky_relu(x))
        x = ada_in(x, self.lin2_mean(style), self.lin2_std(style))
        return x + res


class AdaResBlockUp2(nn.Module):
    """AdaIN residual 2x up block.

    left: upsample -> 1x1 conv; right: AdaIN, lrelu, upsample, conv, AdaIN, lrelu, conv.
    """

    def __init__(self, in_channels: int, out_channels: int, style_dim: int,
                 conv_size: int = 3, padding: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.lin1_mean = Dense(style_dim, in_channels, dtype=dtype)
        self.lin1_std = Dense(style_dim, in_channels, dtype=dtype)
        self.lin2_mean = Dense(style_dim, out_channels, dtype=dtype)
        self.lin2_std = Dense(style_dim, out_channels, dtype=dtype)
        self.conv_l1 = SNConv(in_channels, out_channels, 1, padding=0, dtype=dtype)
        self.conv_r1 = SNConv(in_channels, out_channels, conv_size, padding=padding,
                              dtype=dtype)
        self.conv_r2 = SNConv(out_channels, out_channels, conv_size, padding=padding,
                              dtype=dtype)

    def forward(self, x, style):
        res = self.conv_l1(upscale2d(x))
        out = leaky_relu(ada_in(x, self.lin1_mean(style), self.lin1_std(style)))
        out = self.conv_r1(upscale2d(out))
        out = leaky_relu(ada_in(out, self.lin2_mean(style), self.lin2_std(style)))
        return self.conv_r2(out) + res



class ImgAttConvBlock(nn.Module):
    """SN residual conv block: res = 1x1 conv of x; out = lrelu, 9x9 conv (pad 4),
    lrelu, 3x3 conv; returns res + out."""

    def __init__(self, in_channels: int, out_channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv_l1 = SNConv(in_channels, out_channels, 1, padding=0, dtype=dtype)
        self.conv_r1 = SNConv(in_channels, out_channels, 9, padding=4, dtype=dtype)
        self.conv_r2 = SNConv(out_channels, out_channels, 3, padding=1, dtype=dtype)

    def forward(self, x):
        out = self.conv_r2(leaky_relu(self.conv_r1(leaky_relu(x))))
        return self.conv_l1(x) + out


class ImgAttention(nn.Module):
    """Per-pixel two-way softmax blend of two NCHW images of ``img1_channels`` each.

    Scores q1.k1 and q2.k2 over channels (q from both images, k1 from x1,
    k2 and the value v2 from x2); the softmax over the two scores runs in f32
    and is cast back to x1's dtype; returns x1 a0 + v2 a1.  Stock torch ops:
    the JAX package wrote no kernel for it either.
    """

    def __init__(self, img1_channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        c = img1_channels
        self.q1conv = ImgAttConvBlock(2 * c, c, dtype=dtype)
        self.q2conv = ImgAttConvBlock(2 * c, c, dtype=dtype)
        self.k1conv = ImgAttConvBlock(c, c, dtype=dtype)
        self.k2conv = ImgAttConvBlock(c, c, dtype=dtype)
        self.v2conv = ImgAttConvBlock(c, c, dtype=dtype)

    def forward(self, x1, x2):
        x = torch.cat([x1, x2], dim=1)
        scores1 = (self.q1conv(x) * self.k1conv(x1)).sum(dim=1)  # [B, H, W]
        scores2 = (self.q2conv(x) * self.k2conv(x2)).sum(dim=1)
        attention = torch.softmax(torch.stack([scores1, scores2], dim=-1).float(), dim=-1)
        attention = attention.to(x1.dtype).permute(0, 3, 1, 2)  # [B, 2, H, W]
        return x1 * attention[:, 0:1] + self.v2conv(x2) * attention[:, 1:2]
