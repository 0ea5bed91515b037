"""Building blocks of the image game, NCHW (channels_last memory inside).

Counterpart of ``optimalstrategiesagainstgenerativeattacks_tpu/nn/blocks.py``:
the blocks of the image game's main path, and the reference's others (the
residual MLPs, the StyleGAN kit and the legacy AdaIN blocks, which no entry
path uses).  Submodule and parameter names follow the Flax names, so
``port/transplant.py`` maps one tree onto the other by rule.

Compute dtype policy (as in the reference): parameters stay f32; every conv
and linear casts its input and its (normalised) weight to ``dtype`` when one
is given, so a bf16 game runs bf16 convs and matmuls with f32 parameters and
f32 normalisation statistics.  No ``torch.autocast``.

Where XLA's default compile of the JAX step keeps a bf16 value in f32 for
the op that reads it (``xla_allow_excess_precision``), the port keeps it in
f32 too: the residual blocks return their sums in f32, and a conv's bias is
added in f32 when a norm reads the conv (``SNConv(f32_out=True)``: the conv
rounds, its sum with the bias does not).  A conv that reads an f32 sum
rounds it to its compute dtype itself; where XLA rounds the sum for another
consumer (a global max pool, tanh, the AdaIN res stack's loop carry, the
next down block; a norm's output read by the attention), the model that
knows the consumer rounds it (``models/image.py``).
``tests/test_torch_bf16_sites.py`` holds each site to XLA's compile;
``scripts/torch_bf16_sites.py`` prints the readings.

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
from optimalstrategiesagainstgenerativeattacks_torch.ops.adain import (
    ada_in,
    instance_norm,
    pixel_norm,
)
from optimalstrategiesagainstgenerativeattacks_torch.ops.image_ops import (
    avg_pool2d,
    blur3x3,
    leaky_relu,
    to_nhwc,
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


class Conv(nn.Module):
    """Plain conv (no spectral norm), stride 1; ``init`` as ``Dense``'s."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 padding: int = 0, dtype: Optional[torch.dtype] = None, init: str = "torch"):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size, kernel_size)
        )
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.padding = padding
        self.dtype = dtype
        self.init = init

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.init == "kaiming":
            kaiming_normal_(self.weight, self.bias, generator)
        else:
            torch_default_(self.weight, self.bias, generator)

    def forward(self, x):
        w, b = self.weight, self.bias
        if self.dtype is not None:
            x, w, b = x.to(self.dtype), w.to(self.dtype), b.to(self.dtype)
        return conv2d(x, w, b, self.padding)


class SNConv(nn.Module):
    """Spectrally normalised conv: weight / sigma(weight), bias not normalised.

    Buffers ``u`` [out] and ``v`` [in*kh*kw] hold the power-iteration state;
    ``power_iterate_`` advances them (once per player per step) and the
    forward uses sigma = u^T W v from the stored vectors.

    ``f32_out``: for a conv whose output a norm reads.  The conv rounds to
    ``dtype`` and the bias (rounded to ``dtype``) is added in f32, so the norm
    reads the sum unrounded, as XLA compiles the JAX conv followed by a norm.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 padding: int = 0, dtype: Optional[torch.dtype] = None, eps: float = 1e-12,
                 f32_out: bool = False):
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
        self.f32_out = f32_out

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
            if self.f32_out:
                return conv2d(x, w, None, self.padding).float() + b.float()[:, None, None]
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


class Flatten(nn.Module):
    """[B, ...] -> [B, -1], an NCHW map in NHWC order (the reference's element order)."""

    def forward(self, x):
        return (to_nhwc(x) if x.ndim == 4 else x).reshape(x.shape[0], -1)


class Identity(nn.Module):
    """Pass-through."""

    def forward(self, x):
        return x


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


class ResMLP(nn.Module):
    """``out_linear([linear(x), model(x)])``: a skip linear beside an MLP."""

    def __init__(self, layer_dims: Sequence[int], dtype: Optional[torch.dtype] = None):
        super().__init__()
        d_in, d_out = layer_dims[0], layer_dims[-1]
        self.linear = Dense(d_in, d_out, dtype=dtype)
        self.model = MLP(layer_dims, dtype=dtype)
        self.out_linear = Dense(2 * d_out, d_out, dtype=dtype)

    def forward(self, x):
        return self.out_linear(torch.cat([self.linear(x), self.model(x)], dim=-1))


class ResMLP2(nn.Module):
    """``linear([x, model(x)])``: the input concatenated beside an MLP."""

    def __init__(self, layer_dims: Sequence[int], dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.model = MLP(layer_dims, dtype=dtype)
        self.linear = Dense(layer_dims[0] + layer_dims[-1], layer_dims[-1], dtype=dtype)

    def forward(self, x):
        return self.linear(torch.cat([x, self.model(x)], dim=-1))


@torch.no_grad()
def init_resmlp_to_replay(module: nn.Module, style_dim: int, generator: torch.Generator) -> None:
    """Re-initialise a ``ResMLP``/``ResMLP2`` in place for replay: each skip linear
    (``linear``, ``out_linear``) N(0, 1e-4^2) with the identity on its leading
    [style_dim, style_dim] block and a zero bias; the inner MLP kaiming(0.2), zero bias.
    The bits differ from the reference's (another generator); the distributions are its."""
    for name in ("linear", "out_linear"):
        lin = getattr(module, name, None)
        if lin is not None:
            lin.weight.normal_(0.0, 1e-4, generator=generator)
            lin.weight[:style_dim, :style_dim] = torch.eye(style_dim)
            lin.bias.zero_()
    for layer in module.model.layers:
        kaiming_normal_(layer.weight, layer.bias, generator)


class NoiseLayer(nn.Module):
    """x + weight[c] * noise[b, 1, h, w], with a per-channel weight that starts at 0.

    ``noise`` [B, 1, H, W] is given, or drawn in x's dtype on x's device from
    ``generator`` (the default generator without one).
    """

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(channels))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.zero_()

    def forward(self, x, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        if noise is None:
            noise = torch.randn((x.shape[0], 1, *x.shape[2:]), generator=generator,
                                device=x.device, dtype=x.dtype)
        return x + self.weight[:, None, None] * noise


class StyleMod(nn.Module):
    """x * (s0 + 1) + s1 with (s0, s1) = ``lin(style)`` split at C."""

    def __init__(self, channels: int, style_dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.lin = Dense(style_dim, 2 * channels, dtype=dtype)
        self.channels = channels

    def forward(self, x, style):
        s = self.lin(style)[:, :, None, None]
        return x * (s[:, :self.channels] + 1.0) + s[:, self.channels:]


class StyleEstimator(nn.Module):
    """1x1 conv -> lrelu -> global mean -> linear: NCHW -> [B, style_dim]."""

    def __init__(self, in_channels: int, style_dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = Conv(in_channels, 2 * style_dim, 1, dtype=dtype)
        self.lin = Dense(2 * style_dim, style_dim, dtype=dtype)

    def forward(self, x):
        return self.lin(leaky_relu(self.conv(x)).mean(dim=(2, 3)))


class SGLayerEpilogue(nn.Module):
    """Noise, lrelu, pixel norm and/or instance norm, then ``StyleMod``.

    ``instance_norm`` here is the plain one (biased variance, eps inside the
    sqrt), not AdaIN's statistics, so it runs stock ops and no AdaIN kernel.
    """

    def __init__(self, channels: int, style_dim: int, use_pixel_norm: bool = False,
                 use_instance_norm: bool = True, use_noise: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.noise = NoiseLayer(channels) if use_noise else None
        self.style_mod = StyleMod(channels, style_dim, dtype=dtype)
        self.use_pixel_norm = use_pixel_norm
        self.use_instance_norm = use_instance_norm

    def forward(self, x, style, generator: Optional[torch.Generator] = None):
        if self.noise is not None:
            x = self.noise(x, generator=generator)
        x = leaky_relu(x)
        if self.use_pixel_norm:
            x = pixel_norm(x)
        if self.use_instance_norm:
            x = instance_norm(x)
        return self.style_mod(x, style)


def _epilogues(channels: int, style_dim: int, use_pixel_norm: bool, use_instance_norm: bool,
               use_noise: bool, dtype) -> tuple:
    return tuple(SGLayerEpilogue(channels, style_dim, use_pixel_norm, use_instance_norm,
                                 use_noise, dtype) for _ in range(2))


class SGInputBlock(nn.Module):
    """epilogue -> 3x3 conv -> epilogue."""

    def __init__(self, channels: int, style_dim: int, use_pixel_norm: bool = False,
                 use_instance_norm: bool = True, use_noise: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.epi1, self.epi2 = _epilogues(channels, style_dim, use_pixel_norm,
                                          use_instance_norm, use_noise, dtype)
        self.conv = Conv(channels, channels, 3, padding=1, dtype=dtype)

    def forward(self, x, style1, style2, generator: Optional[torch.Generator] = None):
        x = self.conv(self.epi1(x, style1, generator))
        return self.epi2(x, style2, generator)


class SGConstInputBlock(nn.Module):
    """A learned constant image [1, C, s, s] plus a per-channel bias (both start at 1),
    broadcast over the batch, through ``SGInputBlock``."""

    def __init__(self, channels: int, init_img_size: int, style_dim: int,
                 use_pixel_norm: bool = False, use_instance_norm: bool = True,
                 use_noise: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.init_img = nn.Parameter(torch.ones(1, channels, init_img_size, init_img_size))
        self.bias = nn.Parameter(torch.ones(channels))
        self.model = SGInputBlock(channels, style_dim, use_pixel_norm, use_instance_norm,
                                  use_noise, dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.init_img.fill_(1.0)
        self.bias.fill_(1.0)

    def forward(self, style1, style2, generator: Optional[torch.Generator] = None):
        x = self.init_img.expand(style1.shape[0], -1, -1, -1) + self.bias[:, None, None]
        return self.model(x, style1, style2, generator)


class SGToImgBlock(nn.Module):
    """1x1 conv to the image channels, kaiming(0.2) init."""

    def __init__(self, in_channels: int, img_channels: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.model = Conv(in_channels, img_channels, 1, dtype=dtype, init="kaiming")

    def forward(self, x):
        return self.model(x)


class SGFromImgBlock(nn.Module):
    """1x1 conv from the image channels, kaiming(0.2) init, then lrelu."""

    def __init__(self, img_channels: int, out_channels: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = Conv(img_channels, out_channels, 1, dtype=dtype, init="kaiming")

    def forward(self, x):
        return leaky_relu(self.conv(x))


class SGDecoderBlock(nn.Module):
    """2x upsample -> 3x3 conv -> blur -> epilogue -> 3x3 conv -> epilogue (kaiming convs)."""

    def __init__(self, in_channels: int, out_channels: int, style_dim: int,
                 use_pixel_norm: bool = False, use_instance_norm: bool = True,
                 use_noise: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = Conv(in_channels, out_channels, 3, padding=1, dtype=dtype, init="kaiming")
        self.conv2 = Conv(out_channels, out_channels, 3, padding=1, dtype=dtype, init="kaiming")
        self.epi1, self.epi2 = _epilogues(out_channels, style_dim, use_pixel_norm,
                                          use_instance_norm, use_noise, dtype)

    def forward(self, x, style1, style2, generator: Optional[torch.Generator] = None):
        x = self.epi1(blur3x3(self.conv1(upscale2d(x))), style1, generator)
        return self.epi2(self.conv2(x), style2, generator)


class SGEncoderBlock(nn.Module):
    """(3x3 conv, lrelu, style estimate) x 2, then 2x2 average pooling (kaiming convs);
    returns (x, style1, style2)."""

    def __init__(self, in_channels: int, out_channels1: int, out_channels2: int,
                 style_dim: int, pool: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = Conv(in_channels, out_channels1, 3, padding=1, dtype=dtype, init="kaiming")
        self.style_est1 = StyleEstimator(out_channels1, style_dim, dtype=dtype)
        self.conv2 = Conv(out_channels1, out_channels2, 3, padding=1, dtype=dtype,
                          init="kaiming")
        self.style_est2 = StyleEstimator(out_channels2, style_dim, dtype=dtype)
        self.pool = pool

    def forward(self, x):
        x = leaky_relu(self.conv1(x))
        style1 = self.style_est1(x)
        x = leaky_relu(self.conv2(x))
        style2 = self.style_est2(x)
        return (avg_pool2d(x) if self.pool else x), style1, style2


class SGDisBlock(nn.Module):
    """(3x3 conv, lrelu) x 2, then 2x2 average pooling (kaiming convs)."""

    def __init__(self, in_channels: int, out_channels1: int, out_channels2: int,
                 pool: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = Conv(in_channels, out_channels1, 3, padding=1, dtype=dtype, init="kaiming")
        self.conv2 = Conv(out_channels1, out_channels2, 3, padding=1, dtype=dtype,
                          init="kaiming")
        self.pool = pool

    def forward(self, x):
        x = leaky_relu(self.conv2(leaky_relu(self.conv1(x))))
        return avg_pool2d(x) if self.pool else x


class ResBlockDown(nn.Module):
    """SN residual down block: left 1x1 conv -> pool; right lrelu, conv, lrelu, conv, pool.

    The sum in f32: a norm or the attention reads it so (``models/image.py``)."""

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
        return res.float() + out.float()


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
                              dtype=dtype, f32_out=True)
        self.in2 = InstanceNorm(out_channels)
        self.conv_r2 = SNConv(out_channels, out_channels, conv_size, padding=padding,
                              dtype=dtype)

    def forward(self, x):
        """NCHW -> NCHW at twice the size; the sum in f32 (see below)."""
        res = self.conv_l1(upscale2d(x))
        out = leaky_relu(self.in1(x))
        out = self.conv_r1(upscale2d(out))
        out = self.conv_r2(leaky_relu(self.in2(out)))
        # The env decoder's first block takes a 1x1 input: its in1 sees one pixel
        # and gives its bias, so the right branch is the same for every sample,
        # and the skip branch, spatially constant, carries all of the noise.  The
        # next block's in1 subtracts that constant.  Rounded to bf16 first, the
        # sum keeps a rounding error that differs with every noise draw, which
        # the norm scales up to unit variance: bf16 games then trained to another
        # equilibrium (the hard-glyph head-to-head).  The convs that read the
        # sum round it to their compute dtype themselves.
        return out.float() + res.float()


class AdaResBlock2(nn.Module):
    """AdaIN residual block; style mapped by four linears to two (mean, std) pairs.

    The AdaINs read their convs' outputs in f32 (``SNConv(f32_out=True)``); the sum
    in f32 (the res stack rounds its loop carry)."""

    def __init__(self, channels: int, style_dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.lin1_mean = Dense(style_dim, channels, dtype=dtype)
        self.lin1_std = Dense(style_dim, channels, dtype=dtype)
        self.lin2_mean = Dense(style_dim, channels, dtype=dtype)
        self.lin2_std = Dense(style_dim, channels, dtype=dtype)
        self.conv1 = SNConv(channels, channels, 3, padding=1, dtype=dtype, f32_out=True)
        self.conv2 = SNConv(channels, channels, 3, padding=1, dtype=dtype, f32_out=True)

    def forward(self, x, style):
        res = x
        x = ada_in(self.conv1(x), self.lin1_mean(style), self.lin1_std(style))
        x = self.conv2(leaky_relu(x))
        x = ada_in(x, self.lin2_mean(style), self.lin2_std(style))
        return x.float() + res.float()


class AdaResBlockUp2(nn.Module):
    """AdaIN residual 2x up block.

    left: upsample -> 1x1 conv; right: AdaIN, lrelu, upsample, conv, AdaIN, lrelu, conv.
    The second AdaIN reads its conv in f32; the sum in f32 (tanh reads it rounded).
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
                              dtype=dtype, f32_out=True)
        self.conv_r2 = SNConv(out_channels, out_channels, conv_size, padding=padding,
                              dtype=dtype)

    def forward(self, x, style):
        res = self.conv_l1(upscale2d(x))
        out = leaky_relu(ada_in(x, self.lin1_mean(style), self.lin1_std(style)))
        out = self.conv_r1(upscale2d(out))
        out = self.conv_r2(leaky_relu(ada_in(out, self.lin2_mean(style), self.lin2_std(style))))
        return out.float() + res.float()


class AdaResBlock(nn.Module):
    """Legacy AdaIN residual block: conv, AdaIN, lrelu, conv, AdaIN, plus x.

    Each style is [B, 2C]: the AdaIN mean is ``style[:, :C]``, the std ``style[:, C:]``.
    """

    def __init__(self, channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = SNConv(channels, channels, 3, padding=1, dtype=dtype)
        self.conv2 = SNConv(channels, channels, 3, padding=1, dtype=dtype)
        self.channels = channels

    def forward(self, x, style1, style2):
        c = self.channels
        out = leaky_relu(ada_in(self.conv1(x), style1[:, :c], style1[:, c:]))
        return ada_in(self.conv2(out), style2[:, :c], style2[:, c:]) + x


class ResBlockD(nn.Module):
    """SN conv + instance norm residual block: conv, IN, lrelu, conv, IN, plus x."""

    def __init__(self, channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = SNConv(channels, channels, 3, padding=1, dtype=dtype)
        self.in1 = InstanceNorm(channels)
        self.conv2 = SNConv(channels, channels, 3, padding=1, dtype=dtype)
        self.in2 = InstanceNorm(channels)

    def forward(self, x):
        out = leaky_relu(self.in1(self.conv1(x)))
        return self.in2(self.conv2(out)) + x


class AdaResBlockUp(nn.Module):
    """Legacy AdaIN residual 2x up block; styles [B, 2 C_in] and [B, 2 C_out] (mean, std).

    left: 1x1 conv -> upsample (the reference's order); right: AdaIN, lrelu,
    upsample, conv, AdaIN, lrelu, conv.
    """

    def __init__(self, in_channels: int, out_channels: int, conv_size: int = 3,
                 padding: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv_l1 = SNConv(in_channels, out_channels, 1, padding=0, dtype=dtype)
        self.conv_r1 = SNConv(in_channels, out_channels, conv_size, padding=padding,
                              dtype=dtype)
        self.conv_r2 = SNConv(out_channels, out_channels, conv_size, padding=padding,
                              dtype=dtype)
        self.in_channels, self.out_channels = in_channels, out_channels

    def forward(self, x, style1, style2):
        ci, co = self.in_channels, self.out_channels
        res = upscale2d(self.conv_l1(x))
        out = leaky_relu(ada_in(x, style1[:, :ci], style1[:, ci:]))
        out = self.conv_r1(upscale2d(out))
        out = leaky_relu(ada_in(out, style2[:, :co], style2[:, co:]))
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
