"""Building blocks of the image game, NCHW (channels_last memory inside).

Counterpart of ``optimalstrategiesagainstgenerativeattacks_tpu/nn/blocks.py``:
the blocks of the image game's main path, and the reference's others (the
residual MLPs, the StyleGAN kit and the legacy AdaIN blocks, which no entry
path uses).  Submodule and parameter names follow the Flax names, so
``port/transplant.py`` maps one tree onto the other by rule.

Compute dtype policy (as in the reference): parameters stay f32; every conv
and linear casts its input and its (normalised) weight to ``dtype`` when one
is given, so a bf16 game runs bf16 convs and matmuls with f32 parameters and
f32 normalisation statistics.  No ``torch.autocast``.  The bias enters as in
the reference: a conv rounds its output to ``dtype`` and then adds the bias
rounded to ``dtype`` (a second rounding; an f32 conv adds its bias itself,
which gives the same output); ``Dense`` multiplies the rounded operands with
an f32 product, adds the f32 bias and rounds once.

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

``Dense``, ``Conv`` and ``SNConv`` can run sharded over the mesh's model
axis (``parallel/tensor.py``: ``model_axis`` set, the weight holding this
rank's output rows); unset, the forward is the one above.

The main-path blocks run in the reference's order, with its folds (exact
algebra): ``ResBlockDown`` pools before its 1x1 skip conv and folds the
trailing pool into a stride-2 conv (``SNConv(downscale=2)``, K' = (K * 1_2x2)
/ 4); ``ResBlockUp`` and ``AdaResBlockUp2`` run the 1x1 skip conv before the
upsample and fold the upsample into a transposed stride-2 conv
(``SNConv(upscale=2)``, K' = K * 1_2x2).  An ``SNConv`` given a tuple of
channel parts sums per-part convs over slices of its kernel, as the JAX
``SNConv`` does (the impersonator's image pair).  The folds change
the roundings of a bf16 game (a conv of other operands rounds elsewhere), so
with them the port's bf16 blocks round where XLA's compile of the JAX blocks
does (``tests/test_torch_folds.py``).  So does the bf16 LeakyReLU
(``ops/image_ops.py``), and a norm that reads a value the port holds in f32
gives its output in the compute dtype, as the reference's norm gives its
input's declared dtype (``round_to``).  The legacy blocks keep the order
they share with the reference.
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
from optimalstrategiesagainstgenerativeattacks_torch.ops.precision import widen
from optimalstrategiesagainstgenerativeattacks_torch.ops.spectral import (
    l2_normalize,
    power_iterate_,
    sigma,
    weight_matrix,
)
from optimalstrategiesagainstgenerativeattacks_torch.parallel import tensor
from optimalstrategiesagainstgenerativeattacks_torch.parallel.mesh import Axis


class Dense(nn.Module):
    """Linear layer, weight [out, in]; ``init`` is "torch" or "kaiming" (a=0.2, zero bias)."""

    model_axis: Optional[Axis] = None  # set: the weight holds this rank's output rows

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
        w, b, axis = self.weight, self.bias, self.model_axis
        if axis is not None:
            x, b = tensor.copy_to_model(x, axis), tensor.split_to_model(b, axis)
        if self.dtype is None:
            out = F.linear(x, w, b)
        else:
            # the rounded operands' product and the f32 bias in f32, rounded once (the
            # reference's f32-accumulating matmul); exact f32 products need TF32 off
            x, w = x.to(self.dtype).float(), w.to(self.dtype).float()
            out = F.linear(x, w, b.float()).to(self.dtype)
        return out if axis is None else tensor.gather_from_model(out, axis, -1)


class Conv(nn.Module):
    """Plain conv (no spectral norm), stride 1; ``init`` as ``Dense``'s."""

    model_axis: Optional[Axis] = None  # set: the weight holds this rank's output channels

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
        w, b, axis = self.weight, self.bias, self.model_axis
        if axis is not None:
            x, b = tensor.copy_to_model(x, axis), tensor.split_to_model(b, axis)
        if self.dtype is not None:
            x, w, b = x.to(self.dtype), w.to(self.dtype), b.to(self.dtype)
        out = conv2d(x, w, b, self.padding)
        return out if axis is None else tensor.gather_from_model(out, axis, 1)


class SNConv(nn.Module):
    """Spectrally normalised conv: weight / sigma(weight), bias not normalised.

    Buffers ``u`` [out] and ``v`` [in*kh*kw] hold the power-iteration state;
    ``power_iterate_`` advances them (once per player per step) and the
    forward uses sigma = u^T W v from the stored vectors.

    ``upscale=2``: the conv of the 2x nearest-upsampled input, given the
    input at its own size; ``downscale=2``: the conv followed by 2x2 average
    pooling.  Either folds into one conv (``fold_upscale2``,
    ``fold_downscale2``) whose kernel is made from W / sigma in f32 and cast
    to ``dtype`` once, as the reference does.  Parameters and buffers are
    those of the plain conv.

    The input may be a tuple of channel parts: the conv of their channel
    concat, as the sum of each part's conv with its slice of the kernel.

    ``f32_out``: for a conv whose output a norm reads.  The conv rounds to
    ``dtype`` and the bias (rounded to ``dtype``) is added in f32, so the norm
    reads the sum unrounded, as XLA compiles the JAX conv followed by a norm.

    Sharded (``model_axis``): u and v stay whole, sigma and the power
    iteration run over the row-sharded W (``ops/spectral.py``), the folds act
    on this rank's rows, and the f32 sum of ``f32_out`` is what is gathered.
    """

    model_axis: Optional[Axis] = None  # set: the weight holds this rank's output channels

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 padding: int = 0, dtype: Optional[torch.dtype] = None, eps: float = 1e-12,
                 f32_out: bool = False, upscale: int = 1, downscale: int = 1):
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
        self.mode = "up" if upscale == 2 else "down" if downscale == 2 else "plain"  # sn_conv's

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        torch_default_(self.weight, self.bias, generator)
        u0 = torch.randn(self.u.shape, generator=generator)
        self.u.copy_(l2_normalize(u0, self.eps))
        self.v.copy_(l2_normalize(weight_matrix(self.weight).t() @ self.u, self.eps))

    def power_iterate_(self) -> None:
        power_iterate_(self.weight, self.u, self.v, self.eps, self.model_axis)

    def folded_weight(self) -> torch.Tensor:
        """W / sigma, folded for ``upscale`` or ``downscale``, in f32."""
        w = self.weight / sigma(self.weight, self.u, self.v, self.model_axis)
        return FOLDS[self.mode](w)

    def forward(self, x):
        axis = self.model_axis
        parts = tuple(x) if isinstance(x, (tuple, list)) else (x,)
        w, b = self.folded_weight(), self.bias
        if axis is not None:
            parts = tuple(tensor.copy_to_model(p, axis) for p in parts)
            b = tensor.split_to_model(b, axis)
        if self.dtype is not None:
            parts, w, b = tuple(p.to(self.dtype) for p in parts), w.to(self.dtype), b.to(self.dtype)
        if self.dtype is None and len(parts) == 1:  # f32: the bias inside the conv
            out = sn_conv(parts[0], w, self.padding, self.mode, b)
        else:
            out, off = None, 0
            for p in parts:
                y = sn_conv(p, w[:, off:off + p.shape[1]], self.padding, self.mode)
                out = y if out is None else out + y
                off += p.shape[1]
            f32 = self.f32_out and self.dtype is not None
            out = out.float() + b.float()[:, None, None] if f32 else out + b[:, None, None]
        return out if axis is None else tensor.gather_from_model(out, axis, 1)


def fold_upscale2(w: torch.Tensor) -> torch.Tensor:
    """[O, I, k, k] -> [O, I, k + 1, k + 1], the sum of ``w``'s four 2x2 shifts: a conv of
    the 2x nearest-upsampled input with ``w`` is a conv of the 2x zero-dilated input with
    this one (the reference's ``_fold_kernel_for_upscale2``, its order of sums)."""
    wp = F.pad(w, (1, 1, 1, 1))
    return wp[..., :-1, :-1] + wp[..., 1:, :-1] + wp[..., :-1, 1:] + wp[..., 1:, 1:]


def fold_downscale2(w: torch.Tensor) -> torch.Tensor:
    """``fold_upscale2(w) / 4``: 2x2 average pooling of a conv with ``w`` is a stride-2
    conv with this one (the reference's ``_fold_kernel_for_downscale2``)."""
    return fold_upscale2(w) * 0.25


FOLDS = {"plain": lambda w: w, "up": fold_upscale2, "down": fold_downscale2}


def sn_conv(x, w, padding: int, mode: str = "plain", b=None):
    """An ``SNConv``'s conv of one input part with its (folded) kernel slice.

    "down": stride 2, padding ``padding`` on each side; for an even input size and a
    kernel of 2 * padding + 1 taps before the fold, this is the reference's stride-2
    conv padded (padding, k - padding).  "up": the conv of the 2x zero-dilated input
    padded by ``padding`` + 1, as a transposed conv with stride 2; the output is twice
    the input's size.  "plain": ``conv2d``.  A bias ``b`` is added inside the conv."""
    if mode == "up":
        k = w.shape[-1] - 1
        return F.conv_transpose2d(x, w.flip(-2, -1).transpose(0, 1), b, stride=2,
                                  padding=k - 1 - padding)
    if mode == "down":
        return F.conv2d(x, w, b, stride=2, padding=padding)
    return conv2d(x, w, b, padding)


def conv2d(x, w, b, padding: int):
    """``F.conv2d``, except that a bf16 conv rounds before its bias is added (the
    reference's order; in f32 the bias inside the conv gives the same output), and
    on the card a conv of one input and one output channel (``conv_one_channel``)."""
    if x.is_cuda and w.shape[:2] == (1, 1):
        return conv_one_channel(x, w, b, padding)
    if b is None or x.dtype != torch.bfloat16:
        return F.conv2d(x, w, b, padding=padding)
    return F.conv2d(x, w, None, padding=padding) + b[:, None, None]


def conv_one_channel(x, w, b, padding: int):
    """``F.conv2d`` of one input channel to one output channel, as im2col and a matmul,
    then the bias.

    cuDNN 9.22 (torch 2.11, cu128) on an H100 gets bf16 convs of one channel
    to one channel wrong: the flagship env decoder's last conv ([640, 1, 32,
    32] in, 3x3) comes out off by as much as the output's own size, and NaN
    once other convs have run.  The same sums through ``F.unfold`` and one
    matmul (cuBLAS) are right up to bf16 rounding, forward and backward.
    """
    k = w.shape[-1]
    h, wd = (x.shape[2] + 2 * padding - k + 1, x.shape[3] + 2 * padding - k + 1)
    cols = F.unfold(x, k, padding=padding)  # [B, k*k, h*wd]
    out = torch.matmul(w.reshape(1, -1), cols)
    if b is not None:
        out = out + b.reshape(1, 1, 1)
    return out.reshape(x.shape[0], 1, h, wd)


def round_to(x, dtype: Optional[torch.dtype]):
    """``x`` in the compute dtype (unchanged without one): where the reference's
    compile rounds a value that the port holds in f32."""
    return x if dtype is None else x.to(dtype)


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
    """SN residual down block: left 2x2 pool -> 1x1 conv; right lrelu, conv, lrelu, conv
    with the 2x2 pool folded in (``SNConv(downscale=2)``), the reference's order.

    ``x`` may be a tuple of channel parts: pooled and lrelu'd part by part, each
    conv reads the tuple.  The sum in f32: a norm or the attention reads it so
    (``models/image.py``)."""

    def __init__(self, in_channels: int, out_channels: int, conv_size: int = 3,
                 padding: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv_l1 = SNConv(in_channels, out_channels, 1, padding=0, dtype=dtype)
        self.conv_r1 = SNConv(in_channels, out_channels, conv_size, padding=padding,
                              dtype=dtype)
        self.conv_r2 = SNConv(out_channels, out_channels, conv_size, padding=padding,
                              dtype=dtype, downscale=2)

    def forward(self, x):
        parts = isinstance(x, (tuple, list))
        res = self.conv_l1(tuple(avg_pool2d(p) for p in x) if parts else avg_pool2d(x))
        out = self.conv_r1(tuple(leaky_relu(p) for p in x) if parts else leaky_relu(x))
        out = self.conv_r2(leaky_relu(out))
        return widen(res) + widen(out)


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
    """SN residual 2x up block with instance norm, the reference's order.

    left: 1x1 conv -> upsample; right: IN, lrelu, conv of the upsampled input
    (``SNConv(upscale=2)``), IN, lrelu, conv.  Each norm reads its input as the
    port holds it (in2 the conv's f32 sum) and gives its output in the compute
    dtype, as the reference's norm gives its input's dtype.
    """

    def __init__(self, in_channels: int, out_channels: int, conv_size: int = 3,
                 padding: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv_l1 = SNConv(in_channels, out_channels, 1, padding=0, dtype=dtype)
        self.in1 = InstanceNorm(in_channels)
        self.conv_r1 = SNConv(in_channels, out_channels, conv_size, padding=padding,
                              dtype=dtype, f32_out=True, upscale=2)
        self.in2 = InstanceNorm(out_channels)
        self.conv_r2 = SNConv(out_channels, out_channels, conv_size, padding=padding,
                              dtype=dtype)
        self.dtype = dtype

    def forward(self, x):
        """NCHW -> NCHW at twice the size; the sum in f32 (see below)."""
        res = upscale2d(self.conv_l1(x))
        out = self.conv_r1(leaky_relu(round_to(self.in1(x), self.dtype)))
        out = self.conv_r2(leaky_relu(round_to(self.in2(out), self.dtype)))
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

    The AdaINs read their convs' outputs in f32 (``SNConv(f32_out=True)``) and give
    theirs in the compute dtype; the sum in f32 (the res stack rounds its loop
    carry)."""

    def __init__(self, channels: int, style_dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.lin1_mean = Dense(style_dim, channels, dtype=dtype)
        self.lin1_std = Dense(style_dim, channels, dtype=dtype)
        self.lin2_mean = Dense(style_dim, channels, dtype=dtype)
        self.lin2_std = Dense(style_dim, channels, dtype=dtype)
        self.conv1 = SNConv(channels, channels, 3, padding=1, dtype=dtype, f32_out=True)
        self.conv2 = SNConv(channels, channels, 3, padding=1, dtype=dtype, f32_out=True)
        self.dtype = dtype

    def forward(self, x, style):
        res = x
        x = round_to(ada_in(self.conv1(x), self.lin1_mean(style), self.lin1_std(style)),
                     self.dtype)
        x = self.conv2(leaky_relu(x))
        x = round_to(ada_in(x, self.lin2_mean(style), self.lin2_std(style)), self.dtype)
        return x.float() + res.float()


class AdaResBlockUp2(nn.Module):
    """AdaIN residual 2x up block, the reference's order.

    left: 1x1 conv -> upsample; right: AdaIN, lrelu, conv of the upsampled input
    (``SNConv(upscale=2)``), AdaIN, lrelu, conv.  The second AdaIN reads its conv
    in f32; each gives its output in the compute dtype; the sum in f32 (tanh reads
    it rounded).
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
                              dtype=dtype, f32_out=True, upscale=2)
        self.conv_r2 = SNConv(out_channels, out_channels, conv_size, padding=padding,
                              dtype=dtype)
        self.dtype = dtype

    def forward(self, x, style):
        res = upscale2d(self.conv_l1(x))
        out = round_to(ada_in(x, self.lin1_mean(style), self.lin1_std(style)), self.dtype)
        out = self.conv_r1(leaky_relu(out))
        out = round_to(ada_in(out, self.lin2_mean(style), self.lin2_std(style)), self.dtype)
        out = self.conv_r2(leaky_relu(out))
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
