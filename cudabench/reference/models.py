"""Plain PyTorch reference of the GIM image game's players, in f32.

A frozen copy of the game's architecture, written from its equations with
stock ops only: no kernel, no fold, no rounding site.  It imports nothing of
the program.  Submodule and parameter names are the program's, so one set of
weights (``cudabench/weights.py``) loads into both.

Where the program folds an op into a conv, the reference keeps the plain
form: a residual down block convolves and then average-pools, an up block
upsamples (nearest) and then convolves, and the impersonator's image pair is
one channel concat.  The attention is SAGAN's: softmax over the source axis,
out[j] = sum_i P[i, j] h[i], then gamma * out + x.

``quant="fp8"`` rounds the operands of every conv, linear and attention
product to float8 e4m3 (a per-tensor scale of amax / 448, the gradient passed
straight through): the benchmark's control, the game computed one precision
below the bf16 that the configurations state.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

SLOPE = 0.2
SN_EPS = 1e-12
ADAIN_EPS = 1e-5
IN_EPS = 1e-5
STD_EPS = 1e-8
MIN_CHANNELS = 64
N_ADAIN_RES_BLOCKS = 5
FP8_MAX = 448.0


def lrelu(x):
    return F.leaky_relu(x, SLOPE)


def l2n(x):
    return x / (torch.linalg.vector_norm(x) + SN_EPS)


def fp8(x):
    """``x`` rounded to float8 e4m3 under a per-tensor scale; the gradient passes straight."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


def rounder(quant: Optional[str]):
    """The rounding of a product's operands."""
    if quant not in (None, "fp8"):
        raise ValueError(f"quant {quant!r}: None or 'fp8'")
    return fp8 if quant == "fp8" else (lambda x: x)


def conv2d(x, w, b, padding: int):
    """A stride-1 conv.  One input channel to one output channel runs as unfold and a
    matmul: cuDNN on an H100 has got such convs wrong."""
    if w.shape[:2] != (1, 1):
        return F.conv2d(x, w, b, padding=padding)
    k = w.shape[-1]
    h, wd = x.shape[2] + 2 * padding - k + 1, x.shape[3] + 2 * padding - k + 1
    out = torch.matmul(w.reshape(1, -1), F.unfold(x, k, padding=padding))
    return (out + b.reshape(1, 1, 1)).reshape(x.shape[0], 1, h, wd)


def pool2(x):
    return F.avg_pool2d(x, 2)


def up2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


class Dense(nn.Module):
    """Linear layer, weight [out, in]; ``init`` "uniform" (torch's default) or "kaiming"."""

    def __init__(self, n_in: int, n_out: int, quant=None, init: str = "uniform"):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in))
        self.bias = nn.Parameter(torch.empty(n_out))
        self.q = rounder(quant)
        self.init = init

    def forward(self, x):
        return F.linear(self.q(x), self.q(self.weight), self.bias)


class SNConv(nn.Module):
    """Conv with weight / sigma, sigma = u^T W v from the stored vectors, W the weight
    as [out, in * k * k]; ``power_iterate_`` advances u and v once."""

    init = "uniform"

    def __init__(self, c_in: int, c_out: int, k: int, padding: int, quant=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, k, k))
        self.bias = nn.Parameter(torch.empty(c_out))
        self.register_buffer("u", torch.empty(c_out))
        self.register_buffer("v", torch.empty(c_in * k * k))
        self.padding = padding
        self.q = rounder(quant)

    def matrix(self):
        return self.weight.reshape(self.weight.shape[0], -1)

    @torch.no_grad()
    def power_iterate_(self):
        w = self.matrix()
        self.v.copy_(l2n(w.t() @ self.u))
        self.u.copy_(l2n(w @ self.v))

    def forward(self, x):
        sigma = torch.dot(self.u, self.matrix() @ self.v)
        return conv2d(self.q(x), self.q(self.weight / sigma), self.bias, self.padding)


class InstanceNorm(nn.Module):
    """Biased variance, eps inside the root, per-channel affine."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def forward(self, x):
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
        y = (x - mean) / torch.sqrt(var + IN_EPS)
        return y * self.weight[:, None, None] + self.bias[:, None, None]


def ada_in(x, mean_s, std_s):
    """AdaIN: unbiased feature std, eps added to the std."""
    n = x.shape[2] * x.shape[3]
    mu = x.mean(dim=(2, 3), keepdim=True)
    sd = torch.sqrt((x - mu).square().sum(dim=(2, 3), keepdim=True) / max(n - 1, 1))
    return std_s[:, :, None, None] * (x - mu) / (sd + ADAIN_EPS) + mean_s[:, :, None, None]


class SelfAttention(nn.Module):
    """SAGAN self-attention with 1x1 SN convs f, g (C/8 channels) and h."""

    def __init__(self, c: int, quant=None):
        super().__init__()
        cq = max(c // 8, 1)
        self.conv_f = SNConv(c, cq, 1, 0, quant)
        self.conv_g = SNConv(c, cq, 1, 0, quant)
        self.conv_h = SNConv(c, c, 1, 0, quant)
        self.gamma = nn.Parameter(torch.empty(1))
        self.q = rounder(quant)

    def forward(self, x):
        b, c, h, w = x.shape

        def tokens(t):
            return nhwc(t).reshape(b, h * w, t.shape[1])

        f, g, v = tokens(self.conv_f(x)), tokens(self.conv_g(x)), tokens(self.conv_h(x))
        s = torch.bmm(self.q(f), self.q(g).transpose(1, 2))  # [B, i, j]
        out = torch.bmm(self.q(torch.softmax(s, dim=1)).transpose(1, 2), self.q(v))
        return self.gamma * nchw(out.reshape(b, h, w, c)) + x


class ResBlockDown(nn.Module):
    """left: 2x2 pool, 1x1 conv; right: lrelu, conv, lrelu, conv, 2x2 pool."""

    def __init__(self, c_in: int, c_out: int, k: int = 3, padding: int = 1, quant=None):
        super().__init__()
        self.conv_l1 = SNConv(c_in, c_out, 1, 0, quant)
        self.conv_r1 = SNConv(c_in, c_out, k, padding, quant)
        self.conv_r2 = SNConv(c_out, c_out, k, padding, quant)

    def forward(self, x):
        out = pool2(self.conv_r2(lrelu(self.conv_r1(lrelu(x)))))
        return self.conv_l1(pool2(x)) + out


class ResBlockUp(nn.Module):
    """left: 1x1 conv, 2x upsample; right: IN, lrelu, upsample, conv, IN, lrelu, conv."""

    def __init__(self, c_in: int, c_out: int, quant=None):
        super().__init__()
        self.conv_l1 = SNConv(c_in, c_out, 1, 0, quant)
        self.in1 = InstanceNorm(c_in)
        self.conv_r1 = SNConv(c_in, c_out, 3, 1, quant)
        self.in2 = InstanceNorm(c_out)
        self.conv_r2 = SNConv(c_out, c_out, 3, 1, quant)

    def forward(self, x):
        out = self.conv_r1(up2(lrelu(self.in1(x))))
        out = self.conv_r2(lrelu(self.in2(out)))
        return up2(self.conv_l1(x)) + out


class AdaResBlock2(nn.Module):
    """conv, AdaIN, lrelu, conv, AdaIN, plus x; each AdaIN's style from two linears."""

    def __init__(self, c: int, style_dim: int, quant=None):
        super().__init__()
        for name in ("lin1_mean", "lin1_std", "lin2_mean", "lin2_std"):
            setattr(self, name, Dense(style_dim, c, quant))
        self.conv1 = SNConv(c, c, 3, 1, quant)
        self.conv2 = SNConv(c, c, 3, 1, quant)

    def forward(self, x, style):
        out = ada_in(self.conv1(x), self.lin1_mean(style), self.lin1_std(style))
        out = ada_in(self.conv2(lrelu(out)), self.lin2_mean(style), self.lin2_std(style))
        return out + x


class AdaResBlockUp2(nn.Module):
    """left: 1x1 conv, upsample; right: AdaIN, lrelu, upsample, conv, AdaIN, lrelu, conv."""

    def __init__(self, c_in: int, c_out: int, style_dim: int, k: int = 3, padding: int = 1,
                 quant=None):
        super().__init__()
        self.lin1_mean = Dense(style_dim, c_in, quant)
        self.lin1_std = Dense(style_dim, c_in, quant)
        self.lin2_mean = Dense(style_dim, c_out, quant)
        self.lin2_std = Dense(style_dim, c_out, quant)
        self.conv_l1 = SNConv(c_in, c_out, 1, 0, quant)
        self.conv_r1 = SNConv(c_in, c_out, k, padding, quant)
        self.conv_r2 = SNConv(c_out, c_out, k, padding, quant)

    def forward(self, x, style):
        out = ada_in(x, self.lin1_mean(style), self.lin1_std(style))
        out = self.conv_r1(up2(lrelu(out)))
        out = ada_in(out, self.lin2_mean(style), self.lin2_std(style))
        out = self.conv_r2(lrelu(out))
        return up2(self.conv_l1(x)) + out


class MLP(nn.Module):
    """Linear + lrelu stack with a linear head; ``dims`` includes the input."""

    def __init__(self, dims, quant=None, init: str = "uniform"):
        super().__init__()
        self.layers = nn.ModuleList(Dense(i, o, quant, init) for i, o in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = lrelu(layer(x))
        return self.layers[-1](x)


def down_schedule(img_size: int, img_channels: int, style_dim: int):
    """(blocks, channels, attention index) of an encoder or the img2img down stage."""
    n = int(math.log2(img_size)) - 2
    min_c = int(max(MIN_CHANNELS, style_dim / (2 ** (n - 1))))
    return n, [img_channels] + [min(style_dim, int(min_c * 2 ** i)) for i in range(n)], \
        int(math.ceil(n / 2))


class Encoder(nn.Module):
    """Down blocks with self-attention at the middle, global max pool, lrelu."""

    def __init__(self, img_size: int, img_channels: int, style_dim: int, quant=None):
        super().__init__()
        self.n, channels, self.att_loc = down_schedule(img_size, img_channels, style_dim)
        for i in range(self.n):
            if i == self.att_loc:
                self.att = SelfAttention(channels[i], quant)
            setattr(self, f"down_{i}", ResBlockDown(channels[i], channels[i + 1], quant=quant))

    def forward(self, x):
        for i in range(self.n):
            if i == self.att_loc:
                x = self.att(x)
            x = getattr(self, f"down_{i}")(x)
        return lrelu(x.amax(dim=(2, 3)))


class EncoderPair(nn.Module):
    def __init__(self, **kw):
        super().__init__()
        self.src = Encoder(**kw)
        self.env = Encoder(**kw)

    def forward(self, x):
        return self.src(x), self.env(x)


class EnvDecoder(nn.Module):
    """[B, style] -> image: up blocks from 1x1, attention at the middle."""

    def __init__(self, img_size: int, img_channels: int, style_dim: int, quant=None):
        super().__init__()
        self.n = int(math.log2(img_size))
        channels = [style_dim] + list(reversed(
            [min(style_dim, MIN_CHANNELS * 2 ** i) for i in range(self.n)]))[1:] + [img_channels]
        self.att_loc = int(math.ceil(self.n / 2))
        for i in range(self.n):
            if i == self.att_loc:
                self.att = SelfAttention(channels[i], quant)
            setattr(self, f"up_{i}", ResBlockUp(channels[i], channels[i + 1], quant))

    def forward(self, x):
        x = x[:, :, None, None]
        for i in range(self.n):
            if i == self.att_loc:
                x = self.att(x)
            x = getattr(self, f"up_{i}")(x)
        return x


class Img2ImgDownModule(nn.Module):
    def __init__(self, img_size: int, c_in: int, style_dim: int, quant=None):
        super().__init__()
        self.n, channels, self.att_loc = down_schedule(img_size, c_in, style_dim)
        for i in range(self.n):
            if i == self.att_loc:
                self.att = SelfAttention(channels[i], quant)
            k, p = (9, 4) if i == 0 else (3, 1)
            setattr(self, f"down_{i}", ResBlockDown(channels[i], channels[i + 1], k, p, quant))
            setattr(self, f"in_{i}", InstanceNorm(channels[i + 1]))

    def forward(self, x):
        for i in range(self.n):
            if i == self.att_loc:
                x = self.att(x)
            x = getattr(self, f"in_{i}")(getattr(self, f"down_{i}")(x))
        return x


class Img2ImgAdaInResModule(nn.Module):
    def __init__(self, style_dim: int, quant=None):
        super().__init__()
        for i in range(N_ADAIN_RES_BLOCKS):
            setattr(self, f"res_{i}", AdaResBlock2(style_dim, style_dim, quant))

    def forward(self, x, style):
        for i in range(N_ADAIN_RES_BLOCKS):
            x = getattr(self, f"res_{i}")(x, style)
        return x


class Img2ImgAdaInUpModule(nn.Module):
    def __init__(self, img_size: int, c_out: int, style_dim: int, quant=None):
        super().__init__()
        self.n = int(math.log2(img_size)) - 2
        min_c = int(max(MIN_CHANNELS, style_dim / (2 ** (self.n - 1))))
        channels = list(reversed([min(style_dim, int(min_c * 2 ** i))
                                  for i in range(self.n)])) + [c_out]
        self.att_loc = int(math.ceil(self.n / 2))
        for i in range(self.n):
            if i == self.att_loc:
                self.att = SelfAttention(channels[i], quant)
            k, p = (9, 4) if i == self.n - 1 else (3, 1)
            setattr(self, f"up_{i}",
                    AdaResBlockUp2(channels[i], channels[i + 1], style_dim, k, p, quant))

    def forward(self, x, style):
        for i in range(self.n):
            if i == self.att_loc:
                x = self.att(x)
            x = getattr(self, f"up_{i}")(x, style)
        return torch.tanh(x)


class AdaInImage2Image(nn.Module):
    def __init__(self, img_size: int, c_in: int, c_out: int, style_dim: int, quant=None):
        super().__init__()
        self.down_block = Img2ImgDownModule(img_size, c_in, style_dim, quant)
        self.adain_res_block = Img2ImgAdaInResModule(style_dim, quant)
        self.adain_up_block = Img2ImgAdaInUpModule(img_size, c_out, style_dim, quant)

    def forward(self, x, style):
        return self.adain_up_block(self.adain_res_block(self.down_block(x), style), style)


def custom_std(x):
    """sqrt(unbiased variance + eps) over the set axis 1."""
    c = x - x.mean(dim=1, keepdim=True)
    return torch.sqrt(c.square().sum(dim=1) / (x.shape[1] - 1) + STD_EPS)


class FCStat(nn.Module):
    def __init__(self, style_dim: int, n_stats: int, hidden, quant=None):
        super().__init__()
        self.stat = MLP([style_dim, *hidden, n_stats * style_dim], quant)

    def forward(self, x):
        return self.stat(x).mean(dim=1)


class MeanStdFcStat(nn.Module):
    """mean ++ std ++ mean of a per-element MLP, over the set axis."""

    def __init__(self, style_dim: int, fc_n_stats: int, hidden, quant=None):
        super().__init__()
        self.n_stats = 2 + fc_n_stats
        self.fc = FCStat(style_dim, fc_n_stats, hidden, quant)

    def forward(self, x):
        return torch.cat([x.mean(dim=1), custom_std(x), self.fc(x)], dim=-1)


class GIMFaceDis(nn.Module):
    def __init__(self, style_dim: int, quant=None):
        super().__init__()
        s = style_dim
        self.stat = MeanStdFcStat(s, 2, (2 * s, 3 * s, 2 * s), quant)
        self.mlp = MLP((2 * (self.stat.n_stats * s + s), 2 * s, 4 * s, 1), quant, init="kaiming")

    def forward(self, test_src, test_env, si_src, si_env):
        return self.mlp(torch.cat([test_src.mean(dim=1), si_src.mean(dim=1),
                                   self.stat(test_env), self.stat(si_env)], dim=-1))


class Authenticator(nn.Module):
    def __init__(self, img_size: int, img_channels: int, style_dim: int, quant=None):
        super().__init__()
        self.encoders = EncoderPair(img_size=img_size, img_channels=img_channels,
                                    style_dim=style_dim, quant=quant)
        self.dis = GIMFaceDis(style_dim, quant)

    def encode(self, flat):
        """[B', H, W, C] -> (src, env) [B', style]."""
        return self.encoders(nchw(flat))

    def forward(self, test, si):
        """test [B, n, H, W, C], si [B, k, H, W, C] -> [B, 1] logits."""
        b, n, k = test.shape[0], test.shape[1], si.shape[1]
        src, env = self.encode(torch.cat([test.reshape(b * n, *test.shape[2:]),
                                          si.reshape(b * k, *si.shape[2:])]))
        return self.dis(src[:b * n].reshape(b, n, -1), env[:b * n].reshape(b, n, -1),
                        src[b * n:].reshape(b, k, -1), env[b * n:].reshape(b, k, -1))


class Impersonator(nn.Module):
    """leaked [B, m, H, W, C] and noise z [B, n, style] -> fakes [B, n, H, W, C]."""

    def __init__(self, img_size: int, img_channels: int, style_dim: int,
                 num_env_noise_layers: int, quant=None):
        super().__init__()
        self.encoders = EncoderPair(img_size=img_size, img_channels=img_channels,
                                    style_dim=style_dim, quant=quant)
        self.env_decoder = EnvDecoder(img_size, img_channels, style_dim, quant)
        self.img2img = AdaInImage2Image(img_size, 2 * img_channels, img_channels, style_dim,
                                        quant)
        self.env_noise_mapper = MLP([style_dim] * (num_env_noise_layers + 1), quant)
        self.style_dim = style_dim

    def forward(self, leaked, z, remove_noise_mean: bool = True):
        b, m, h, w, c = leaked.shape
        n = z.shape[1]
        src, env = self.encoders(nchw(leaked.reshape(b * m, h, w, c)))
        src, env = src.reshape(b, m, -1).mean(dim=1), env.reshape(b, m, -1).mean(dim=1)
        noise = self.env_noise_mapper(z)
        if remove_noise_mean:
            noise = noise - noise.mean(dim=1, keepdim=True)
        env_img = self.env_decoder((env[:, None, :] + noise).reshape(b * n, self.style_dim))
        first = nchw(leaked[:, 0:1].expand(b, n, h, w, c).reshape(b * n, h, w, c))
        style = src[:, None, :].expand(b, n, self.style_dim).reshape(b * n, self.style_dim)
        fake = self.img2img(torch.cat([env_img, first], dim=1), style)
        return nhwc(fake).reshape(b, n, h, w, c)


def players(game: dict, quant=None):
    """(authenticator, impersonator) of a configuration's ``game`` fields, parameters
    unset."""
    if game.get("use_img_att"):
        raise ValueError("the reference has no image attention (use_img_att)")
    size, ch, style = game["img_size"], game["img_channels"], game["style_dim"]
    return (Authenticator(size, ch, style, quant),
            Impersonator(size, ch, style, game["num_env_noise_layers"], quant))
