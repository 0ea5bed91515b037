"""Image GIM game models: encoders, decoders, impersonator, authenticator.

Counterpart of ``optimalstrategiesagainstgenerativeattacks_tpu/models/image.py``
with the same channel schedules and attention locations.  Episodic tensors
at the public methods are ``[B, S, H, W, C]`` as in the reference; the
per-image networks run on the flattened batch as NCHW tensors in
channels_last memory (a permuted view of the NHWC input, no copy).

The src/env encoder twins are two plain ``Encoder`` modules (``encoders.src``
and ``encoders.env``) rather than one module with stacked parameters, and the
five AdaIN res blocks are a plain loop (``res_0`` .. ``res_4``);
``port/transplant.py`` maps the reference's stacked layouts onto them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from optimalstrategiesagainstgenerativeattacks_torch.nn.blocks import (
    MLP,
    AdaResBlock2,
    AdaResBlockUp2,
    ImgAttention,
    InstanceNorm,
    ResBlockDown,
    ResBlockUp,
    SelfAttention,
    round_to,
)
from optimalstrategiesagainstgenerativeattacks_torch.nn.stats import MeanStdFcStat
from optimalstrategiesagainstgenerativeattacks_torch.ops.image_ops import (
    adaptive_max_pool,
    leaky_relu,
    to_nchw,
    to_nhwc,
)
from optimalstrategiesagainstgenerativeattacks_torch.utils.rng import normal


MIN_CHANNELS = 64  # narrowest conv stage of every encoder and decoder
N_ADAIN_RES_BLOCKS = 5


def down_channel_schedule(img_size: int, img_channels: int, style_dim: int):
    """(n_down_blocks, channel_sizes, att_loc) of the encoders and the img2img down stage."""
    n_down = int(math.log2(img_size)) - 2
    min_c = int(max(MIN_CHANNELS, style_dim / (2 ** (n_down - 1))))
    channels = [img_channels] + [min(style_dim, int(min_c * (2 ** i))) for i in range(n_down)]
    return n_down, channels, int(math.ceil(n_down / 2))


class Encoder(nn.Module):
    """SN ResBlockDown stack with midpoint self-attention -> [B, style] via global max pool."""

    def __init__(self, img_size: int, img_channels: int, style_dim: int = 512,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        n_down, channels, att_loc = down_channel_schedule(img_size, img_channels, style_dim)
        self.att_loc = att_loc
        self.n_down = n_down
        self.dtype = dtype
        for i in range(n_down):
            if i == att_loc:
                self.att = SelfAttention(channels[i], dtype=dtype)
            setattr(self, f"down_{i}", ResBlockDown(channels[i], channels[i + 1], dtype=dtype))

    def forward(self, x):
        """NCHW images -> [B', style]."""
        for i in range(self.n_down):
            if i == self.att_loc:
                x = self.att(x)
            x = getattr(self, f"down_{i}")(x)
            # the attention's residual add reads the sum in f32; the next block's lrelu
            # and the max pool read it rounded
            if i + 1 != self.att_loc:
                x = round_to(x, self.dtype)
        return leaky_relu(adaptive_max_pool(x))


class EncoderPair(nn.Module):
    """The src and env encoder twins applied to the same images."""

    def __init__(self, **encoder_kwargs):
        super().__init__()
        self.src = Encoder(**encoder_kwargs)
        self.env = Encoder(**encoder_kwargs)

    def forward(self, x):
        """NCHW images -> (src [B', style], env [B', style])."""
        return self.src(x), self.env(x)


class EnvDecoder(nn.Module):
    """ResBlockUp stack from [B, style] to an NCHW image."""

    def __init__(self, img_size: int, img_channels: int, style_dim: int = 512,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        n_up = int(math.log2(img_size))
        channels = list(
            reversed([min(style_dim, int(MIN_CHANNELS * (2 ** i))) for i in range(n_up)])
        ) + [img_channels]
        channels = [style_dim] + channels[1:]
        self.n_up = n_up
        self.att_loc = int(math.ceil(n_up / 2))
        for i in range(n_up):
            if i == self.att_loc:
                self.att = SelfAttention(channels[i], dtype=dtype)
            setattr(self, f"up_{i}", ResBlockUp(channels[i], channels[i + 1], dtype=dtype))

    def forward(self, x):
        x = x[:, :, None, None]  # [B, style, 1, 1]
        for i in range(self.n_up):
            if i == self.att_loc:
                x = self.att(x)
            x = getattr(self, f"up_{i}")(x)
        return x


class Img2ImgDownModule(nn.Module):
    """Down stage of the image translator: ResBlockDown (9x9 first) + InstanceNorm per stage.

    The input may be a tuple of channel parts, which the first block reads as such."""

    def __init__(self, img_size: int, img_channels: int, style_dim: int = 512,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        n_down, channels, att_loc = down_channel_schedule(img_size, img_channels, style_dim)
        self.n_down = n_down
        self.att_loc = att_loc
        self.dtype = dtype
        for i in range(n_down):
            if i == att_loc:
                self.att = SelfAttention(channels[i], dtype=dtype)
            conv = dict(conv_size=9, padding=4) if i == 0 else {}
            setattr(self, f"down_{i}",
                    ResBlockDown(channels[i], channels[i + 1], dtype=dtype, **conv))
            setattr(self, f"in_{i}", InstanceNorm(channels[i + 1]))

    def forward(self, x):
        for i in range(self.n_down):
            if i == self.att_loc:
                x = self.att(x)
            # each norm reads its block's sum in f32; its output is rounded
            x = round_to(getattr(self, f"in_{i}")(getattr(self, f"down_{i}")(x)), self.dtype)
        return x


class Img2ImgAdaInResModule(nn.Module):
    """``N_ADAIN_RES_BLOCKS`` AdaIN residual blocks at the style width, run in a loop."""

    def __init__(self, style_dim: int = 512, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        for i in range(N_ADAIN_RES_BLOCKS):
            setattr(self, f"res_{i}", AdaResBlock2(style_dim, style_dim, dtype=dtype))

    def forward(self, x, style):
        for i in range(N_ADAIN_RES_BLOCKS):
            # rounded, as the JAX res stack's loop carry is
            x = round_to(getattr(self, f"res_{i}")(x, style), self.dtype)
        return x


class Img2ImgAdaInUpModule(nn.Module):
    """AdaIN up stage with a 9x9 final conv and tanh."""

    def __init__(self, img_size: int, img_channels: int, style_dim: int = 512,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        n_up = int(math.log2(img_size)) - 2
        min_c = int(max(MIN_CHANNELS, style_dim / (2 ** (n_up - 1))))
        channels = list(
            reversed([min(style_dim, int(min_c * (2 ** i))) for i in range(n_up)])
        ) + [img_channels]
        self.n_up = n_up
        self.att_loc = int(math.ceil(n_up / 2))
        self.dtype = dtype
        for i in range(n_up):
            if i == self.att_loc:
                self.att = SelfAttention(channels[i], dtype=dtype)
            conv = dict(conv_size=9, padding=4) if i == n_up - 1 else {}
            setattr(self, f"up_{i}", AdaResBlockUp2(channels[i], channels[i + 1], style_dim,
                                                    dtype=dtype, **conv))

    def forward(self, x, style):
        # the next AdaIN (or the attention) reads each sum in f32; tanh reads it rounded
        for i in range(self.n_up):
            if i == self.att_loc:
                x = self.att(x)
            x = getattr(self, f"up_{i}")(x, style)
        return torch.tanh(round_to(x, self.dtype))


class AdaInImage2Image(nn.Module):
    """Down -> AdaIN res -> AdaIN up image translator; the input an NCHW image or a
    tuple of its channel parts."""

    def __init__(self, img_size: int, in_channels: int, out_channels: int, style_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.down_block = Img2ImgDownModule(img_size, in_channels, style_dim, dtype=dtype)
        self.adain_res_block = Img2ImgAdaInResModule(style_dim, dtype=dtype)
        self.adain_up_block = Img2ImgAdaInUpModule(img_size, out_channels, style_dim,
                                                   dtype=dtype)

    def forward(self, x, style):
        x = self.down_block(x)
        x = self.adain_res_block(x, style)
        return self.adain_up_block(x, style)


class GIMFaceDis(nn.Module):
    """Set-pooling discriminator head: src pooled by mean, env by the stat module."""

    def __init__(self, src_dim: int, env_dim: int, stat: nn.Module,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        s, e = src_dim, env_dim
        self.stat = stat
        self.mlp = MLP((2 * (stat.n_stats * e + s), e + s, 2 * (e + s), 1), dtype=dtype,
                       init="kaiming")

    def forward(self, test_src, test_env, si_src, si_env):
        """All inputs [B, S, dim]; returns the [B, 1] logit."""
        x = torch.cat([test_src.mean(dim=1), si_src.mean(dim=1), self.stat(test_env),
                       self.stat(si_env)], dim=-1)
        return self.mlp(x)


class GIMFaceAuthenticator(nn.Module):
    """src/env encoder pair + set discriminator."""

    def __init__(self, encoders: EncoderPair, dis: GIMFaceDis):
        super().__init__()
        self.encoders = encoders
        self.dis = dis

    def forward(self, test_sample, si_sample):
        """test [B, n, H, W, C], si [B, k, H, W, C] -> [B, 1] logit."""
        b, n, k = test_sample.shape[0], test_sample.shape[1], si_sample.shape[1]
        img_shape = test_sample.shape[2:]
        flat = torch.cat([test_sample.reshape(b * n, *img_shape),
                          si_sample.reshape(b * k, *img_shape)])
        src, env = self.encode_flat(flat)
        return self.discriminate(src[: b * n].reshape(b, n, -1), env[: b * n].reshape(b, n, -1),
                                 src[b * n:].reshape(b, k, -1), env[b * n:].reshape(b, k, -1))

    def encode_flat(self, flat_imgs):
        """One pass of both encoders over a flat [B', H, W, C] batch -> (src, env)."""
        return self.encoders(to_nchw(flat_imgs))

    def discriminate(self, test_src, test_env, si_src, si_env):
        return self.dis(test_src, test_env, si_src, si_env)


class GIMFaceImpersonator(nn.Module):
    """Conditional generator.

    forward([B, m, H, W, C], n) ->
      1. src/env = mean over m of the src/env encoders of the leaked images;
      2. w = env_noise_mapper(z), z ~ N(0, I) (or given), mean-centred over n;
      3. env_img = env_decoder(env + w), beside the first leaked image;
      4. fake = img2img((env_img, leaked image), style=src)  -> [B, n, H, W, C];
      5. with ``use_img_att``, fake = img_att(first leaked image, fake).

    img2img reads the pair as two channel parts, its first convs summing a conv
    of each with a slice of their kernels (the reference's default
    ``split_gen_input``); the parameters are those of a conv of their concat.

    ``img_att`` exists only with ``use_img_att`` (the JAX impersonator owns no
    such parameters otherwise).
    """

    def __init__(self, encoders: EncoderPair, env_decoder: EnvDecoder,
                 img2img: AdaInImage2Image, env_noise_mapper: MLP, style_dim: int,
                 img_channels: int, use_img_att: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.encoders = encoders
        self.env_decoder = env_decoder
        self.img2img = img2img
        self.env_noise_mapper = env_noise_mapper
        if use_img_att:
            self.img_att = ImgAttention(img_channels, dtype=dtype)
        self.use_img_att = use_img_att
        self.style_dim = style_dim
        self.img_channels = img_channels
        self.dtype = dtype

    def forward(self, leaked_sample, n: int, remove_noise_mean: bool = True,
                z: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        b, m, h, w, c = leaked_sample.shape
        compute_dtype = self.dtype or torch.float32
        expanded = leaked_sample[:, 0:1].expand(b, n, h, w, c).to(compute_dtype)

        src_e, env_e = self.encoders(to_nchw(leaked_sample.reshape(b * m, h, w, c)))
        src = src_e.reshape(b, m, -1).mean(dim=1)
        env = env_e.reshape(b, m, -1).mean(dim=1)

        if z is None:
            z = normal((b, n, self.style_dim), generator, leaked_sample.device, compute_dtype)
        noise = self.env_noise_mapper(z)
        if remove_noise_mean:
            noise = noise - noise.mean(dim=1, keepdim=True)
        noisy_env = env[:, None, :] + noise  # [B, n, style]

        env_img = self.env_decoder(noisy_env.reshape(b * n, self.style_dim))
        leaked_img = to_nchw(expanded.reshape(b * n, h, w, c))
        style = src[:, None, :].expand(b, n, self.style_dim).reshape(b * n, self.style_dim)
        fake = self.img2img((env_img, leaked_img), style)
        if self.use_img_att:
            fake = self.img_att(leaked_img, fake)
        fake = to_nhwc(fake)
        return fake.reshape(b, n, *fake.shape[1:])


def get_im(img_size: int, img_channels: int, style_dim: int, use_img_att: bool = False,
           num_env_noise_layers: int = 4, dtype: Optional[torch.dtype] = None
           ) -> GIMFaceImpersonator:
    """The image impersonator (``get_im`` of the reference)."""
    encoders = EncoderPair(img_size=img_size, img_channels=img_channels, style_dim=style_dim,
                           dtype=dtype)
    decoder = EnvDecoder(img_size, img_channels, style_dim, dtype=dtype)
    img2img = AdaInImage2Image(img_size, 2 * img_channels, img_channels, style_dim,
                               dtype=dtype)
    mapper = MLP([style_dim] * (num_env_noise_layers + 1), dtype=dtype)
    return GIMFaceImpersonator(encoders, decoder, img2img, mapper, style_dim, img_channels,
                               use_img_att=use_img_att, dtype=dtype)


def get_au(img_size: int, img_channels: int, style_dim: int,
           dtype: Optional[torch.dtype] = None) -> GIMFaceAuthenticator:
    """The image authenticator (``get_au`` of the reference)."""
    stat = MeanStdFcStat(style_dim, fc_n_stats=2,
                         fc_hidden_layers=(style_dim * 2, style_dim * 3, style_dim * 2),
                         dtype=dtype)
    dis = GIMFaceDis(style_dim, style_dim, stat, dtype=dtype)
    encoders = EncoderPair(img_size=img_size, img_channels=img_channels, style_dim=style_dim,
                           dtype=dtype)
    return GIMFaceAuthenticator(encoders, dis)
