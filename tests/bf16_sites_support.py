"""The port's side of the bf16 rounding sites: chains of the players' own submodules.

A site is a bf16 value that reaches a normalisation, the attention's residual,
tanh or a set statistic with no conv or matmul in between.  XLA's default
compile of the JAX step keeps some such values in f32 (``nn/blocks.py``); each
``Case`` names one, as a chain of the block that makes the value and the
consumer that reads it: the stages of the JAX package's modules (``stages``,
plain data) and a function that takes the same stages from the port's players
(``port``), with the same parameter names, so that the transplant maps one
onto the other.  Where the port's model rounds a block's f32 sum for its
consumer (``models/image.py:round_to``), the chain has a ``TRound`` stage
there.  ``bf16_sites_jax.py`` builds the JAX chains and reads both on the
CPU (``test_torch_bf16_sites.py``, ``scripts/torch_bf16_sites.py``);
``chip_smoke.py`` holds the port's chains on the card to the CPU.
``variants`` gives the forward hooks that round a site's value to bf16 or keep
it in f32.  Imports no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch import nn

from optimalstrategiesagainstgenerativeattacks_torch.models import image as tmodels
from optimalstrategiesagainstgenerativeattacks_torch.nn import blocks as tblocks
from optimalstrategiesagainstgenerativeattacks_torch.ops.adain import ada_in
from optimalstrategiesagainstgenerativeattacks_torch.ops.image_ops import (
    adaptive_max_pool,
    leaky_relu,
)

BF16 = torch.bfloat16
# sites where XLA's default compile keeps the value in f32, and so does the port
KEEPS_F32 = (
    "img2img down_1 -> in_1",             # 1: ResBlockDown's sum -> InstanceNorm
    "img2img up_0 -> up_1.ada_in",        # 2: AdaResBlockUp2's sum -> the next AdaIN
    "encoder down_1 -> att",              # 4: ResBlockDown's sum -> the attention's residual
    "env decoder up_2.conv_r1 -> in2",    # 5: conv + bias -> InstanceNorm
    "img2img res_0.conv1 -> ada_in",      # 5: conv + bias -> AdaIN
    "img2img up_0.conv_r1 -> ada_in",     # 5: conv + bias -> AdaIN
)
# sites where XLA rounds as the JAX code writes, and so does the port
ROUNDS = (
    "img2img in_1 -> att",                # a norm's output -> the attention's residual
    "img2img up_last -> tanh",            # the last up block's sum -> tanh
    "img2img res_0..4 -> up_0.ada_in",    # the res stack's loop carry -> AdaIN
    "encoder down_last -> max, lrelu, set stat",  # the last encoder block -> the set stat
)


# --- the port's chains (NCHW), stages taken from the port's players -----------------------

class TAdaIn(nn.Module):
    """``ada_in(x, lin_mean(style), lin_std(style))``, as the port's AdaIN blocks
    compute it, with a block's own two linears."""

    def __init__(self, lin_mean: nn.Module, lin_std: nn.Module):
        super().__init__()
        self.lin_mean, self.lin_std = lin_mean, lin_std

    def forward(self, x, style):
        return ada_in(x, self.lin_mean(style), self.lin_std(style))


class TStatStage(nn.Module):
    """The authenticator's set statistic over sets of ``set_size`` encodings."""

    def __init__(self, stat: nn.Module, set_size: int):
        super().__init__()
        self.stat, self.set_size = stat, set_size

    def forward(self, x):
        return self.stat(x.reshape(-1, self.set_size, x.shape[-1]))


class THead(nn.Module):
    """The encoders' end (``Encoder.forward``): global max pool, lrelu."""

    def forward(self, x):
        return leaky_relu(adaptive_max_pool(x))


class TRound(nn.Module):
    """``round_to``: a residual block's f32 sum in the compute dtype, where the
    port's model rounds it for its consumer."""

    def __init__(self, dtype):
        super().__init__()
        self.dtype = dtype

    def forward(self, x):
        return tmodels.round_to(x, self.dtype)


class TTanh(nn.Module):
    """``torch.tanh``, as ``Img2ImgAdaInUpModule`` ends."""

    def forward(self, x):
        return torch.tanh(x)


class TChain(nn.Module):
    """Stages ``s0``, ``s1``, ... applied in turn, as the JAX chain names them; a
    ``TRound`` after ``s<i>`` is ``s<i>_round``."""

    def __init__(self, stages: Sequence[nn.Module]):
        super().__init__()
        self.order, i = [], 0
        for m in stages:
            name = f"s{i - 1}_round" if isinstance(m, TRound) else f"s{i}"
            i += not isinstance(m, TRound)
            self.add_module(name, m)
            self.order.append(name)

    def forward(self, x, style=None):
        for name in self.order:
            m = getattr(self, name)
            styled = isinstance(m, (tblocks.AdaResBlockUp2, tmodels.Img2ImgAdaInResModule, TAdaIn))
            x = m(x, style) if styled else m(x)
        return x


# --- cases -------------------------------------------------------------------------------

@dataclasses.dataclass
class Config:
    """A player config's widths: the flagship, VoxCeleb, or the tests' small one."""
    name: str
    img_size: int
    img_channels: int
    style_dim: int
    batch: int = 2      # images (or episodes, for the set statistic) a chain runs on
    set_size: int = 5   # the authenticator's n = k

    def players(self, dtype=BF16):
        """The port's (im, au) in ``dtype``, as ``train.image.build_models`` makes them."""
        kw = dict(img_size=self.img_size, img_channels=self.img_channels,
                  style_dim=self.style_dim, dtype=dtype)
        return tmodels.get_im(**kw), tmodels.get_au(**kw)


FLAGSHIP = Config("flagship", 32, 1, 512)
VOX = Config("vox", 64, 3, 512)
SMALL = Config("small", 32, 1, 32)


@dataclasses.dataclass
class Case:
    """One site: the two chains, their inputs, and where the site's value is.

    ``producer`` is the port chain's stage whose output is the value.  How the
    value is kept in f32: ``f32_parts``, the submodules whose outputs, kept in
    f32, make it (the SN convs of a residual sum); ``value="conv"``, a conv's
    own output, run in f32 on its bf16-rounded operands; ``value="round"``,
    the producer is a ``TRound`` stage, which then passes its input on."""
    site: str
    name: str
    stages: tuple                     # JChain's stages
    port: Callable[[Any, Any], list]  # (im, au) -> the port chain's stages
    shape: tuple                      # the chain's input, NHWC
    producer: str = "s0"
    f32_parts: Sequence[str] = ()
    value: str = "sum"
    split: bool = False               # the chains take the input as two channel halves
    styled: bool = False
    episodes: bool = False            # the input is sets of one identity's images


def down_schedule(cfg: Config, channels: int):
    return tmodels.down_channel_schedule(cfg.img_size, channels, cfg.style_dim)


def up_schedule(cfg: Config):
    n_up = int(np.log2(cfg.img_size)) - 2
    min_c = int(max(tmodels.MIN_CHANNELS, cfg.style_dim / (2 ** (n_up - 1))))
    chans = list(reversed([min(cfg.style_dim, int(min_c * 2 ** i)) for i in range(n_up)]))
    return n_up, chans + [cfg.img_channels], int(np.ceil(n_up / 2))


def decoder_schedule(cfg: Config):
    n_up = int(np.log2(cfg.img_size))
    chans = list(reversed([min(cfg.style_dim, int(tmodels.MIN_CHANNELS * 2 ** i))
                           for i in range(n_up)])) + [cfg.img_channels]
    return n_up, [cfg.style_dim] + chans[1:], int(np.ceil(n_up / 2))


def cases(cfg: Config) -> list:
    """Every candidate site of the main path at ``cfg``'s widths."""
    b, s, out = cfg.batch, cfg.img_size, []
    # 1. the img2img down stage: ResBlockDown -> InstanceNorm (-> attention)
    n_down, ch, att = down_schedule(cfg, 2 * cfg.img_channels)
    for i in range(n_down):
        conv = dict(conv_size=9, padding=4) if i == 0 else {}
        hw = s >> i
        out.append(Case(
            "1", f"img2img down_{i} -> in_{i} [{b},{hw},{hw},{ch[i]}->{ch[i + 1]}]",
            (("down", tuple(dict(out_channels=ch[i + 1], **conv).items())), ("in", ())),
            lambda im, au, i=i: [getattr(im.img2img.down_block, f"down_{i}"),
                                 getattr(im.img2img.down_block, f"in_{i}"),
                                 TRound(im.img2img.down_block.dtype)],
            (b, hw, hw, ch[i]), f32_parts=("s0.conv_l1", "s0.conv_r2"), split=i == 0))
    i = att - 1
    hw = s >> i
    conv = dict(conv_size=9, padding=4) if i == 0 else {}
    out.append(Case(
        "1", f"img2img in_{i} -> att [{b},{hw // 2},{hw // 2},{ch[att]}]",
        (("down", tuple(dict(out_channels=ch[att], **conv).items())), ("in", ()), ("att", ())),
        lambda im, au, i=i: [getattr(im.img2img.down_block, f"down_{i}"),
                             getattr(im.img2img.down_block, f"in_{i}"),
                             TRound(im.img2img.down_block.dtype), im.img2img.down_block.att],
        (b, hw, hw, ch[i]), producer="s1_round", value="round",
        split=i == 0))
    # 2. the img2img up stage: AdaResBlockUp2 -> (attention ->) the next AdaIN, or tanh
    n_up, uch, uatt = up_schedule(cfg)
    hw = s >> n_up
    for i in range(n_up):
        last = i == n_up - 1
        conv = dict(conv_size=9, padding=4) if last else {}
        stages = [("adaup", tuple(dict(in_channels=uch[i], out_channels=uch[i + 1],
                                       **conv).items()))]
        if i + 1 == uatt:
            stages.append(("att", ()))
        stages.append(("tanh", ()) if last else ("ada", (("channels", uch[i + 1]),)))
        nxt = "tanh" if last else ("att -> " if i + 1 == uatt else "") + f"up_{i + 1}.ada_in"

        def port(im, au, i=i, last=last):
            up = im.img2img.adain_up_block
            st = [getattr(up, f"up_{i}")] + ([up.att] if i + 1 == uatt else [])
            if last:
                return st + [TRound(up.dtype), TTanh()]
            nb = getattr(up, f"up_{i + 1}")
            return st + [TAdaIn(nb.lin1_mean, nb.lin1_std)]
        label = "up_last" if last else f"up_{i}"  # the last block: at every config
        rounds = (dict(producer="s0_round", value="round") if last
                  else dict(f32_parts=("s0.conv_r2",)))
        out.append(Case("2", f"img2img {label} -> {nxt} [up_{i}: {b},{hw},{hw},"
                        f"{uch[i]}->{uch[i + 1]}]",
                        tuple(stages), port, (b, hw, hw, uch[i]), styled=True, **rounds))
        hw *= 2
    # 3. the AdaIN res stack -> the first up block's first AdaIN
    c, hw = cfg.style_dim, s >> n_up
    out.append(Case(
        "3", f"img2img res_0..4 -> up_0.ada_in [{b},{hw},{hw},{c}]",
        (("res", (("style_dim", c),)), ("ada", (("channels", c),))),
        lambda im, au: [im.img2img.adain_res_block,
                        TAdaIn(im.img2img.adain_up_block.up_0.lin1_mean,
                               im.img2img.adain_up_block.up_0.lin1_std)],
        (b, hw, hw, c), f32_parts=tuple(f"s0.res_{j}.conv2" for j in range(5)), styled=True))
    # 4. the encoders: the block before the attention, and the last block -> set statistic
    n_down, ch, att = down_schedule(cfg, cfg.img_channels)
    i = att - 1
    hw = s >> i
    out.append(Case(
        "4", f"encoder down_{i} -> att [{b},{hw},{hw},{ch[i]}->{ch[att]}]",
        (("down", (("out_channels", ch[att]),)), ("att", ())),
        lambda im, au, i=i: [getattr(au.encoders.env, f"down_{i}"), au.encoders.env.att],
        (b, hw, hw, ch[i]), f32_parts=("s0.conv_l1", "s0.conv_r2")))
    i = n_down - 1
    hw = s >> i
    out.append(Case(
        "4", f"encoder down_last -> max, lrelu, set stat [down_{i}: {b}x{cfg.set_size},{hw},"
        f"{hw},{ch[i]}->{ch[i + 1]}]",
        (("down", (("out_channels", ch[i + 1]),)), ("head", ()),
         ("stat", (("set_size", cfg.set_size),))),
        lambda im, au, i=i: [getattr(au.encoders.env, f"down_{i}"), TRound(au.encoders.env.dtype),
                             THead(), TStatStage(au.dis.stat, cfg.set_size)],
        (b * cfg.set_size, hw, hw, ch[i]), producer="s0_round", value="round",
        f32_parts=("s0.conv_l1", "s0.conv_r2"), episodes=True))
    # 5. SN convs whose output a norm reads: the env decoder's conv_r1 -> in2, the res
    #    blocks' conv1 -> AdaIN, the up blocks' conv_r1 -> AdaIN
    n_dec, dch, datt = decoder_schedule(cfg)
    for i in range(n_dec):
        hw = 1 << i
        out.append(Case(
            "5", f"env decoder up_{i}.conv_r1 -> in2 [{b},{hw},{hw},{dch[i]}->{dch[i + 1]} up2]",
            (("conv", (("features", dch[i + 1]), ("kernel_size", 3), ("padding", 1),
                       ("upscale", 2))), ("in", ())),
            lambda im, au, i=i: [getattr(im.env_decoder, f"up_{i}").conv_r1,
                                 getattr(im.env_decoder, f"up_{i}").in2],
            (b, hw, hw, dch[i]), value="conv"))
    hw = s >> n_up
    out.append(Case(
        "5", f"img2img res_0.conv1 -> ada_in [{b},{hw},{hw},{c}]",
        (("conv", (("features", c), ("kernel_size", 3), ("padding", 1))),
         ("ada", (("channels", c),))),
        lambda im, au: [im.img2img.adain_res_block.res_0.conv1,
                        TAdaIn(im.img2img.adain_res_block.res_0.lin1_mean,
                               im.img2img.adain_res_block.res_0.lin1_std)],
        (b, hw, hw, c), value="conv", styled=True))
    for i in range(n_up):
        last = i == n_up - 1
        k = 9 if last else 3
        out.append(Case(
            "5", f"img2img up_{i}.conv_r1 -> ada_in [{b},{hw},{hw},{uch[i]}->{uch[i + 1]} up2]",
            (("conv", (("features", uch[i + 1]), ("kernel_size", k), ("padding", k // 2),
                       ("upscale", 2))), ("ada", (("channels", uch[i + 1]),))),
            lambda im, au, i=i: [
                getattr(im.img2img.adain_up_block, f"up_{i}").conv_r1,
                TAdaIn(getattr(im.img2img.adain_up_block, f"up_{i}").lin2_mean,
                       getattr(im.img2img.adain_up_block, f"up_{i}").lin2_std)],
            (b, hw, hw, uch[i]), value="conv", styled=True))
        hw *= 2
    return out


def inputs(case: Case, cfg: Config, rng):
    if case.episodes:  # a set's members share most of their content
        b, hw, c = case.shape[0] // cfg.set_size, case.shape[1], case.shape[3]
        x = 2.0 * rng.standard_normal((b, 1, hw, hw, c)) + rng.standard_normal(
            (b, cfg.set_size, hw, hw, c))
        x = x.reshape(case.shape)
    else:
        x = rng.standard_normal(case.shape)
    xs = [x.astype(np.float32)]
    if case.styled:
        xs.append(rng.standard_normal((case.shape[0], cfg.style_dim)).astype(np.float32))
    return xs


def split(case: Case, xs: list) -> list:
    """The chain's arguments: with ``case.split``, the input as its two channel halves
    (the impersonator's ``split_gen_input`` pair)."""
    if not case.split:
        return list(xs)
    c = xs[0].shape[-1] // 2
    return [(xs[0][..., :c], xs[0][..., c:]), *xs[1:]]


def to_port(x: np.ndarray) -> torch.Tensor:
    if isinstance(x, tuple):
        return tuple(to_port(p) for p in x)
    t = torch.from_numpy(x)
    return t.permute(0, 3, 1, 2) if t.ndim == 4 else t


def from_port(t: torch.Tensor) -> np.ndarray:
    t = t.detach().float()
    return (t.permute(0, 2, 3, 1) if t.ndim == 4 else t).numpy()


def _f32_conv(module, args, out):
    """The conv (folded as the module folds it) on its bf16-rounded operands in f32, plus
    the rounded bias: its output unrounded."""
    x = args[0].to(BF16).float()
    w = module.folded_weight().to(BF16).float()
    y = tblocks.sn_conv(x, w, module.padding, module.mode)
    return y + module.bias.to(BF16).float()[:, None, None]


@contextlib.contextmanager
def hooks(module: nn.Module, pairs):
    handles = [module.get_submodule(name).register_forward_hook(fn) for name, fn in pairs]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def variants(case: Case) -> dict:
    """{reading: forward hooks on the port chain}."""
    if case.value == "conv":
        keep = [(case.producer, _f32_conv)]
    else:
        keep = [(name, lambda m, a, o: o.float()) for name in case.f32_parts]
        if case.value == "round":
            keep.append((case.producer, lambda m, a, o: a[0]))
    return {"port_rounded": [(case.producer, lambda m, a, o: o.to(BF16))], "port_f32": keep,
            "port": []}


def by_name(cfg: Config) -> dict:
    """``cases(cfg)`` by name, without the shapes."""
    return {case.name.split(" [")[0]: case for case in cases(cfg)}

