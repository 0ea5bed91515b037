"""The JAX side of the bf16 rounding sites, and the readings of both sides on the CPU.

For each site (``bf16_sites_support.py``: the block that makes a bf16 value
and the consumer that reads it) the JAX chain is built here from the JAX
package's modules; the port's from the submodules of the port's own players,
as ``get_im`` / ``get_au`` build them, so the roundings they choose are the
ones read.  Both get the same weights (instance norms and attention gammas
randomised as in ``test_torch_support``; with ``bias_scale``, every conv and
linear bias drawn at that scale, which makes the rounding of a value that
carries a large per-channel offset stand out after a norm).  Intermediates
are not read out: a value that becomes an output is materialised in bf16,
which can change the fusion being measured; each chain is compared at its
consumer's output, against the JAX chain in f32.  The readings (mean
absolute error):

  * ``jax_default``: the JAX chain in bf16 as XLA compiles it by default;
  * ``jax_as_written``: compiled with excess precision off, every rounding
    the JAX code writes kept;
  * ``port_rounded`` / ``port_f32``: the port with the site's value rounded
    to bf16 / kept in f32;
  * ``port``: the port as it runs.

Where XLA keeps the value in f32 (``xla_keeps_f32``), the default compile
tracks the port with the value in f32 and the as-written compile the port
with it rounded.  The init and the compiles run under ``jax.jit``.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import linen as fnn

from optimalstrategiesagainstgenerativeattacks_torch.port.transplant import load_flax
from optimalstrategiesagainstgenerativeattacks_tpu.models import image as jmodels
from optimalstrategiesagainstgenerativeattacks_tpu.nn import blocks as jblocks
from optimalstrategiesagainstgenerativeattacks_tpu.nn.stats import MeanStdFcStat as JStat
from optimalstrategiesagainstgenerativeattacks_tpu.ops.adain import ada_in as j_ada_in
from optimalstrategiesagainstgenerativeattacks_tpu.ops.image_ops import (
    adaptive_max_pool as j_max_pool,
    leaky_relu as j_lrelu,
)
from bf16_sites_support import (
    Case,
    Config,
    TChain,
    from_port,
    hooks,
    inputs,
    split,
    to_port,
    variants,
)
from test_torch_support import randomise_norms_and_gammas

BIAS_SCALE = 30.0  # the tests' biases: the rounding of an offset value dominates


# --- the JAX chains (NHWC) ----------------------------------------------------------------

class JAdaIn(fnn.Module):
    """A block's AdaIN of its input: the style mapped by two linears."""
    channels: int
    dtype: Any = None

    @fnn.compact
    def __call__(self, x, style):
        mean = jblocks.Dense(self.channels, dtype=self.dtype, name="lin_mean")(style)
        std = jblocks.Dense(self.channels, dtype=self.dtype, name="lin_std")(style)
        return j_ada_in(x, mean, std)


class JStatStage(fnn.Module):
    """The authenticator's set statistic over sets of ``set_size`` encodings."""
    set_size: int
    dtype: Any = None

    @fnn.compact
    def __call__(self, x):
        c = x.shape[-1]
        return JStat(style_dim=c, fc_n_stats=2, fc_hidden_layers=(2 * c, 3 * c, 2 * c),
                     dtype=self.dtype, name="stat")(x.reshape(-1, self.set_size, c))


def _jax_stage(kind: str, kw: dict, dtype, name: str):
    if kind == "down":
        return jblocks.ResBlockDown(dtype=dtype, name=name, **kw)
    if kind == "in":
        return jblocks.InstanceNorm(name=name)
    if kind == "att":
        return jblocks.SelfAttention(dtype=dtype, name=name)
    if kind == "adaup":
        return jblocks.AdaResBlockUp2(dtype=dtype, name=name, **kw)
    if kind == "res":
        return jmodels.Img2ImgAdaInResModule(dtype=dtype, name=name, **kw)
    if kind == "ada":
        return JAdaIn(dtype=dtype, name=name, **kw)
    if kind == "conv":
        return jblocks.SNConv(dtype=dtype, name=name, **kw)
    if kind == "stat":
        return JStatStage(dtype=dtype, name=name, **kw)
    if kind == "tanh":
        return jnp.tanh
    if kind == "head":  # the encoders' end: global max pool, lrelu
        return lambda x: j_lrelu(j_max_pool(x))
    raise KeyError(kind)


STYLED = ("adaup", "res", "ada")


class JChain(fnn.Module):
    """Stages ``s0``, ``s1``, ... applied in turn; ``(kind, kwargs)`` each."""
    stages: tuple
    dtype: Any = None

    @fnn.compact
    def __call__(self, x, style=None):
        for i, (kind, kw) in enumerate(self.stages):
            stage = _jax_stage(kind, dict(kw), self.dtype, f"s{i}")
            x = stage(x, style) if kind in STYLED else stage(x)
        return x


# --- readings -----------------------------------------------------------------------------

def _scaled_biases(params, rng, scale: float):
    """Every conv and linear bias drawn from N(0, scale^2)."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = _scaled_biases(v, rng, scale)
        elif k == "bias" and "kernel" in params:
            out[k] = (scale * rng.standard_normal(np.shape(v))).astype(np.float32)
        else:
            out[k] = v
    return out


def readings(case: Case, cfg: Config, players=None, seed: int = 0,
             bias_scale: float = BIAS_SCALE) -> dict:
    """{reading: mean absolute error at the consumer's output against the JAX chain in
    f32}, with ``"ref"``: the mean absolute value of that output."""
    rng = np.random.default_rng(seed)
    jargs = split(case, inputs(case, cfg, rng))
    j32, j16 = JChain(case.stages), JChain(case.stages, jnp.bfloat16)
    v = jax.jit(j32.init)(jax.random.PRNGKey(seed), *jargs)
    params = randomise_norms_and_gammas(jax.tree.map(np.asarray, v["params"]), rng)
    v = {"params": _scaled_biases(params, rng, bias_scale),
         "spectral": jax.tree.map(np.asarray, v["spectral"])}

    def compiled(module, **options):
        fn = jax.jit(lambda variables, *a: module.apply(variables, *a))
        return fn.lower(v, *jargs).compile(compiler_options=options or None)

    outs = {"ref": compiled(j32)(v, *jargs),
            "jax_default": compiled(j16)(v, *jargs),
            "jax_as_written": compiled(j16, xla_allow_excess_precision=False)(v, *jargs)}
    outs = {k: np.asarray(o).astype(np.float32) for k, o in outs.items()}
    im, au = players if players is not None else cfg.players()
    port = TChain(case.port(im, au))
    load_flax(port, v["params"], v["spectral"])
    targs = [to_port(x) for x in jargs]
    for name, pairs in variants(case).items():
        with torch.no_grad(), hooks(port, pairs):
            outs[name] = from_port(port(*targs))
    ref = outs.pop("ref")
    res = {k: float(np.abs(o - ref).mean()) for k, o in outs.items()}
    res["ref"] = float(np.abs(ref).mean())
    for jk in ("jax_default", "jax_as_written"):  # which port variant each compile tracks
        for pk in ("port_rounded", "port_f32", "port"):
            res[f"{pk} ~ {jk}"] = float(np.abs(outs[pk] - outs[jk]).mean())
    res["port rounds"] = bool(np.array_equal(outs["port"], outs["port_rounded"]))
    return res


def xla_keeps_f32(r: dict) -> bool:
    """The default compile tracks the port with the value in f32, and the as-written
    compile the port with it rounded: XLA skips the rounding the JAX code writes."""
    return (r["port_f32 ~ jax_default"] < r["port_rounded ~ jax_default"]
            and r["port_rounded ~ jax_as_written"] < r["port_f32 ~ jax_as_written"])
