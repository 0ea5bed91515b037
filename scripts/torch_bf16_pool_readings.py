#!/usr/bin/env python
"""The reference's pool of a bf16 input, the port's, and the bf16 R1 step's readings.

The reference pools with ``_window_view(x, w).mean(axis=(2, 4), dtype=x.dtype)``
(``…_tpu/ops/image_ops.py:avg_pool2d``): a bf16 input is summed in bf16, each
partial sum rounded.  The port's ``…_torch/ops/image_ops.py:avg_pool2d`` sums a
bf16 input as XLA's CPU compile does (``Bf16Pool``); ``F.avg_pool2d``, which the
port used before, sums in f32 and rounds once.  Four readings, CPU only (JAX and
the port):

``orders``  the share of pooled values equal to ``jax.jit`` of the reference's
            pool, bf16 inputs at the shapes of the flagship's and VoxCeleb's
            bf16 pools (batch 2), for each summation order of the window
            (row-major or column-major one by one, pairwise, ``F.avg_pool2d``'s
            f32 sum with one rounding); then the port's pool's output,
            gradient and R1's double backward (the gradient of <grad, v> with
            respect to the cotangent) against the reference's.
``r1``      ``tests/test_torch_train_step_bf16.py``'s statistic over batch
            seeds: each authenticator tensor's relative gradient error against
            the f32 reference step (the test's keys: not the env encoder, not
            ``att.conv_f.bias``) of the port's bf16 R1 step, of the reference's
            bf16 step as XLA compiles it by default and of it with
            ``xla_allow_excess_precision`` off (as written); per seed the mean,
            the max and its tensor, the test's two verdicts (mean within 1.5 x
            the default's, max within the larger of the two compiles' maxima)
            and the attention gammas' errors.  The port runs as it is and with
            ``F.avg_pool2d`` in every ``ResBlockDown`` ("f32_sum", the parent's
            arithmetic); ``--pool`` adds a run with ``F.avg_pool2d`` in the
            ``ResBlockDown`` names given (``au.encoders.src.down_0`` ...), or
            ``each`` one run for each of them alone.
``blocks``  ``tests/test_torch_folds.py``'s two "bf16 input" ``ResBlockDown``
            cases (seed 0): the share of the block's bf16 outputs equal to XLA's
            compile with the port's pool and with ``F.avg_pool2d``.
``bias``    how XLA's compile sums the gradient of a bf16 conv's bias (a
            reduce of a bf16 cotangent over B, H, W): the share equal to an f32
            sum rounded once (the port's) and to a row-major bf16 sum.

    python scripts/torch_bf16_pool_readings.py orders
    python scripts/torch_bf16_pool_readings.py r1 [--seeds 3 4 5 6 7 8] [--pool each]
    python scripts/torch_bf16_pool_readings.py blocks
    python scripts/torch_bf16_pool_readings.py bias
"""

import argparse
import dataclasses
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests"), os.path.join(REPO, "scripts")]
os.environ["JAX_PLATFORMS"] = "cpu"  # before jax is imported

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")  # wins over a platform plugin's own choice

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from chip_smoke import pool_and_grads  # noqa: E402
from optimalstrategiesagainstgenerativeattacks_torch.nn import blocks as tblocks  # noqa: E402
from optimalstrategiesagainstgenerativeattacks_torch.ops.image_ops import avg_pool2d  # noqa: E402
from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg  # noqa: E402
from optimalstrategiesagainstgenerativeattacks_tpu.ops.image_ops import (  # noqa: E402
    avg_pool2d as jax_pool,
)
from test_torch_support import torch_state_from, uint8_batch  # noqa: E402
from test_torch_train_step import _torch_grads  # noqa: E402
from test_torch_train_step_bf16 import r1_reference, reference_grads  # noqa: E402
from torch_bf16_pool import f32_sum_pool, pooled_by  # noqa: E402

torch.set_num_threads(1)

# NHWC inputs of the bf16 pools of a bf16 step, batch cut to 2: the encoders' and
# img2img's first two down blocks (each part of img2img's split input is pooled
# alone); VoxCeleb's last down block reads bf16 too.  The blocks behind the
# attention read its f32 sum.
POOL_SHAPES = {"flagship": [(2, 32, 32, 1), (2, 16, 16, 128)],
               "vox": [(2, 64, 64, 3), (2, 32, 32, 64), (2, 8, 8, 256)]}


# --- orders ---------------------------------------------------------------------------------

def _windows(x, window):
    """NCHW -> a [B, C, H/w, w, W/w, w] view of the non-overlapping windows."""
    h, w = x.shape[-2:]
    return x.unflatten(-1, (w // window, window)).unflatten(-3, (h // window, window))


def order_sums(x, w):
    """Each candidate order's pooled bf16 value of NCHW ``x``."""
    v = _windows(x, w)
    cells = [[v[:, :, :, i, :, j] for j in range(w)] for i in range(w)]

    def one_by_one(ts):
        s = ts[0]
        for t in ts[1:]:
            s = s + t
        return s

    def pairwise(ts):
        while len(ts) > 1:
            ts = [ts[k] + ts[k + 1] if k + 1 < len(ts) else ts[k] for k in range(0, len(ts), 2)]
        return ts[0]

    row_major = [cells[i][j] for i in range(w) for j in range(w)]
    col_major = [cells[i][j] for j in range(w) for i in range(w)]
    sums = {"row-major one by one": one_by_one(row_major),
            "column-major one by one": one_by_one(col_major),
            "pairwise": pairwise(row_major),
            "F.avg_pool2d's (f32, one rounding)": F.avg_pool2d(x, w) * (w * w)}
    return {k: s / (w * w) for k, s in sums.items()}


def nchw(a, dtype=torch.bfloat16):
    return torch.from_numpy(np.asarray(a, np.float32)).permute(0, 3, 1, 2).to(dtype)


def nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def orders():
    rng = np.random.default_rng(0)
    grad = jax.jit(lambda a, c: jax.vjp(jax_pool, a)[1](c)[0])
    double = jax.jit(jax.grad(lambda c, a, v: jnp.sum(
        (jax.vjp(jax_pool, a)[1](c)[0] * v).astype(jnp.float32))))
    for config, shapes in POOL_SHAPES.items():
        for shape in shapes:
            b, h, w, c = shape
            x = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
            ct = jnp.asarray(rng.standard_normal((b, h // 2, w // 2, c)), jnp.bfloat16)
            v = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
            want = np.asarray(jax.jit(jax_pool)(x), np.float32)
            shares = {k: np.mean(nhwc(s) == want) for k, s in order_sums(nchw(x), 2).items()}
            print(f"{config} {shape}: " + ", ".join(f"{k} {s:.4f}" for k, s in shares.items()))
            got = pool_and_grads(nchw(x).contiguous(memory_format=torch.channels_last),
                                 nchw(ct), nchw(v, torch.float32))
            wants = (want, grad(x, ct), double(ct, x, v))
            print("  the port's pool equal to the reference: " + ", ".join(
                f"{name} {np.mean(nhwc(a) == np.asarray(e, np.float32)):.4f}"
                for name, a, e in zip(("output", "gradient", "double backward"), got, wants)))


# --- blocks -------------------------------------------------------------------------------

def blocks():
    import test_torch_folds as folds

    for name in [n for n in folds.BF16_CASES if n.endswith("bf16 input")]:
        port = folds.equal_share(name)
        with pooled_by(f32_sum_pool):
            f32_sum = folds.equal_share(name)
        print(f"{name}: share of outputs equal to XLA's, the port's pool {port:.4f}, "
              f"F.avg_pool2d {f32_sum:.4f} (bound {folds.BF16_CASES[name][3]})")


# --- bias -----------------------------------------------------------------------------------

def bias():
    rng = np.random.default_rng(0)
    for shape in [(2, 8, 8, 16), (8, 16, 16, 64), (32, 32, 32, 64)]:
        ct = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
        x = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
        b = jnp.zeros(shape[-1], jnp.float32)
        c = torch.from_numpy(np.asarray(ct, np.float32)).to(torch.bfloat16).reshape(-1, shape[-1])
        once = c.float().sum(0).to(torch.bfloat16).float().numpy()
        s = c[0].clone()
        for row in c[1:]:
            s.add_(row)
        exact = c.double().sum(0).numpy()
        grad = jax.jit(jax.grad(lambda b_, x_, ct_: jnp.sum(
            (x_ + b_.astype(jnp.bfloat16)).astype(jnp.float32) * ct_.astype(jnp.float32))))
        for label, opts in (("default", None),
                            ("as written", {"xla_allow_excess_precision": False})):
            want = np.asarray(grad.lower(b, x, ct).compile(compiler_options=opts)(b, x, ct))
            print(f"bias gradient over {shape[:3]}, {label}: equal to an f32 sum rounded once "
                  f"{np.mean(once == want):.4f}, to a row-major bf16 sum "
                  f"{np.mean(s.float().numpy() == want):.4f}; relative error against the exact "
                  f"sum {np.linalg.norm(want - exact) / np.linalg.norm(exact):.4f} (f32 once: "
                  f"{np.linalg.norm(once - exact) / np.linalg.norm(exact):.4f})")


# --- r1 -------------------------------------------------------------------------------------

class SitePools:
    """``F.avg_pool2d`` inside the named ``ResBlockDown`` modules (all of them for
    ``None``), the port's pool elsewhere; ``blocks.avg_pool2d`` is this object's ``pool``
    while a step runs under ``attach``."""

    def __init__(self, names):
        self.names, self.current = names, None

    def pool(self, x, window=2):
        if self.names is None or self.current in self.names:
            return F.avg_pool2d(x, window)
        return avg_pool2d(x, window)

    def attach(self, state):
        hooks = []
        for name in down_blocks(state):
            player, path = name.split(".", 1)
            mod = getattr(state, player).get_submodule(path)
            hooks.append(mod.register_forward_pre_hook(
                lambda m, a, name=name: setattr(self, "current", name)))
            hooks.append(mod.register_forward_hook(
                lambda m, a, o: setattr(self, "current", None)))
        return hooks


def down_blocks(state):
    return [f"{p}.{n}" for p in ("au", "im")
            for n, m in getattr(state, p).named_modules() if isinstance(m, tblocks.ResBlockDown)]


def port_grads(cfg16, av, iv, batch, z, names):
    """The port's bf16 authenticator gradient, with ``F.avg_pool2d`` in the named blocks
    (``[]`` none, ``None`` all)."""
    tstate = torch_state_from(cfg16, av, iv)
    sites = SitePools(names)
    hooks = sites.attach(tstate)
    with pooled_by(sites.pool):
        try:
            timg.train_step(tstate, batch, z=torch.from_numpy(z.copy()))
        finally:
            for h in hooks:
                h.remove()
    return _torch_grads(tstate, "au")


def r1(seeds, pool):
    t0 = time.time()
    cfg, (av, iv), steps, z = r1_reference()
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    print(f"# three reference compiles in {time.time() - t0:.1f} s", flush=True)
    variants = {"port": [], "f32_sum": None}
    if pool == ["each"]:
        variants.update({f"f32_sum@{name}": [name]
                         for name in down_blocks(torch_state_from(cfg16, av, iv))})
    elif pool:
        variants["f32_sum@" + ",".join(pool)] = pool
    for seed in seeds:
        batch = uint8_batch(cfg, seed=seed)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        grads = {name: reference_grads(step(jstate, jbatch)[0])
                 for name, (jstate, step) in steps.items()}
        want = grads.pop("f32")
        keys = [k for k in want
                if not k.startswith("encoders.env.") and not k.endswith("att.conv_f.bias")]
        gammas = [k for k in keys if k.endswith("gamma")]

        def rel_errors(got):
            return {k: float(np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k]))
                    for k in keys}

        errs = {name: rel_errors(g) for name, g in grads.items()}
        for label, names in variants.items():
            errs[label] = rel_errors(port_grads(cfg16, av, iv, batch, z, names))
        ref_mean = np.mean(list(errs["default"].values()))
        ref_max = max(max(errs["default"].values()), max(errs["as_written"].values()))
        for label, e in errs.items():
            vals = np.array(list(e.values()))
            verdict = ""
            if label not in ("default", "as_written"):
                verdict = (f" mean {'ok' if vals.mean() <= 1.5 * ref_mean else 'FAIL'}"
                           f" ({vals.mean() / ref_mean:.3f} x default)"
                           f" max {'ok' if vals.max() <= ref_max else 'FAIL'}"
                           f" ({vals.max() / ref_max:.3f} x the compiles' larger max)")
            print(f"seed {seed} {label}: mean {vals.mean():.4f} max {vals.max():.4f} at "
                  f"{max(e, key=e.get)}{verdict} | "
                  + " ".join(f"{k}={e[k]:.4f}" for k in gammas), flush=True)
    print(f"# {time.time() - t0:.1f} s")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("reading", choices=["orders", "r1", "blocks", "bias"])
    ap.add_argument("--seeds", type=int, nargs="+", default=[3, 4, 5, 6, 7, 8], help="r1")
    ap.add_argument("--pool", nargs="+", default=[],
                    help="r1: each, or ResBlockDown names that take F.avg_pool2d")
    args = ap.parse_args(argv)
    if args.reading == "orders":
        orders()
    elif args.reading == "blocks":
        blocks()
    elif args.reading == "bias":
        bias()
    else:
        r1(args.seeds, args.pool)


if __name__ == "__main__":
    main()
