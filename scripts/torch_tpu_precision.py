"""A TPU's default f32 product precision for the port: bf16 operands, f32 sums.

    python scripts/torch_tpu_precision.py count [--device cuda|cpu] [--style_dim 512]
        [--batch_size 128] [--compute_dtype bfloat16] [--seed 1]
    python scripts/torch_tpu_precision.py run -m <module> [the module's arguments]

The JAX package sets no matmul precision, so XLA compiles its f32 dots and convs at
DEFAULT precision, which on a TPU multiplies bf16 operands and sums in f32.  The
port multiplies f32 operands exactly (TF32 off, ``ops/precision.py:exact_f32``),
as the reference's CPU compile does.  ``TPUDefaultPrecision`` is a dispatch mode
that computes the port's f32 products the TPU's way: on ``PRODUCTS`` with f32
operands it rounds the operands of the product to bf16 and back, then computes.
What a product adds to, the bias of a conv or the ``self`` of ``addmm``, stays f32,
as XLA adds it after the dot; a conv's bias gradient is the exact f32 sum of the
output gradient, as XLA's is a reduce.  bf16 and f64 ops pass through.  Products
the mode cannot see: those inside the port's kernels (the attention core K2 on the
card multiplies its own operands: bf16 in a bf16 game, so the TPU's already), and
outer products that PyTorch's backward forms as an elementwise ``mul`` (the
power iteration's sigma).

``count``: one train step of the flagship game (``ImageGameConfig``'s defaults at
``--style_dim`` and ``--batch_size``) under the mode, printing how many products
it rounded, by op, forward or backward, and the port's caller: the first frame of
the port's package on the stack, or, for an op that autograd's engine runs, the
first such frame of the forward that recorded its node (anomaly mode's trace).

``run``: ``python -m <module> ...`` under the mode, e.g. the image CLI
(``scripts/torch_hard_head_to_head.py --tpu_precision`` starts it so).
"""

from __future__ import annotations

import argparse
import collections
import re
import runpy
import sys
import traceback
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

REPO = Path(__file__).resolve().parents[1]
PACKAGE = "optimalstrategiesagainstgenerativeattacks_torch"
FRAME = re.compile(r'File "([^"]+)", line (\d+), in (\S+)')  # a formatted stack's frames
aten = torch.ops.aten
# each product op: the positions of its product's operands
PRODUCTS = {
    aten.mm.default: (0, 1),
    aten.addmm.default: (1, 2),
    aten.bmm.default: (0, 1),
    aten.baddbmm.default: (1, 2),
    aten.mv.default: (0, 1),
    aten.addmv.default: (1, 2),
    aten.dot.default: (0, 1),
    aten.convolution.default: (0, 1),
    aten.convolution_backward.default: (0, 1, 2),
}


def to_bf16_and_back(x):
    return x.to(torch.bfloat16).to(torch.float32)


def rounded_args(func, args) -> list:
    """``args`` with the product's f32 operands rounded to bf16 and back."""
    args = list(args)
    for i in PRODUCTS[func]:
        args[i] = to_bf16_and_back(args[i])
    return args


def conv_backward(args: list):
    """``convolution_backward`` on rounded operands; the bias gradient the exact sum
    of the unrounded output gradient (a reduce in XLA, no product)."""
    grad_out = args[0]
    mask = list(args[10])
    rounded = rounded_args(aten.convolution_backward.default, args)
    rounded[10] = [mask[0], mask[1], False]
    grad_in, grad_w, _ = aten.convolution_backward.default(*rounded)
    grad_b = (grad_out.sum([d for d in range(grad_out.dim()) if d != 1]) if mask[2]
              else None)
    return grad_in, grad_w, grad_b


def is_f32(func, args) -> bool:
    return all(isinstance(args[i], torch.Tensor) and args[i].dtype == torch.float32
               for i in PRODUCTS[func])


class TPUDefaultPrecision(TorchDispatchMode):
    """Round the operands of every f32 product to bf16 (see the module's docstring).
    ``counts``, when given a Counter, gathers (op, phase, caller) of each rounded
    call."""

    def __init__(self, counts=None):
        super().__init__()
        self.counts = counts

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in PRODUCTS or not is_f32(func, args):
            return func(*args, **kwargs)
        if self.counts is not None:
            self.counts[(func.overloadpacket.__name__,) + caller()] += 1
        if func is aten.convolution_backward.default:
            return conv_backward(list(args))
        return func(*rounded_args(func, args), **kwargs)


def port_frame(frames) -> str:
    """``file:line function`` of the innermost frame in the port's package, or ""."""
    for f in reversed(frames):
        if f"/{PACKAGE}/" in f.filename:
            return f"{f.filename.split(f'/{PACKAGE}/')[-1]}:{f.lineno} {f.name}"
    return ""


def caller() -> tuple:
    """(phase, the port's caller) of the op being dispatched."""
    node = torch._C._current_autograd_node()
    if node is None:
        return "forward", port_frame(traceback.extract_stack()) or "?"
    # inside a backward: a Python backward's own frame, else the forward's trace
    if isinstance(node, torch.autograd.function.BackwardCFunction):
        return "backward", port_frame(traceback.extract_stack()) or "?"
    frames = [traceback.FrameSummary(path, int(line), name) for path, line, name in
              FRAME.findall("".join(node.metadata.get("traceback_", [])))]
    return "backward", f"{port_frame(frames) or '?'} ({node.name()})"


def count(args) -> collections.Counter:
    """One flagship train step under the mode; print and return its rounded calls."""
    import numpy as np

    from optimalstrategiesagainstgenerativeattacks_torch.ops.precision import exact_f32
    from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg
    from optimalstrategiesagainstgenerativeattacks_torch.utils.config import ImageGameConfig

    exact_f32()
    cfg = ImageGameConfig(style_dim=args.style_dim, batch_size=args.batch_size,
                          compute_dtype=args.compute_dtype, seed=args.seed)
    au, im = timg.build_models(cfg)
    state = timg.create_state(cfg, au, im, args.seed, args.device)
    rng = np.random.default_rng(args.seed)
    batch = {k: rng.integers(0, 256, (cfg.batch_size, n, cfg.img_size, cfg.img_size,
                                      cfg.img_channels), dtype=np.uint8)
             for k, n in (("real_sample", cfg.n), ("leaked_sample", cfg.m),
                          ("si_sample", cfg.k))}
    timg.train_step(state, batch)  # the warm-up: the kernels' builds stay outside the count
    counts = collections.Counter()
    with torch.autograd.set_detect_anomaly(True, check_nan=False), \
            TPUDefaultPrecision(counts):
        metrics, _ = timg.train_step(state, batch)
    print(f"one {cfg.compute_dtype} flagship step (style {cfg.style_dim}, B {cfg.batch_size}, "
          f"{args.device}; au_loss {float(metrics['au_loss']):.4f}): {sum(counts.values())} "
          f"f32 products rounded")
    by_op = collections.Counter()
    for (op, phase, _), n in counts.items():
        by_op[(op, phase)] += n
    for (op, phase), n in sorted(by_op.items()):
        print(f"  {op} {phase}: {n}")
    for (op, phase, where), n in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0])):
        print(f"  {n:5d}  {op:22s} {phase:8s} {where}")
    return counts


def run(module: str, argv: list) -> None:
    """``python -m module argv...`` under the mode."""
    sys.argv = [module] + argv
    with TPUDefaultPrecision():
        runpy.run_module(module, run_name="__main__", alter_sys=True)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["run"]:
        if argv[1:2] != ["-m"] or len(argv) < 3:
            raise SystemExit("usage: torch_tpu_precision.py run -m <module> [arguments]")
        sys.path.insert(0, str(REPO))
        run(argv[2], argv[3:])
        return
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=["count"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--style_dim", type=int, default=512)
    ap.add_argument("--batch_size", type=int, default=128)
    ap.add_argument("--compute_dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    count(args)


if __name__ == "__main__":
    main()
