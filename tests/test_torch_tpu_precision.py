"""``scripts/torch_tpu_precision.py``'s dispatch mode: an f32 product on operands
rounded to bf16 (a TPU's default precision), what it adds to left in f32, and bf16
ops untouched."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parents[1]
SPEC = importlib.util.spec_from_file_location(
    "torch_tpu_precision", REPO / "scripts" / "torch_tpu_precision.py")
tpu = importlib.util.module_from_spec(SPEC)
SPEC.loader.exec_module(tpu)


def r(x):
    return x.to(torch.bfloat16).float()


def tensors(*shapes, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(*s, generator=gen) for s in shapes]


def test_f32_linear_is_the_product_of_rounded_operands():
    x, w, b = tensors((6, 40), (24, 40), (24,))
    with tpu.TPUDefaultPrecision():
        got = F.linear(x, w, b)
        got_3d = F.linear(x.reshape(2, 3, 40), w)
    assert torch.equal(got, F.linear(r(x), r(w), b))  # the bias added in f32
    assert torch.equal(got_3d, F.linear(r(x).reshape(2, 3, 40), r(w)))
    assert not torch.equal(got, F.linear(x, w, b))


def test_f32_conv_and_its_input_and_weight_gradients_are_on_rounded_operands():
    x, w, b, g = tensors((2, 3, 9, 9), (5, 3, 3, 3), (5,), (2, 5, 9, 9))
    counts = __import__("collections").Counter()
    x.requires_grad_(True)
    w.requires_grad_(True)
    b.requires_grad_(True)
    with tpu.TPUDefaultPrecision(counts):
        out = F.conv2d(x, w, b, padding=1)
        gx, gw, gb = torch.autograd.grad(out, (x, w, b), g)
    xr, wr = r(x.detach()).requires_grad_(True), r(w.detach()).requires_grad_(True)
    want = F.conv2d(xr, wr, b.detach(), padding=1)
    assert torch.equal(out, want)
    ref = torch.ops.aten.convolution_backward.default(
        r(g), xr.detach(), wr.detach(), [5], [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
        [True, True, False])
    assert torch.equal(gx, ref[0]) and torch.equal(gw, ref[1])
    assert torch.equal(gb, g.sum((0, 2, 3)))  # a reduce, not a product: exact
    assert not torch.equal(gw, torch.autograd.grad(F.conv2d(x, w, b, padding=1), w, g)[0])
    assert {(op, phase) for op, phase, _ in counts} == {
        ("convolution", "forward"), ("convolution_backward", "backward")}


def test_bf16_and_f64_ops_pass_untouched():
    x, w = tensors((2, 3, 8, 8), (4, 3, 3, 3), seed=1)
    counts = __import__("collections").Counter()
    with tpu.TPUDefaultPrecision(counts):
        bf16 = F.conv2d(x.bfloat16(), w.bfloat16())
        f64 = x.double().flatten(1) @ x.double().flatten(1).t()
    assert torch.equal(bf16, F.conv2d(x.bfloat16(), w.bfloat16()))
    assert torch.equal(f64, x.double().flatten(1) @ x.double().flatten(1).t())
    assert not counts
