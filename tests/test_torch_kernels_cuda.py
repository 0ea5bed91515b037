"""The port's hand-written kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with ``nvcc`` and ``triton`` (the kernels have
no CPU mode) and skip elsewhere.  Run them on a GPU host with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest sets up JAX, which a GPU host running
only the port need not have).

Tolerances: f32 atol 1e-5 / rtol 1e-4 (f32 sums in another order); bf16
atol 1e-2 / rtol 2^-6 of the largest reference entry (one bf16 rounding of
the output).  The flagship shapes are checked by ``chip_smoke.py``.
"""

import pytest
import torch

from optimalstrategiesagainstgenerativeattacks_torch.kernels import adain as k1
from optimalstrategiesagainstgenerativeattacks_torch.kernels import attention as k2

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-2, 2.0 ** -6)}
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, dtype):
    atol, rtol = TOL[dtype]
    err = (got.float() - want.float()).abs().max().item()
    assert err <= atol + rtol * want.float().abs().max().item(), err


def _rand(gen, *shape, dtype=torch.float32):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


@DTYPES
@pytest.mark.parametrize("bchw", [(3, 5, 4, 4), (2, 1, 32, 32), (2, 70, 9, 7)],
                         ids=["4x4x5", "32x32x1", "9x7x70"])
def test_adain_kernels_match_plain_versions(gen, dtype, bchw):
    x = _rand(gen, *bchw, dtype=dtype).contiguous(memory_format=torch.channels_last)
    g = _rand(gen, *bchw, dtype=dtype).contiguous(memory_format=torch.channels_last)
    ms, ss = _rand(gen, *bchw[:2], dtype=dtype), _rand(gen, *bchw[:2], dtype=dtype)
    before = (k1.FWD_LAUNCHES.count, k1.BWD_LAUNCHES.count)
    _close(k1.ada_in_fwd_cuda(x, ms, ss), k1.ada_in_ref(x, ms, ss), dtype)
    for got, want in zip(k1.ada_in_bwd_cuda(x, ss, g), k1.ada_in_bwd_ref(x, ss, g)):
        _close(got, want, dtype)
    assert (k1.FWD_LAUNCHES.count, k1.BWD_LAUNCHES.count) == (before[0] + 1, before[1] + 1)


def test_adain_zero_variance_channel_stays_finite(gen):
    x = _rand(gen, 2, 3, 4, 4)
    x[0, 1] = 0.5
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_(True)
    ms, ss = _rand(gen, 2, 3), _rand(gen, 2, 3)
    g = _rand(gen, 2, 3, 4, 4)
    (k1.ada_in(x, ms, ss) * g).sum().backward()
    assert torch.isfinite(x.grad).all()
    dx, _, _ = k1.ada_in_bwd_ref(x.detach(), ss, g)
    _close(x.grad, dx, torch.float32)


@DTYPES
@pytest.mark.parametrize("bncq", [(2, 16, 8, 1), (3, 64, 256, 32), (2, 256, 128, 16),
                                  (2, 50, 20, 3)],
                         ids=["n16_cq1", "n64_cq32", "n256_cq16", "n50_cq3"])
def test_attention_kernel_matches_plain_version(gen, dtype, bncq):
    b, n, c, cq = bncq
    f, g = _rand(gen, b, n, cq, dtype=dtype), _rand(gen, b, n, cq, dtype=dtype)
    h = _rand(gen, b, n, c, dtype=dtype)
    before = k2.FWD_LAUNCHES.count
    _close(k2.attention_core_cuda(f, g, h), k2.attention_core_ref(f, g, h), dtype)
    assert k2.FWD_LAUNCHES.count == before + 1


def test_attention_kernel_refuses_what_it_does_not_take(gen):
    f = _rand(gen, 1, 257, 4)
    with pytest.raises(ValueError):
        k2.attention_core_cuda(f, f, _rand(gen, 1, 257, 8))
    f16 = _rand(gen, 1, 16, 4, dtype=torch.float16)
    with pytest.raises(TypeError):
        k2.attention_core_cuda(f16, f16, f16)
    with pytest.raises(TypeError):
        k1.ada_in_fwd_cuda(_rand(gen, 1, 2, 4, 4, dtype=torch.float16),
                           _rand(gen, 1, 2), _rand(gen, 1, 2))
