"""The port's hand-written kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with ``nvcc`` and ``triton`` (the kernels have
no CPU mode) and skip elsewhere.  Run them on a GPU host with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest sets up JAX, which a GPU host running
only the port need not have).

Tolerances: f32 atol 1e-5 / rtol 1e-4 (f32 sums in another order); bf16
atol 1e-2 / rtol 2^-6 of the largest reference entry (one bf16 rounding of
the output).  The flagship shapes of the bf16 attention core (tensor-core
path) and of both AdaIN kernels (one pass over a resident tile) are held
here too, and the AdaIN shapes reach each of the kernels' three tile modes; ``chip_smoke.py`` checks every flagship site in both dtypes.  The
bf16 attention kernel must also round P as its plain version does: at least
99 % of its outputs equal to the plain version's, a share the same core
with P left in f32 misses.

The VoxCeleb config (64x64x3, R1) adds two AdaIN sites, [640, 32, 32, 64]
(resident tile) and [640, 64, 64, 3] (flat tile), and runs the attention
core under the R1 penalty's double backward: at the authenticator's site
(N=256, C=128, CQ=16, B' cut from 1920 to 8) the gradient of the squared
input gradient on the card (kernel forward, torch-op backward) is held to
the CPU's (plain version) at the same bars, TF32 off; and R1 through the
authenticator (the penalty, and the loss's parameter gradients; 32x32x3,
style 64, f32) to the CPU's at 1e-3 of each tensor's largest entry plus
1e-6 of the player's, as ``chip_smoke.py`` phase 5 holds it at the
VoxCeleb widths.

A spectrally normalised conv of one channel to one channel runs as im2col
and a matmul on the card (``nn/blocks.py:conv_one_channel``): cuDNN 9.22
computes the flagship env decoder's last conv ([640, 1, 32, 32], 3x3) wrongly
in bf16.  At that site, output and both gradients within 2e-2 of the
largest entry of f32 without cuDNN (a few bf16 roundings of a 9-term sum).
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


# the tile mode both kernels take at each shape: flat, flat, resident, loop
ADAIN_MODES = {(3, 5, 4, 4): "flat", (2, 1, 32, 32): "flat", (2, 70, 9, 7): "resident",
               (2, 8, 64, 64): "loop"}


@DTYPES
@pytest.mark.parametrize("bchw", list(ADAIN_MODES), ids=["4x4x5", "32x32x1", "9x7x70", "64x64x8"])
def test_adain_kernels_match_plain_versions(gen, dtype, bchw):
    b, c, h, w = bchw
    for per_thread in k1.PER_THREAD.values():
        mode = k1.tile_config(b, h * w, c, per_thread)["MODE"]
        assert k1.MODE_NAMES[mode] == ADAIN_MODES[bchw]
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


# (B', N, C, CQ) of the flagship train step's attention sites, and ragged shapes
ATTENTION_FLAGSHIP = [(1920, 64, 256, 32), (1280, 64, 256, 32), (128, 64, 256, 32),
                      (640, 64, 128, 16), (640, 64, 256, 32), (640, 256, 128, 16)]
ATTENTION_BF16 = pytest.mark.parametrize(
    "bncq", ATTENTION_FLAGSHIP + [(2, 16, 8, 1), (2, 50, 20, 3)],
    ids=[f"b{b}_n{n}_c{c}_cq{cq}" for b, n, c, cq in ATTENTION_FLAGSHIP]
    + ["n16_cq1", "n50_c20_cq3"])
# P rounded as the plain version rounds it: at most P_REL_ERR (one bf16 step)
# of the largest output entry apart, and at least P_SHARE_EQUAL of the bf16
# outputs equal.  On an H100 the kernel keeps 99.85-100 % equal at these
# sites and the core with P in f32 50-60 %
# (scripts/torch_attention_agreement.py prints both measures per site).
P_REL_ERR, P_SHARE_EQUAL = 2.0 ** -8, 0.99


def _attention_inputs(gen, b, n, c, cq):
    f = (0.5 * _rand(gen, b, n, cq)).to(torch.bfloat16)
    g = (0.5 * _rand(gen, b, n, cq)).to(torch.bfloat16)
    return f, g, _rand(gen, b, n, c, dtype=torch.bfloat16)


def _agreement(got, want):
    """(max |got - want| / max |want|, share of exactly equal entries)."""
    d = (got.float() - want.float()).abs()
    return (d.max() / want.float().abs().max()).item(), (d == 0).float().mean().item()


@ATTENTION_BF16
def test_attention_bf16_tensor_core_path_at_flagship_and_ragged_sites(gen, bncq):
    f, g, h = _attention_inputs(gen, *bncq)
    got = k2.attention_core_cuda(f, g, h)
    torch.cuda.synchronize()
    _close(got, k2.attention_core_ref(f, g, h), torch.bfloat16)


@ATTENTION_BF16
def test_attention_bf16_kernel_rounds_p_as_its_plain_version(gen, bncq):
    f, g, h = _attention_inputs(gen, *bncq)
    want = k2.attention_core_ref(f, g, h)
    rel, equal = _agreement(k2.attention_core_cuda(f, g, h), want)
    assert rel <= P_REL_ERR and equal >= P_SHARE_EQUAL, (rel, equal)
    # the same core with P left in f32 misses the bar: it tells the roundings apart
    p = torch.softmax(torch.bmm(f.float(), g.float().transpose(1, 2)), dim=1)
    rel_u, equal_u = _agreement(torch.bmm(p.transpose(1, 2), h.float()).to(h.dtype), want)
    assert rel_u > P_REL_ERR or equal_u < P_SHARE_EQUAL, (rel_u, equal_u)


def test_attention_bf16_launches_on_every_device(gen):
    """Each device gets its own launch state: shared memory past 48 KB and its SM count."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs")
    for dev in range(torch.cuda.device_count()):
        for b, n, c, cq in [(640, 256, 128, 16), (64, 64, 256, 32)]:
            f, g, h = (t.to(f"cuda:{dev}") for t in _attention_inputs(gen, b, n, c, cq))
            got = k2.attention_core_cuda(f, g, h)
            assert got.device == h.device
            _close(got, k2.attention_core_ref(f, g, h), torch.bfloat16)


@pytest.mark.parametrize("bchw", [(640, 512, 4, 4), (640, 1, 32, 32)],
                         ids=["640x4x4x512", "640x32x32x1"])
def test_adain_resident_tiles_with_a_constant_channel(gen, bchw):
    b, c = bchw[:2]
    x = _rand(gen, *bchw)
    x[3, c // 2] = 0.5  # sigma == 0: y = mean_s, and the sigma-term of dx is dropped
    x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    g = _rand(gen, *bchw, dtype=torch.bfloat16).contiguous(memory_format=torch.channels_last)
    ms, ss = _rand(gen, b, c, dtype=torch.bfloat16), _rand(gen, b, c, dtype=torch.bfloat16)
    const = torch.zeros_like(x, dtype=torch.bool)
    const[3, c // 2] = True
    y, y_ref = k1.ada_in_fwd_cuda(x, ms, ss), k1.ada_in_ref(x, ms, ss)
    assert torch.isfinite(y).all()
    _close(y[const], y_ref[const], torch.bfloat16)
    _close(y[const], ms[3, c // 2].expand(int(const.sum())), torch.bfloat16)
    _close(y[~const], y_ref[~const], torch.bfloat16)
    dx, dm, ds = k1.ada_in_bwd_cuda(x, ss, g)
    dx_ref, dm_ref, ds_ref = k1.ada_in_bwd_ref(x, ss, g)
    assert torch.isfinite(dx).all()
    # the constant channel's dx is ~std_s / eps larger: compare it on its own
    _close(dx[const], dx_ref[const], torch.bfloat16)
    _close(dx[~const], dx_ref[~const], torch.bfloat16)
    _close(dm, dm_ref, torch.bfloat16)
    _close(ds, ds_ref, torch.bfloat16)


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


@DTYPES
@pytest.mark.parametrize("bchw,mode", [((640, 64, 32, 32), "resident"), ((640, 3, 64, 64), "flat")],
                         ids=["640x32x32x64", "640x64x64x3"])
def test_adain_kernels_at_the_vox_sites(gen, dtype, bchw, mode):
    b, c, h, w = bchw
    for per_thread in k1.PER_THREAD.values():
        assert k1.MODE_NAMES[k1.tile_config(b, h * w, c, per_thread)["MODE"]] == mode
    x = _rand(gen, *bchw, dtype=dtype).contiguous(memory_format=torch.channels_last)
    g = _rand(gen, *bchw, dtype=dtype).contiguous(memory_format=torch.channels_last)
    ms, ss = _rand(gen, b, c, dtype=dtype), _rand(gen, b, c, dtype=dtype)
    _close(k1.ada_in_fwd_cuda(x, ms, ss), k1.ada_in_ref(x, ms, ss), dtype)
    for got, want in zip(k1.ada_in_bwd_cuda(x, ss, g), k1.ada_in_bwd_ref(x, ss, g)):
        _close(got, want, dtype)


@pytest.fixture
def no_tf32():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _penalty_grads(f, g, h, ct):
    """d/d(f, g, h) of |d sum(core * ct) / d(f, g, h)|^2: a double backward through K2."""
    leaves = [t.clone().requires_grad_(True) for t in (f, g, h)]
    first = torch.autograd.grad((k2.attention_core(*leaves).float() * ct).sum(), leaves,
                                create_graph=True)
    penalty = sum(d.float().square().sum() for d in first)
    return torch.autograd.grad(penalty, leaves)


@DTYPES
def test_attention_double_backward_on_the_card_matches_the_cpu(gen, no_tf32, dtype):
    b, n, c, cq = 8, 256, 128, 16  # the VoxCeleb authenticator's site, B' cut from 1920
    f, g = (0.5 * _rand(gen, b, n, cq)).to(dtype), (0.5 * _rand(gen, b, n, cq)).to(dtype)
    h, ct = _rand(gen, b, n, c, dtype=dtype), _rand(gen, b, n, c)
    before = k2.FWD_LAUNCHES.count
    got = _penalty_grads(f, g, h, ct)
    assert k2.FWD_LAUNCHES.count == before + 1  # the double backward launches no forward
    want = _penalty_grads(f.cpu(), g.cpu(), h.cpu(), ct.cpu())
    for a, w in zip(got, want):
        assert torch.isfinite(a).all()
        _close(a.cpu(), w, dtype)


def test_r1_through_the_kernels_matches_the_cpu(gen, no_tf32):
    import copy

    from optimalstrategiesagainstgenerativeattacks_torch.models import image as imodels
    from optimalstrategiesagainstgenerativeattacks_torch.nn.init import init_module
    from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg
    from optimalstrategiesagainstgenerativeattacks_torch.train.losses import bce_with_logits
    from optimalstrategiesagainstgenerativeattacks_torch.utils.config import ImageGameConfig

    cfg = ImageGameConfig(img_size=32, img_channels=3, style_dim=64, reg_param=10.0,
                          compute_dtype="float32", batch_size=2)
    cpu_gen = torch.Generator().manual_seed(0)
    au = imodels.get_au(cfg.img_size, cfg.img_channels, cfg.style_dim)
    init_module(au, cpu_gen)
    with torch.no_grad():
        for m in au.modules():
            if hasattr(m, "gamma"):
                m.gamma.copy_(0.5 * torch.randn(1, generator=cpu_gen))
    shape = (cfg.batch_size, cfg.n, cfg.img_size, cfg.img_size, cfg.img_channels)
    real, fake, si = (torch.rand(*shape, generator=cpu_gen) * 2 - 1 for _ in range(3))

    def run(module, device):
        r, s = real.to(device).requires_grad_(True), si.to(device).requires_grad_(True)
        out_real, out_fake = timg.au_outputs(module, r, fake.to(device), s)
        reg = timg.r1_penalty(cfg, out_real, r, s)
        loss = (bce_with_logits(out_real, 1.0) + bce_with_logits(out_fake, 0.0) + reg).mean()
        return reg.detach().cpu(), [x.cpu() for x in torch.autograd.grad(
            loss, list(module.parameters()))]

    reg_card, grads_card = run(copy.deepcopy(au).cuda(), "cuda")
    reg_cpu, grads_cpu = run(au, "cpu")
    assert (reg_card - reg_cpu).abs().max() <= 1e-3 * reg_cpu.abs().max()
    player = max(w.abs().max().item() for w in grads_cpu)
    for a, w in zip(grads_card, grads_cpu):
        assert (a - w).abs().max() <= 1e-3 * w.abs().max() + 1e-6 * player


def test_one_channel_conv_at_the_flagship_env_decoder_site(gen):
    import torch.nn.functional as F

    from optimalstrategiesagainstgenerativeattacks_torch.nn.blocks import conv2d

    x = _rand(gen, 640, 1, 32, 32, dtype=torch.bfloat16).requires_grad_(True)
    w = (_rand(gen, 1, 1, 3, 3) / 3).to(torch.bfloat16).requires_grad_(True)
    b = _rand(gen, 1, dtype=torch.bfloat16)
    out = conv2d(x, w, b, 1)
    cot = _rand(gen, *out.shape)
    got = (out, *torch.autograd.grad(out, (x, w), cot.to(out.dtype)))
    xf, wf = (t.detach().float().requires_grad_(True) for t in (x, w))
    with torch.backends.cudnn.flags(enabled=False):
        ref = F.conv2d(xf, wf, b.float(), padding=1)
        want = (ref, *torch.autograd.grad(ref, (xf, wf), cot))
    for a, r in zip(got, want):
        assert (a.float() - r).abs().max().item() <= 2e-2 * r.abs().max().item()
