"""The frozen work counts against the bounds ``chip_smoke.py`` phase 3 prints a flagship step,
and the roofline share over a made-up profile."""

import pytest

from cudabench import harness
from cudabench.counts import kernels


def test_flagship_step_bounds_match_phase_3():
    bounds = kernels.step_bounds(harness.load_json("configs", "flagship")["kernel_sites"])
    # K1 0.2927 ms, K1b 0.4394 ms, K2 0.1958 ms a flagship step (bytes-bound each)
    assert round(bounds["adain_fwd"][0] * 1e3, 4) == 0.2927
    assert round(bounds["adain_bwd"][0] * 1e3, 4) == 0.4394
    assert round(bounds["attention_core"][0] * 1e3, 4) == 0.1958
    assert [bounds[k][1] for k in ("adain_fwd", "adain_bwd", "attention_core")] == [16, 16, 9]


def test_vox_step_launches():
    bounds = kernels.step_bounds(harness.load_json("configs", "vox")["kernel_sites"])
    assert [bounds[k][1] for k in ("adain_fwd", "adain_bwd", "attention_core")] == [18, 18, 9]


def _ctx(kernel_times, steps=2):
    return {"config": harness.load_json("configs", "flagship"),
            "profile": {"steps": steps, "kernels": kernel_times}}


def test_roofline_share_over_a_profile():
    least, launches = kernels.step_bounds(
        harness.load_json("configs", "flagship")["kernel_sites"])["attention_core"]
    per_launch = 2 * least / launches  # each launch at twice its share of the bound
    ctx = _ctx([("void attention_core_bf16_kernel<4>", per_launch)] * (2 * launches)
               + [("cudnn_conv", 1.0)])
    assert kernels.roofline_share(ctx, ("attention_core",)) == pytest.approx(50.0)


def test_roofline_share_silent_when_the_launches_differ():
    ctx = _ctx([("void attention_core_bf16_kernel<4>", 1e-4)] * 5)
    assert kernels.roofline_share(ctx, ("attention_core",)) is None
    assert kernels.roofline_share({"config": {}, "profile": {}}, ("adain_fwd",)) is None


def test_folded_blocks_compute_the_plain_blocks(tiny):
    """The forms the FLOP count swaps in (a stride-2 conv for a conv and a pool, a
    transposed conv for an upsample and a conv) give the plain reference's outputs."""
    import torch

    from cudabench import weights as wmod
    from cudabench.counts import model_flops
    from cudabench.reference import game as ref_game

    game = tiny("vox.train_r1", "float32")["config"]["game"]
    init = wmod.make_weights(game, 3, "cpu")
    g = ref_game.Game(game, init, "cpu")
    gen = torch.Generator().manual_seed(0)
    leaked = torch.rand((2, game["m"], 16, 16, 3), generator=gen) * 2 - 1
    si = torch.rand((2, game["k"], 16, 16, 3), generator=gen) * 2 - 1
    z = torch.randn((2, game["n"], game["style_dim"]), generator=gen)
    ref_game.exact_f32()
    with torch.no_grad():
        fake = g.im(leaked, z, True)
        out = g.au(fake, si)
        swaps = model_flops._folded_forwards()
        plain = {cls: cls.forward for cls in swaps}
        try:
            for cls, forward in swaps.items():
                cls.forward = forward
            fake_folded, out_folded = g.im(leaked, z, True), g.au(fake, si)
        finally:
            for cls, forward in plain.items():
                cls.forward = forward
    torch.testing.assert_close(fake_folded, fake, rtol=0, atol=1e-5)
    torch.testing.assert_close(out_folded, out, rtol=1e-5, atol=1e-5)


def test_folded_count_is_under_the_plain_count(tiny, monkeypatch):
    from cudabench.counts import model_flops

    game = tiny("flagship.train", "float32")["config"]["game"]
    folded = model_flops.count(game)
    monkeypatch.setattr(model_flops, "_folded_forwards", dict)
    assert 0.4 * model_flops.count(game) < folded < model_flops.count(game)
