"""The frozen reference's train step against the program's, in f32 on the CPU at a tiny size."""

import pytest
import torch

from cudabench import check, harness
from cudabench import weights as wmod


@pytest.mark.parametrize("reg_param", [0.0, 10.0], ids=["flagship", "r1"])
@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_reference_step_equals_program_step(tiny, reg_param, seed):
    from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg

    spec = tiny("vox.train_r1" if reg_param else "flagship.train", "float32", reg_param)
    game, dataset = spec["config"]["game"], spec["config"]["dataset"]
    data = harness.make_data(game, dataset, seed, "cpu")
    loader = harness.make_loader(game, dataset, data, seed, "cpu")
    init = wmod.make_weights(game, harness.sub_seed(seed, harness.WEIGHTS), "cpu")
    zs = harness.make_noise(game, seed, 3, "cpu")
    state = harness.build_program(game, init, seed, "cpu")
    batches, prog = harness.program_steps(state, harness.feed(loader), zs, timg.train_step)
    ref = harness.reference_steps(game, init, batches, zs, "cpu", chunk=3)
    read = check.readings(prog, ref, init)
    # f32 on both sides: the first step's losses to summation order, the later ones
    # after Adam has moved the leaves whose gradient is rounding noise (signs that may
    # differ); a leaf's first gradient within 2 % of the larger of its norm and the
    # median leaf's (a gradient that cancels, as an attention's gamma in the env
    # decoder's spatially flat maps, keeps f32 noise)
    for k, r in ref["losses"][0].items():
        torch.testing.assert_close(prog["losses"][0][k], r, rtol=1e-5, atol=0)
    assert read["loss"] < 1e-3, read
    assert read["grad"] < 2e-2, read
    assert read["change_median"] < 1e-3, read
    # the spectral state advanced alike: the unit vectors u, v after three power
    # iterations, of weights that differ where a noise leaf's update took another sign
    for player in ("au", "im"):
        mine = dict(getattr(state, player).named_buffers())
        for name, u in ref["buffers"][player].items():
            torch.testing.assert_close(mine[name], u, rtol=0, atol=2e-4)


def test_reference_chunks_sum_to_the_batch(tiny):
    """Blocks of episodes give the whole batch's step."""
    spec = tiny("vox.train_r1", "float32")
    game, dataset = spec["config"]["game"], spec["config"]["dataset"]
    data = harness.make_data(game, dataset, 1, "cpu")
    loader = harness.make_loader(game, dataset, data, 1, "cpu")
    batches = [next(harness.feed(loader)) for _ in range(2)]
    init = wmod.make_weights(game, 9, "cpu")
    zs = harness.make_noise(game, 1, 2, "cpu")
    whole = harness.reference_steps(game, init, batches, zs, "cpu", chunk=None)
    blocks = harness.reference_steps(game, init, batches, zs, "cpu", chunk=1)
    for a, b in zip(whole["losses"], blocks["losses"]):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=1e-5, atol=1e-7)
    read = check.readings(blocks, whole, init)
    assert read["grad"] < 1e-3, read
