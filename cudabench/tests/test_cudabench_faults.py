"""A whole run on the CPU (the harness's look for a chip skipped) at a tiny size, with the timed
path broken underneath (``faults.py``): ``correct`` comes out false for each fault a training
cell can have on one chip.  A step that leaves the state unchanged; half of the batch left out
(its episodes and their fakes), the mean taken over the rest; an answer altered where it is
produced (the impersonator's fakes).  The control, the reference with float8 operands in the
program's place, fails the cell's limits too.  ``faults.py``'s ``half_loss`` and ``sign`` read
under ten times the sound runs on the card, so no number is held against them (PERF.md)."""

import pytest

from cudabench import check, harness
from cudabench import weights as wmod
from cudabench.faults import FAULTS


def run(spec, seed=4):
    return harness.run_cell(spec, seed, 0.05, False, "cpu")[0]


@pytest.mark.parametrize("cell", ["flagship.train", "vox.train_r1"])
def test_sound_run_is_correct(tiny, cell):
    result = run(tiny(cell))
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"  # the last key of the printed line


@pytest.mark.parametrize("cell", ["flagship.train", "vox.train_r1"])
def test_state_left_unchanged_is_not_correct(tiny, cell):
    with FAULTS["unchanged"]():
        result = run(tiny(cell))
    assert not result["correct"]
    assert result["checks"]["change_median"]["value"] == pytest.approx(1.0, rel=1e-3)


@pytest.mark.parametrize("cell", ["flagship.train", "vox.train_r1"])
def test_half_batch_is_not_correct(tiny, cell):
    with FAULTS["half_batch"]():
        result = run(tiny(cell))
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", ["flagship.train", "vox.train_r1"])
def test_altered_fakes_are_not_correct(tiny, cell, monkeypatch):
    from optimalstrategiesagainstgenerativeattacks_torch.models.image import GIMFaceImpersonator

    forward = GIMFaceImpersonator.forward
    monkeypatch.setattr(GIMFaceImpersonator, "forward",
                        lambda self, *a, **k: forward(self, *a, **k) * 1.25)
    result = run(tiny(cell))
    assert not result["correct"], result["checks"]
    assert result["checks"]["fake_first"]["value"] > result["checks"]["fake_first"]["limit"]


@pytest.mark.parametrize("cell", ["flagship.train", "vox.train_r1"])
def test_control_fails_the_limits(tiny, cell):
    spec = tiny(cell)
    game, dataset = spec["config"]["game"], spec["config"]["dataset"]
    data = harness.make_data(game, dataset, 4, "cpu")
    loader = harness.make_loader(game, dataset, data, 4, "cpu")
    batches = [next(harness.feed(loader)) for _ in range(3)]
    init = wmod.make_weights(game, 11, "cpu")
    zs = harness.make_noise(game, 4, 3, "cpu")
    ref = harness.reference_steps(game, init, batches, zs, "cpu", 2)
    control = harness.reference_steps(game, init, batches, zs, "cpu", 2, quant="fp8")
    assert not check.verdict(check.readings(control, ref, init), spec["cell"]["limits"])
