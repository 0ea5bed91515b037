"""On the card: the control fails a cell's limits at the cell's own size, the profiler's trace
is read, and a short run prints its result.  Each test looks for a card itself and skips
without one; run with ``python -m pytest -m cuda cudabench/tests``."""

import json
import subprocess
import sys

import pytest
import torch

from cudabench import check, harness, trace
from cudabench import weights as wmod


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return "cuda"


@pytest.mark.cuda
def test_control_fails_at_the_cells_size(card):
    spec = harness.cell_spec("flagship.train")
    game, dataset = spec["config"]["game"], spec["config"]["dataset"]
    seed = 2**31 + 77
    data = harness.make_data(game, dataset, seed, card)
    loader = harness.make_loader(game, dataset, data, seed, card)
    batches = [next(harness.feed(loader)) for _ in range(3)]
    init = wmod.make_weights(game, harness.sub_seed(seed, harness.WEIGHTS), card)
    zs = harness.make_noise(game, seed, 3, card)
    chunk = spec["cell"]["reference_chunk"]
    ref = harness.reference_steps(game, init, batches, zs, card, chunk)
    control = harness.reference_steps(game, init, batches, zs, card, chunk, quant="fp8")
    assert not check.verdict(check.readings(control, ref, init), spec["cell"]["limits"])


@pytest.mark.cuda
def test_trace_reads_busy_time(card):
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.randn(2048, 2048, device=card)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(trace.WINDOW):
            for _ in range(4):
                x = torch.tanh(x @ x)
            torch.cuda.synchronize()
    read = trace.read_profile(prof, 4)
    assert 0 < read["busy_s"] <= read["window_s"]
    assert read["activities"] >= 8 and read["device_ops"] and read["idle_gaps"]


@pytest.mark.cuda
def test_a_short_run_prints_its_result(card):
    out = subprocess.run([sys.executable, str(harness.HERE / "run.py"), "--workload",
                          "flagship.train", "--seed", "5", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, cwd=str(harness.ROOT), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["device"]["platform"] == "gpu" and result["attempted"] > 0
    assert set(result["metrics"]) == {"train_episodes_per_s", "setup_s"}
    assert list(result)[-1] == "checks"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
