"""Tiny cells for the CPU tests of the benchmark: the real cells' files at small sizes."""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def tiny_spec(cell: str = "flagship.train", compute_dtype: str = "float32",
              reg_param=None) -> dict:
    """A cell's spec with its configuration cut to img 16, style 32, B 4 on 6 classes of 12."""
    from cudabench import harness

    spec = harness.cell_spec(cell)
    game = spec["config"]["game"]
    game.update(img_size=16, style_dim=32, batch_size=4, compute_dtype=compute_dtype)
    if reg_param is not None:
        game["reg_param"] = reg_param
    spec["config"]["dataset"].update(classes=6, per_class=12)
    spec["cell"]["reference_chunk"] = 2
    return spec


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny():
    return tiny_spec


def read_json(path: Path) -> dict:
    return json.loads(path.read_text())
