"""``scripts/torch_flagship_trajectory.py`` without its long run: the episodes it draws,
the in-memory glyph set, and ``--report`` on synthetic CSVs."""

from __future__ import annotations

import csv
import importlib.util
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
SPEC = importlib.util.spec_from_file_location(
    "torch_flagship_trajectory", REPO / "scripts" / "torch_flagship_trajectory.py")
traj = importlib.util.module_from_spec(SPEC)
SPEC.loader.exec_module(traj)


def test_glyph_set_and_episodes():
    train, held_out = traj.glyph_set(3, 2, 8, 1, 16)
    assert train.shape == (4, 8, 16, 16, 1) and held_out.shape == (2, 8, 16, 16, 1)
    assert train.dtype == np.uint8
    batch = traj.episodes(train, 5, 1, 3, 4, np.random.default_rng(0))
    assert {k: v.shape for k, v in batch.items()} == {
        "leaked_sample": (5, 1, 16, 16, 1), "real_sample": (5, 3, 16, 16, 1),
        "si_sample": (5, 4, 16, 16, 1)}
    # one class an episode, its images drawn without replacement
    imgs = np.concatenate([batch[k] for k in ("leaked_sample", "real_sample", "si_sample")], 1)
    flat = train.reshape(-1, *train.shape[2:])
    for episode in imgs:
        where = [int(np.flatnonzero((flat == img).all(axis=(1, 2, 3)))[0]) for img in episode]
        assert len({w // train.shape[1] for w in where}) == 1
        assert len(set(where)) == len(where)
    again = traj.episodes(train, 5, 1, 3, 4, np.random.default_rng(0))
    assert all(np.array_equal(batch[k], again[k]) for k in batch)


def write_run(out: Path, dtype: str, seed: int, values: dict) -> None:
    """A run's CSV with two recorded steps: each side's readings ``values[side]``."""
    with open(out / f"traj_{dtype}_s{seed}.csv", "w", newline="") as f:
        w = csv.DictWriter(f, traj.COLUMNS, lineterminator="\n")
        w.writeheader()
        for step in (25, 50):
            for side in ("jax", "port"):
                row = dict.fromkeys(traj.COLUMNS, 0.0)
                row.update({k: values[side] for k in traj.REPORT_KEYS}, step=step, side=side)
                w.writerow(row)


@pytest.mark.parametrize("port_offset,inside", [(0.0, 48), (5.0, 0)])
def test_report_counts_the_port_readings_inside_the_jax_seeds_range(tmp_path, port_offset,
                                                                      inside):
    for seed, value in ((1, 0.1), (2, 0.3), (3, 0.2)):
        write_run(tmp_path, "float32", seed, {"jax": value, "port": value + port_offset})
    write_run(tmp_path, "bfloat16", 1, {"jax": 0.5, "port": 0.5})
    verdict = traj.report(str(tmp_path))
    # three seeds x two steps x eight quantities; one bf16 seed: its own range
    assert verdict == {"float32": (inside, 48), "bfloat16": (16, 16)}
