"""``scripts/torch_flagship_trajectory.py`` without its long run: the episodes it draws,
the in-memory glyph set, ``--report`` and the swing's signature on synthetic CSVs, the
signature of the flagship study's grids, and two steps of ``--port_only`` on the CPU."""

from __future__ import annotations

import csv
import importlib.util
import json
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


def swing_csv(path: Path, records: list, side: str = "port") -> Path:
    """A trajectory CSV of one side with (step, real scores' std, GIM AUC) records."""
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, traj.COLUMNS, lineterminator="\n")
        w.writeheader()
        for step, std, auc in records:
            row = dict.fromkeys(traj.COLUMNS, 0.0)
            row.update(step=step, side=side, score_real_std=std, auc_gim=auc)
            w.writerow(row)
    return path


# the scale at step 250 is 0.01: a rise to 0.5 (x50), then back under 0.05 (x5) with
# GIM AUC <= 0.2; the first case has the shape of grid500_pr17's records
SWINGS = {
    "met": ([(250, 0.01, 0.9), (1000, 0.2, 1.0), (2500, 3.9, 1.0), (3000, 1.4, 0.91),
             (3500, 0.13, 0.14), (4500, 0.023, 0.011), (5000, 0.009, 0.27)], 4500),
    "never_rises": ([(250, 0.01, 0.9), (1000, 0.4, 1.0), (2000, 0.04, 0.1)], None),
    "rises_never_falls_back": ([(250, 0.01, 0.9), (1500, 0.6, 1.0), (2500, 0.06, 0.05),
                                (3000, 0.3, 0.15)], None),
    "overturn_too_late": ([(250, 0.01, 0.9), (500, 0.8, 1.0), (1000, 0.2, 1.0),
                           (3250, 0.03, 0.1)], None),
}


@pytest.mark.parametrize("case", list(SWINGS))
def test_swing_signature_on_synthetic_records(tmp_path, case):
    recs, collapse = SWINGS[case]
    path = swing_csv(tmp_path / "run.csv", recs)
    sig = traj.signature_report([str(path)])[f"{path} port"]
    assert (sig and sig["collapse"]) == collapse
    if collapse:
        assert (sig["first"], sig["scale"], sig["rise"]) == (250, 0.01, 2500)
        assert sig["peak"] == pytest.approx(390.0)


def test_swing_signature_reads_the_flagship_grids():
    """The two committed flagship runs of seed 1 with a grid every 500 steps both meet it."""
    grids = REPO / "docs" / "flagship_head_to_head"
    sig = traj.signature_report([str(grids / "grid500_pr15"), str(grids / "grid500_pr17")])
    assert [s["collapse"] for s in sig.values()] == [4000, 4500]


def test_port_only_on_the_cpu(tmp_path):
    """Two steps of the port's side alone at style 8, B 2: the columns, one side, the
    gaps empty, the readings finite, and the run's record."""
    traj.main(["--port_only", "--device", "cpu", "--style_dim", "8", "--batch_size", "2",
               "--n_steps", "2", "--every", "1", "--eval_episodes", "4", "--n_alphabets",
               "3", "--n_chars", "2", "--out", str(tmp_path)])
    name = "port_float32_style8_b2_s1"
    with open(tmp_path / f"{name}.csv", newline="") as f:
        reader = csv.DictReader(f)
        assert tuple(reader.fieldnames) == traj.COLUMNS
        rows = list(reader)
    assert [(r["step"], r["side"], r["gap_au"], r["gap_im"]) for r in rows] == [
        ("1", "port", "", ""), ("2", "port", "", "")]
    for r in rows:
        assert all(np.isfinite(float(r[k])) for k in traj.COLUMNS
                   if k not in ("step", "side", "gap_au", "gap_im"))
        assert 0.0 <= float(r["auc_gim"]) <= 1.0 and float(r["disp_au"]) > 0.0
    info = json.loads((tmp_path / f"{name}.json").read_text())
    assert (info["mode"], info["device"], info["steps"], info["config"]["style_dim"],
            info["signature"]) == ("port_only", "cpu", 2, 8, None)
