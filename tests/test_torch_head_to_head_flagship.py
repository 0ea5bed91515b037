"""A rehearsal of ``scripts/torch_hard_head_to_head.py --flagship`` on the CPU at a tiny
size, on one rank and over two gloo ranks: the set, the port's CLI, the eval CLI's grid
of each checkpoint with its score moments and raw scores, the CSVs' names and columns,
and the copied arguments with the run's record."""

from __future__ import annotations

import csv
import json
import subprocess
import sys

import pytest

from head_to_head_support import REPO, h2h


@pytest.mark.parametrize("cards", [1, 2])
def test_flagship_rehearsal_on_the_cpu(tmp_path, monkeypatch, cards):
    """The --flagship mode at a tiny size: a few glyph classes of 16 px, the port's
    CLI at its defaults but the sizes (100 episodes a class: 9 steps an epoch at
    B=32) to a checkpoint at ``--n_steps``, scored by the eval CLI as it lands;
    with 2 cards two CPU ranks over gloo and the host loader.  The set's record,
    its verdict against the glyph study's, the CSVs' names and columns (the JAX
    run's), the copied arguments with the run's record."""
    # the CLIs it starts on one intra-op thread each, as test_torch_parallel.py's ranks:
    # under a busy xdist run their default of one thread a core oversubscribes the host
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    ds = tmp_path / "ds"
    subprocess.run([sys.executable, h2h.MAKE_SET, "--out", str(ds), "--n_alphabets", "2",
                    "--n_chars", "3", "--val_alphabets", "1", "--imgs_per_class", "12",
                    "--img_size", "16"], check=True, cwd=REPO, capture_output=True)
    out, csvs = tmp_path / "runs", tmp_path / "csv"
    monkeypatch.chdir(REPO)
    h2h.main(["--flagship", "--device", "cpu", "--ds_root", str(ds), "--outdir", str(out),
              "--csv_dir", str(csvs), "--n_steps", "2", "--save_every", "2", "--img_size",
              "16", "--style_dim", "32", "--batch_size", "32", "--cards", str(cards)])
    tag = "s1" if cards == 1 else "s1_cards2"
    grid = f"port_flag_{tag}_eval_00000002.csv"
    scores = f"port_flag_{tag}_scores_00000002"
    assert sorted(p.name for p in csvs.iterdir()) == sorted([
        f"port_flag_{tag}_args.json", grid, scores, "port_flag_set.json"])
    assert sorted(p.name for p in (csvs / scores).iterdir()) == [
        f"scores_gim_{im}.npz" for im in h2h.ATTACKERS]
    with open(csvs / grid, newline="") as f:
        lines = list(csv.reader(f))
    with open(REPO / h2h.JAX_FLAG_CAL_DIR / "cal_eval_00005000.csv", newline="") as f:
        assert lines[0] == next(csv.reader(f))
    assert [line[1:3] for line in lines[1:]] == [["gim", im] for im in h2h.ATTACKERS]
    assert [line[5:8] for line in lines[1:]] == [["1", "5", "5"]] * 3
    assert all(0.0 <= float(line[-1]) <= 1.0 for line in lines[1:])
    args = json.loads((csvs / f"port_flag_{tag}_args.json").read_text())
    assert (args["dataset_type"], args["img_channels"], args["reg_param"], args["au_lr"],
            args["im_lr"], args["env_noise_mapping_lr"], args["compute_dtype"],
            args["ds_n_examples_per_cls"], args["milestones"], args["seed"],
            args["device_data"]) == (
        "omniglot", 1, 0.0, 1e-6, 1e-5, 1e-7, "bfloat16", 100, [], 1,
        "auto" if cards == 1 else "off")
    assert (args["study_run"]["cards"], args["study_run"]["card"],
            args["study_run"]["stopped"]) == (cards, "cpu", None)
    assert args["study_run"]["grid_marks"][0] == [0, 0.0]
    record = json.loads((csvs / "port_flag_set.json").read_text())
    assert record["command"] == ["python", h2h.MAKE_SET, "--out", str(ds)]
    assert (record["sha256_paths_and_pixels"], record["images"]) == h2h.set_digest(str(ds))
    assert h2h.set_verdict(str(csvs / "port_flag_set.json")).startswith("NOT the")
    exp = out / ("seed_1" if cards == 1 else "seed_1_cards2")
    assert "model_00000002" in {p.name for p in (exp / "ckpts").iterdir()}
    assert not h2h.game_report(h2h.FLAG, str(csvs))  # no reading at a bar step
