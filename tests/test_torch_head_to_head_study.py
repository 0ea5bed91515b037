"""A rehearsal of ``scripts/torch_hard_head_to_head.py``'s glyph study on the CPU at a
tiny size: a few classes of 16 px from ``scripts/make_hard_glyph_ds.py``, 3 training
steps with ``--device cpu``, the eval grid of two checkpoints, the CSVs' names and
columns (the JAX CSVs'), each seed's ``args.json`` and the set's record."""

from __future__ import annotations

import csv
import json
import subprocess
import sys

from head_to_head_support import REPO, h2h, jax_header


def test_study_rehearsal_on_the_cpu(tmp_path, monkeypatch):
    # the CLIs it starts on one intra-op thread each, as test_torch_parallel.py's ranks:
    # under a busy xdist run their default of one thread a core oversubscribes the host
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    ds = tmp_path / "ds"
    subprocess.run([sys.executable, h2h.MAKE_SET, "--out", str(ds), "--n_alphabets", "2",
                    "--n_chars", "3", "--val_alphabets", "1", "--imgs_per_class", "12",
                    "--img_size", "16"], check=True, cwd=REPO, capture_output=True)
    assert not h2h.build_set(str(ds))  # a set is there: nothing to build
    out, csvs = tmp_path / "runs", tmp_path / "csv"
    monkeypatch.chdir(REPO)
    h2h.main(["--device", "cpu", "--ds_root", str(ds), "--outdir", str(out), "--csv_dir",
                 str(csvs), "--seeds", "2", "--n_steps", "3", "--save_every", "2",
                 "--eval_steps", "2", "3", "800"])
    assert sorted(p.name for p in csvs.iterdir()) == [
        "port_hard_s2_args.json", "port_hard_s2_eval_00000002.csv",
        "port_hard_s2_eval_00000003.csv", "port_hard_set.json"]
    for step in (2, 3):
        with open(csvs / f"port_hard_s2_eval_{step:08d}.csv", newline="") as f:
            lines = list(csv.reader(f))
        assert lines[0] == jax_header()
        assert [line[1:3] for line in lines[1:]] == [["gim", im] for im in h2h.ATTACKERS]
        assert all(0.0 <= float(line[-1]) <= 1.0 for line in lines[1:])
        assert all(line[4] == str(out / "seed_2") for line in lines[1:])
    args = json.loads((csvs / "port_hard_s2_args.json").read_text())
    assert (args["seed"], args["n_steps"], args["img_size"], args["style_dim"],
            args["batch_size"], args["compute_dtype"]) == (2, 3, 16, 64, 16, "bfloat16")
    record = json.loads((csvs / "port_hard_set.json").read_text())
    assert record["command"] == ["python", h2h.MAKE_SET, "--out", str(ds)]
    assert (record["sha256_paths_and_pixels"], record["images"]) == h2h.set_digest(str(ds))
    assert record["images"] == 2 * 3 * 12
    assert sorted(p.name for p in (out / "seed_2" / "ckpts").iterdir()) == [
        "model_00000002", "model_00000003"]
