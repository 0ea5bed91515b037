"""A rehearsal of ``scripts/torch_hard_head_to_head.py --vox`` on the CPU at a tiny
size: the set, the port's CLI, the eval CLI's grid of the checkpoint, the CSVs' names
and columns, the copied arguments, and the bar's verdict."""

from __future__ import annotations

import csv
import json
import subprocess
import sys

import pytest

from head_to_head_support import REPO, h2h, write_port_csv


@pytest.mark.parametrize("n_steps,cudnn_benchmark", [(3, False), (5, True)])
def test_vox_rehearsal_on_the_cpu(tmp_path, monkeypatch, n_steps, cudnn_benchmark):
    """The --vox mode at a tiny size: a few identities of 16 px from
    ``scripts/make_hard_vox_ds.py`` (5 steps an epoch), the port's CLI for
    ``n_steps`` steps (on to the epoch's end; 5 ends an epoch, where the loop,
    which numbers its steps from 0, would stop one short), the eval CLI's grid of
    the checkpoint at ``n_steps``, and ``--report`` over the committed CSVs with
    the bar's verdict."""
    # the CLIs it starts on one intra-op thread each, as test_torch_parallel.py's ranks:
    # under a busy xdist run their default of one thread a core oversubscribes the host
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    ds = tmp_path / "ds"
    subprocess.run([sys.executable, h2h.MAKE_VOX_SET, "--out", str(ds), "--n_identities", "4",
                    "--val_identities", "2", "--videos_per_identity", "2",
                    "--frames_per_video", "12", "--img_size", "16"],
                   check=True, cwd=REPO, capture_output=True)
    out, csvs = tmp_path / "runs", tmp_path / "csv"
    monkeypatch.chdir(REPO)
    h2h.main(["--vox", "--device", "cpu", "--ds_root", str(ds), "--outdir", str(out),
              "--csv_dir", str(csvs), "--n_steps", str(n_steps), "--img_size", "16",
              "--style_dim", "32", "--batch_size", "16"]
             + (["--cudnn_benchmark"] if cudnn_benchmark else []))
    grid = f"port_hardvox_s1_eval_{n_steps:08d}.csv"
    assert sorted(p.name for p in csvs.iterdir()) == [
        "port_hardvox_s1_args.json", grid, "port_hardvox_set.json"]
    with open(csvs / grid, newline="") as f:
        lines = list(csv.reader(f))
    with open(REPO / h2h.JAX_VOX_DIR / "eval_step00002500.csv", newline="") as f:
        assert lines[0] == next(csv.reader(f))
    assert [line[1:3] for line in lines[1:]] == [["gim", im] for im in h2h.ATTACKERS]
    assert all(0.0 <= float(line[-1]) <= 1.0 for line in lines[1:])
    args = json.loads((csvs / "port_hardvox_s1_args.json").read_text())
    assert (args["dataset_type"], args["img_channels"], args["reg_param"], args["au_lr"],
            args["im_lr"], args["env_noise_mapping_lr"], args["compute_dtype"],
            args["device_data"], args["seed"], args["cudnn_benchmark"]) == (
        "voxceleb2", 3, 10.0, 1e-4, 1e-4, 1e-6, "bfloat16", "on", 1, cudnn_benchmark)
    assert args["ds_n_examples_per_cls"] * 2 * 2 // 16 == 5  # steps an epoch
    record = json.loads((csvs / "port_hardvox_set.json").read_text())
    assert (record["sha256_paths_and_pixels"], record["images"]) == h2h.set_digest(str(ds), "jpg")
    assert record["images"] == 4 * 2 * 12
    assert f"model_{n_steps:08d}" in {p.name for p in (out / "seed_1" / "ckpts").iterdir()}
    # the bar: the port's reading at step 2500 against the JAX run's six
    rows = h2h.load_vox_aucs(str(csvs))
    assert {k[1] for k in rows if k[0] == "jax"} == {2500, 5000, 7500, 10000, 12500, 14879}
    assert h2h.vox_verdict(rows) == []  # no port reading at step 2500
    write_port_csv(tmp_path / "port_hardvox_s1_eval_00002500.csv",
                   {"gim": 0.99, "replay": 0.99, "rnd_src": 0.6})
    checks = h2h.vox_verdict(h2h.load_vox_aucs(str(tmp_path)))
    assert {c["attacker"]: c["ok"] for c in checks} == {
        "gim": True, "replay": False, "rnd_src": True}  # replay under the JAX run's 0.9935
    assert round(checks[1]["jax_min"], 4) == 0.9935
    h2h.main(["--vox", "--report", "--csv_dir", str(tmp_path)])
