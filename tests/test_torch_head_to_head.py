"""The hard-glyph head-to-head script, ``scripts/torch_hard_head_to_head.py``, on the CPU.

* The aggregation reads the committed JAX CSVs (``docs/hard_head_to_head/``)
  into the means the JAX studies recorded, and its table has one row per step
  and implementation.
* The bar (the port's mean AUC over its seeds inside the JAX seeds' [min, max]
  at each bar step, at 3 decimals) passes and fails on synthetic ``port_`` CSVs.
* The pooled statistic (every reading past step 1200 through 4999, each
  attacker's share under a threshold and Mann-Whitney tests) on synthetic CSVs
  against scipy on the same readings, and the readings it pools from the
  committed CSVs.
* The set's digest reads pixels, not PNG bytes.
* A rehearsal of the whole script at a tiny size: a few classes of 16 px from
  ``scripts/make_hard_glyph_ds.py``, 3 training steps with ``--device cpu``, the
  eval grid of two checkpoints, the CSVs' names and columns (the JAX CSVs'),
  each seed's ``args.json`` and the set's record.
"""

from __future__ import annotations

import csv
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
DOCS = REPO / "docs" / "hard_head_to_head"
SPEC = importlib.util.spec_from_file_location(
    "torch_hard_head_to_head", REPO / "scripts" / "torch_hard_head_to_head.py")
h2h = importlib.util.module_from_spec(SPEC)
SPEC.loader.exec_module(h2h)


def jax_header() -> list:
    with open(DOCS / "jax_hard_s2_eval_00004999.csv", newline="") as f:
        return next(csv.reader(f))


def write_port_csv(path: Path, aucs: dict) -> None:
    """A CSV in the eval CLI's layout with the given AUC per attacker."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(jax_header())
        for i, (im, auc) in enumerate(aucs.items()):
            w.writerow([i, "gim", im, "ds", "exp", 1, 5, 5, 0.5, 0.5, 0.5, auc])


def recorded() -> dict:
    """The committed readings of the JAX package and of the original PyTorch code."""
    return {k: v for k, v in h2h.load_aucs(str(DOCS)).items() if k[0] != "port"}


def test_jax_csvs_aggregate_to_the_recorded_means():
    rows = recorded()
    means = {a: round(float(np.mean(list(rows[("jax", 4999, a)].values()))), 3)
             for a in h2h.ATTACKERS}
    assert means == {"gim": 0.996, "replay": 0.983, "rnd_src": 0.645}
    assert sorted(rows[("jax", 4999, "gim")]) == [2, 3, 4]
    assert sorted(rows[("jax", 400, "gim")]) == [2, 3, 4, 7, 8, 9]
    assert sorted(rows[("ref", 400, "gim")]) == [2, 3, 4, 5, 6]
    lines = h2h.table(rows)
    assert "| 4999 | jax | 0.996 (0.990..1.000, 3) | 0.983 (0.950..1.000, 3) | " \
           "0.645 (0.570..0.708, 3) |" in lines
    assert "| 400 | jax | 0.995 (0.969..1.000, 6) | 1.000 (1.000..1.000, 6) | " \
           "0.532 (0.507..0.548, 6) |" in lines
    assert not any("| port |" in line for line in lines)
    assert h2h.verdict(rows) == []  # no port reading: nothing to hold


@pytest.mark.parametrize("case", ["inside", "rnd_src_400_low", "replay_2000_rounds_in"])
def test_bar_on_synthetic_port_csvs(tmp_path, case):
    jax = recorded()
    want_ok = {}
    for step in h2h.BAR_STEPS:
        for seed in (2, 3, 4):
            aucs = {}
            for a in h2h.ATTACKERS:
                vals = list(jax[("jax", step, a)].values())
                aucs[a] = (min(vals) + max(vals)) / 2
                want_ok[(step, a)] = True
            if case == "rnd_src_400_low" and step == 400:
                aucs["rnd_src"] = 0.5  # under JAX's 0.507
                want_ok[(step, "rnd_src")] = False
            if case == "replay_2000_rounds_in" and step == 2000:
                aucs["replay"] = 0.9996  # JAX s4 read 0.99964: both print 1.000
            write_port_csv(tmp_path / f"port_hard_s{seed}_eval_{step:08d}.csv", aucs)
        # another seed does not enter the bar's mean
        write_port_csv(tmp_path / f"port_hard_s7_eval_{step:08d}.csv",
                       {a: 0.0 for a in h2h.ATTACKERS})
    rows = {**jax, **h2h.load_aucs(str(tmp_path))}
    checks = h2h.verdict(rows)
    assert {(c["step"], c["attacker"]): c["ok"] for c in checks} == want_ok
    assert all(c["port_seeds"] == [2, 3, 4] for c in checks)
    assert {c["jax_n"] for c in checks if c["step"] < 4999} == {6}
    assert {c["jax_n"] for c in checks if c["step"] == 4999} == {3}
    assert h2h.report(rows) == (case != "rnd_src_400_low")


@pytest.mark.parametrize("shift", [0.0, 0.05])
def test_pooled_statistic_on_synthetic_csvs(tmp_path, shift):
    """Readings past step 1200 through 4999 pool over seeds and steps; the shares
    under each threshold and the Mann-Whitney tests are those of the readings."""
    from scipy.stats import mannwhitneyu

    rng = np.random.default_rng(0)
    dirs = {name: tmp_path / name for name in ("jax", "port")}
    want = {name: {a: [] for a in h2h.ATTACKERS} for name in dirs}
    for name, d in dirs.items():
        d.mkdir()
        impl = "jax" if name == "jax" else "port"
        for seed in (2, 3, 4, 7):
            for step in (1200, 2000, 3600, 4999, 10000):
                aucs = {a: float(np.clip(0.93 + 0.05 * rng.random()
                                         - (shift if name == "port" else 0.0), 0, 1))
                        for a in h2h.ATTACKERS}
                write_port_csv(d / f"{impl}_hard_s{seed}_eval_{step:08d}.csv", aucs)
                if 1200 < step <= 4999:
                    for a, v in aucs.items():
                        want[name][a].append(v)
    groups = {"jax": (h2h.load_aucs(str(dirs["jax"])), "jax"),
              "port": (h2h.load_aucs(str(dirs["port"])), "port")}
    stats = h2h.pooled_statistic(groups)
    for a in h2h.ATTACKERS:
        for name in dirs:
            s = next(s for s in stats if s.get("group") == name and s["attacker"] == a)
            v = np.asarray(want[name][a])
            assert (s["n"], s["seeds"]) == (12, 4)
            assert s["under"] == int((v < h2h.POOL_THRESHOLDS[a]).sum())
        t = next(s for s in stats if s.get("test") == "port vs jax" and s["attacker"] == a)
        test = mannwhitneyu(want["port"][a], want["jax"][a], alternative="two-sided")
        assert t["p_readings"] == pytest.approx(test.pvalue)
        assert t["u_share"] == pytest.approx(test.statistic / 144)
        if shift:  # every port reading under every JAX reading
            assert t["u_share"] == 0.0 and t["p_readings"] < 1e-4
    # the pairs of POOL_TESTS with a group missing are left out
    assert not any(s.get("test", "").endswith("parent") for s in stats)


def test_pooled_statistic_of_the_committed_csvs():
    """Every reading past 1200 of the committed CSVs enters: JAX seeds 2-4 at 2000
    and 4999 and seeds 7-9 at 2000-4800; the port's six seeds at six steps and the
    spread's five seeds at 2000, on either tree."""
    stats = h2h.pooled_statistic({name: (h2h.load_aucs(*(str(REPO / d) for d in dirs)), impl)
                                  for name, (impl, dirs) in h2h.POOL_GROUPS.items()})
    counts = {(s["group"], s["attacker"]): (s["n"], s["seeds"]) for s in stats if "group" in s}
    assert set(counts.values()) == {(21, 6), (41, 11)}
    assert all(counts[("jax", a)] == (21, 6) for a in h2h.ATTACKERS)
    assert len([s for s in stats if "test" in s]) == 3 * len(h2h.POOL_TESTS)


def test_committed_port_csvs_cover_every_bar_reading():
    """The port's study CSVs: seeds 2-4 at every bar step, the JAX CSVs' columns, a
    reading of each attacker, and each seed's arguments beside them."""
    rows = h2h.load_aucs(str(DOCS))
    for step in h2h.BAR_STEPS:
        for a in h2h.ATTACKERS:
            assert {2, 3, 4} <= set(rows[("port", step, a)]), (step, a)
        with open(DOCS / f"port_hard_s2_eval_{step:08d}.csv", newline="") as f:
            assert next(csv.reader(f)) == jax_header()
    for seed in (2, 3, 4):
        args = json.loads((DOCS / f"port_hard_s{seed}_args.json").read_text())
        assert (args["seed"], args["n_steps"], args["compute_dtype"]) == (seed, 4999, "bfloat16")


def test_set_digest_reads_pixels_not_png_bytes(tmp_path):
    from PIL import Image

    root = tmp_path / "ds"
    pix = np.random.default_rng(0).integers(0, 256, (2, 16, 16), dtype=np.uint8)
    for i, p in enumerate(pix):
        d = root / "val" / "Alphabet00" / f"id{i:03d}"
        d.mkdir(parents=True)
        Image.fromarray(p).save(d / "0000.png", compress_level=9)
    first = h2h.set_digest(str(root))
    Image.fromarray(pix[0]).save(root / "val/Alphabet00/id000/0000.png", compress_level=0)
    assert h2h.set_digest(str(root)) == first
    assert first[1] == 2
    Image.fromarray(pix[0] ^ 1).save(root / "val/Alphabet00/id000/0000.png")
    assert h2h.set_digest(str(root))[0] != first[0]


def test_study_rehearsal_on_the_cpu(tmp_path, monkeypatch):
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


@pytest.mark.parametrize("script", ["torch_hard_head_to_head.py", "torch_bf16_parts.py"])
def test_study_scripts_import_no_jax(script):
    """Both run on the card host, which has no JAX."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax"
                         r"|optimalstrategiesagainstgenerativeattacks_tpu)\b")
    source = (REPO / "scripts" / script).read_text().splitlines()
    assert [line for line in source if pattern.match(line)] == []


def test_bf16_parts_runs_the_named_submodules_in_f32():
    import torch

    from optimalstrategiesagainstgenerativeattacks_torch.nn.init import init_module
    from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg
    from optimalstrategiesagainstgenerativeattacks_torch.utils.config import ImageGameConfig

    spec = importlib.util.spec_from_file_location("torch_bf16_parts",
                                                  REPO / "scripts" / "torch_bf16_parts.py")
    parts = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parts)
    cfg = ImageGameConfig(img_size=16, style_dim=32, m=1, n=2, k=2, batch_size=2)
    build = parts.with_f32_parts(timg.build_models, ["im.env_decoder.up_0", "au.dis"])
    au, im = build(cfg)
    assert im.env_decoder.up_0.conv_l1.dtype is None
    assert im.env_decoder.up_1.conv_l1.dtype == torch.bfloat16
    assert au.dis.mlp.layers[0].dtype is None
    assert au.encoders.src.down_0.conv_l1.dtype == torch.bfloat16
    init_module(im, torch.Generator().manual_seed(0))
    with torch.no_grad():
        fake = im(torch.rand(2, 1, 16, 16, 1).to(torch.bfloat16) * 2 - 1, cfg.n)
    assert fake.shape == (2, 2, 16, 16, 1) and torch.isfinite(fake.float()).all()
    with pytest.raises(SystemExit):
        parts.with_f32_parts(timg.build_models, ["env_decoder"])(cfg)


def test_bf16_parts_rounds_the_named_sites_and_restores_the_blocks():
    import torch

    from optimalstrategiesagainstgenerativeattacks_torch.nn import blocks

    spec = importlib.util.spec_from_file_location("torch_bf16_parts",
                                                  REPO / "scripts" / "torch_bf16_parts.py")
    parts = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parts)
    x, style = torch.randn(2, 4, 8, 8), torch.randn(2, 6)

    def dtypes():
        down = blocks.ResBlockDown(4, 8, dtype=torch.bfloat16)
        up = blocks.AdaResBlockUp2(4, 8, 6, dtype=torch.bfloat16)
        conv = blocks.SNConv(4, 8, 3, padding=1, dtype=torch.bfloat16, f32_out=True)
        return down(x).dtype, up(x, style).dtype, conv.f32_out

    assert dtypes() == (torch.float32, torch.float32, True)
    with parts.rounded_sites(list(parts.ROUND_GROUPS)):
        assert dtypes() == (torch.bfloat16, torch.bfloat16, False)
    with parts.rounded_sites(["up_sums"]):
        assert dtypes() == (torch.float32, torch.bfloat16, True)
    assert dtypes() == (torch.float32, torch.float32, True)


@pytest.mark.parametrize("n_steps,cudnn_benchmark", [(3, False), (5, True)])
def test_vox_rehearsal_on_the_cpu(tmp_path, monkeypatch, n_steps, cudnn_benchmark):
    """The --vox mode at a tiny size: a few identities of 16 px from
    ``scripts/make_hard_vox_ds.py`` (5 steps an epoch), the port's CLI for
    ``n_steps`` steps (on to the epoch's end; 5 ends an epoch, where the loop,
    which numbers its steps from 0, would stop one short), the eval CLI's grid of
    the checkpoint at ``n_steps``, and ``--report`` over the committed CSVs with
    the bar's verdict."""
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
