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
* The flagship bar's deltas and bands from the committed CSVs and its verdict on
  each side of every band edge, the commands ``--cards`` builds, and
  ``run_training``'s scoring, steps/s and stops on a stand-in CLI.

The rehearsals of the whole script at a tiny size are in
``test_torch_head_to_head_study.py`` (the glyph study) and
``test_torch_head_to_head_vox.py`` and ``test_torch_head_to_head_flagship.py``.
"""

from __future__ import annotations

import csv
import importlib.util
import json
import os
import re
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from head_to_head_support import DOCS, REPO, h2h, jax_header, write_port_csv


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


# the flagship bar's bands, written before any run of the port at this config:
# the JAX run's reading at the step +- delta, the upper edge at most 1
FLAG_BANDS = {
    (5000, "gim"): (0.5831, 0.8071), (5000, "replay"): (0.9295, 1.0),
    (5000, "rnd_src"): (0.4598, 0.8358), (10000, "gim"): (0.6356, 0.8596),
    (10000, "replay"): (0.9496, 1.0), (10000, "rnd_src"): (0.6226, 0.9986)}


def flag_checks(tmp_path, aucs_at: dict) -> tuple:
    """The flagship bar's checks and report over port CSVs of seed 1 with
    ``aucs_at[step][attacker]``."""
    for step, aucs in aucs_at.items():
        write_port_csv(tmp_path / f"port_flag_s1_eval_{step:08d}.csv", aucs)
    rows = h2h.load_run_aucs(h2h.FLAG, str(tmp_path))
    return (h2h.flag_verdict(rows, h2h.flag_deltas(h2h.load_aucs(str(DOCS))), "jax_pre"),
            h2h.game_report(h2h.FLAG, str(tmp_path), ref="jax_pre"))


def test_flag_deltas_and_bands_of_the_committed_csvs(tmp_path, monkeypatch):
    """delta is the largest seed range of the JAX glyph study's readings at 4999 and
    10000; the bands are the JAX run's readings at 5000 and 10000 +- delta."""
    monkeypatch.chdir(REPO)
    assert h2h.flag_deltas(h2h.load_aucs(str(DOCS))) == {
        "gim": 0.112, "replay": 0.05, "rnd_src": 0.188}
    checks, met = flag_checks(tmp_path, {s: {a: 0.9 for a in h2h.ATTACKERS}
                                         for s in h2h.FLAG_BAR_STEPS})
    assert {(c["step"], c["attacker"]): (round(c["lo"], 4), round(c["hi"], 4))
            for c in checks} == FLAG_BANDS
    assert {(c["seed"], c["cards"]) for c in checks} == {(1, 1)}
    assert not met  # 0.9 is under replay's bands and over gim's


@pytest.mark.parametrize("side", ["inside", "outside"])
@pytest.mark.parametrize("edge", ["lo", "hi"])
@pytest.mark.parametrize("attacker", h2h.ATTACKERS)
@pytest.mark.parametrize("step", h2h.FLAG_BAR_STEPS)
def test_flag_bar_on_synthetic_port_csvs(tmp_path, monkeypatch, step, attacker, edge, side):
    """A reading 1e-4 inside or outside one edge of its band, every other reading
    in the middle of its band.  Replay's upper edge is 1: an AUC above it is no
    reading the grid gives, and the bar refuses it all the same."""
    monkeypatch.chdir(REPO)
    aucs_at = {s: {a: sum(FLAG_BANDS[(s, a)]) / 2 for a in h2h.ATTACKERS}
               for s in h2h.FLAG_BAR_STEPS}
    lo, hi = FLAG_BANDS[(step, attacker)]
    shift = 1e-4 if side == "inside" else -1e-4
    aucs_at[step][attacker] = lo + shift if edge == "lo" else hi - shift
    checks, met = flag_checks(tmp_path, aucs_at)
    assert len(checks) == 6
    assert {(c["step"], c["attacker"]) for c in checks if not c["ok"]} == (
        set() if side == "inside" else {(step, attacker)})
    assert met == (side == "inside")


@pytest.mark.parametrize("game", ["vox", "flagship"])
def test_cards_build_the_one_card_and_the_data_parallel_commands(monkeypatch, game):
    """--cards 1 pins the CLI to the first visible card with the game's loader (vox:
    the device loader, as PR 10's runs); --cards 4 of 4 leaves them visible and
    passes --device_data off; --cards 2 of 4 leaves the first two; on the CPU the
    ranks come from torch.distributed.run; more cards than visible is refused."""
    g = h2h.VOX if game == "vox" else h2h.FLAG
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,2,1,0")
    sizes = ["--img_size", "64", "--style_dim", "512", "--batch_size", "128"]

    def command(cards, device="cuda", visible=("3", "2", "1", "0")):
        return h2h.train_command(g, 1, "ds", "exp", sizes, 27, 2500, True, cards, device,
                                 list(visible))

    tail = ["--seed", "1", "--n_epochs", "27", "--save_every", "2500", "--cudnn_benchmark",
            "1", "--device", "cuda"]
    config = [*h2h.VOX_CONFIG, "--compute_dtype", "bfloat16", "--ds_n_examples_per_cls",
              "20"] if game == "vox" else []
    one_card = ["--device_data", "on"] if game == "vox" else []
    cli = [sys.executable, "-m", h2h.IMG_TRAIN_MODULE, "--dataset_root", "ds", "-o", "exp",
           *config, *sizes]
    cmd, env = command(1)
    assert cmd == cli + one_card + tail
    assert env["CUDA_VISIBLE_DEVICES"] == "3"
    cmd, env = command(4)
    assert cmd == cli + ["--device_data", "off"] + tail
    assert env["CUDA_VISIBLE_DEVICES"] == "3,2,1,0"  # as this process sees them
    cmd, env = command(2)
    assert cmd == cli + ["--device_data", "off"] + tail
    assert env["CUDA_VISIBLE_DEVICES"] == "3,2"
    cmd, env = command(2, "cpu", ["0"])
    assert cmd[:7] == [sys.executable, "-m", "torch.distributed.run", "--standalone",
                       "--nproc_per_node", "2", "-m"]
    assert cmd[7:] == cli[2:] + ["--device_data", "off"] + tail[:-1] + ["cpu"]
    with pytest.raises(SystemExit):
        command(8)


FAKE_CLI = r"""
import os, subprocess, sys, time
exp, rate, mode = sys.argv[1], float(sys.argv[2]), sys.argv[3]
if mode == "hang":  # the child first: a run stopped at its first grids has started it
    child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(120)"])
    print(child.pid, flush=True)
t = time.time() - 1000
for step in (0, 500):
    d = os.path.join(exp, "imgs", "train", "leaked")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{step:08d}.png")
    open(path, "wb").close()
    os.utime(path, (t + step / rate, t + step / rate))
os.makedirs(os.path.join(exp, "ckpts"), exist_ok=True)
open(os.path.join(exp, "ckpts", "model_00000500"), "wb").close()
if mode == "fail":
    sys.exit(3)
if mode == "hang":
    time.sleep(120)
"""


def gone(pid: int) -> bool:
    """The process has ended (a zombie left to an init that does not reap counts)."""
    try:
        return Path(f"/proc/{pid}/stat").read_text().split()[2] == "Z"
    except FileNotFoundError:
        return True


@pytest.mark.parametrize("case", ["ends", "min_rate", "deadline", "fails"])
def test_run_training_scores_checkpoints_and_stops_slow_runs(tmp_path, case):
    """``run_training`` on a stand-in for the CLI that writes two image grids 500
    steps apart (2 steps/s, or 1 where the run is too slow) and a checkpoint: the
    checkpoint is scored once, the steps/s read from the grids' times, and a run
    under ``min_rate`` or past its deadline is stopped with every process it
    started."""
    exp = tmp_path / "exp"
    rate = 1.0 if case == "min_rate" else 2.0
    mode = {"ends": "end", "fails": "fail"}.get(case, "hang")
    cmd = [sys.executable, "-c", FAKE_CLI, str(exp), str(rate), mode]
    scored = []
    log = tmp_path / "run.log"
    t0 = time.perf_counter()
    if case == "fails":
        with pytest.raises(SystemExit):
            h2h.run_training(cmd, dict(os.environ), str(exp), str(log), [500], scored.append,
                             min_rate=1.3, poll=0.1)
        return
    run = h2h.run_training(cmd, dict(os.environ), str(exp), str(log), [500, 1000],
                           scored.append, min_rate=1.3,
                           deadline=3.0 if case == "deadline" else None, poll=0.1)
    assert time.perf_counter() - t0 < 60
    assert scored == [500]
    assert run["stopped"] == {"ends": None}.get(case, case)
    assert run["steps_per_sec"] == pytest.approx(rate)
    assert run["grid_marks"] == [[0, 0.0], [500, pytest.approx(500 / rate)]]
    if mode == "hang":
        child = int(log.read_text().split()[0])
        deadline = time.monotonic() + 10
        while not gone(child) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert gone(child)


def test_committed_vox_reading_at_the_bar_step(monkeypatch):
    """The port's VoxCeleb-shaped runs to step 2500 (one card, the device loader):
    seed 1 with cuDNN's timed algorithms, seed 2 without them.  The JAX CSVs'
    columns, a reading of each attacker, each run's arguments with its record, and
    the bar's verdict on each as `PERF.md` reports it (seed 1's rnd_src above the JAX
    run's range, seed 2's inside)."""
    monkeypatch.chdir(REPO)
    docs = REPO / h2h.VOX_DOCS_DIR
    rows = h2h.load_vox_aucs(str(docs))
    assert {a: sorted(rows[("port", 2500, a)]) for a in h2h.ATTACKERS} == {
        a: [(1, 1), (2, 1)] for a in h2h.ATTACKERS}
    for seed, cudnn_benchmark in ((1, True), (2, False)):
        with open(docs / f"port_hardvox_s{seed}_eval_00002500.csv", newline="") as f, \
                open(REPO / h2h.JAX_VOX_DIR / "eval_step00002500.csv", newline="") as g:
            assert next(csv.reader(f)) == next(csv.reader(g))
        args = json.loads((docs / f"port_hardvox_s{seed}_args.json").read_text())
        assert (args["seed"], args["device_data"], args["cudnn_benchmark"], args["n_epochs"],
                args["save_every"], args["batch_size"], args["reg_param"]) == (
            seed, "on", cudnn_benchmark, 27, 2500, 128, 10.0)
        run = args["study_run"]
        assert (run["cards"], run["stopped"], run["card"]) == (
            1, None, "NVIDIA H100 80GB HBM3, 700.00 W")
        assert [m[0] for m in run["grid_marks"]] == [0, 500, 1000, 1500, 2000, 2500]
    assert {(c["seed"], c["attacker"]): c["ok"] for c in h2h.vox_verdict(rows)} == {
        (1, "gim"): True, (1, "replay"): True, (1, "rnd_src"): False,
        (2, "gim"): True, (2, "replay"): True, (2, "rnd_src"): True}


def test_committed_flagship_readings(monkeypatch):
    """The port's flagship runs on the parent's game code (one card, the CLI's
    defaults): seeds 1 and 2 read at 5000 and 10000; the columns of the JAX run of the
    grids' eval (seed 2's grids with the score moments, as flag_cal's), each run's
    arguments with its record, the set's digest the glyph study's, the bar's verdict
    against both JAX runs as `PERF.md` reports it, and seed 2's score moments."""
    monkeypatch.chdir(REPO)
    docs = REPO / h2h.FLAG_DOCS_DIR
    rows = h2h.load_run_aucs(h2h.FLAG, str(docs))
    for a in h2h.ATTACKERS:
        assert sorted(rows[("port", 5000, a)]) == [(1, 1), (2, 1)]
        assert sorted(rows[("port", 10000, a)]) == [(1, 1), (2, 1)]
    headers = {}
    for name in ("flag100k", "flag_cal"):
        path = (REPO / h2h.JAX_FLAG_DIR / "eval_step00005000.csv" if name == "flag100k"
                else REPO / h2h.JAX_FLAG_CAL_DIR / "cal_eval_00005000.csv")
        with open(path, newline="") as f:
            headers[name] = next(csv.reader(f))
    for path in sorted(docs.glob("port_flag_s*_eval_*.csv")):
        with open(path, newline="") as f:
            want = headers["flag_cal" if path.name.startswith("port_flag_s2") else "flag100k"]
            assert next(csv.reader(f)) == want, path.name
    for seed in (1, 2):
        args = json.loads((docs / f"port_flag_s{seed}_args.json").read_text())
        assert (args["seed"], args["n_epochs"], args["save_every"], args["device_data"],
                args["au_lr"], args["im_lr"], args["env_noise_mapping_lr"], args["img_size"],
                args["style_dim"], args["batch_size"], args["compute_dtype"]) == (
            seed, 26, 5000, "auto", 1e-6, 1e-5, 1e-7, 32, 512, 128, "bfloat16")
        run = args["study_run"]
        assert (run["cards"], run["stopped"], run["card"]) == (
            1, None, "NVIDIA H100 80GB HBM3, 700.00 W")
    assert h2h.set_verdict(str(docs / "port_flag_set.json")).startswith("the glyph")
    deltas = h2h.flag_deltas(h2h.load_aucs(str(DOCS)))
    missed = {ref: sorted((c["step"], c["attacker"], c["seed"])
                          for c in h2h.flag_verdict(rows, deltas, ref) if not c["ok"])
              for ref in ("jax", "jax_pre")}
    assert missed == {
        "jax": [(5000, "gim", 2), (10000, "gim", 1), (10000, "gim", 2), (10000, "replay", 1),
                (10000, "rnd_src", 2)],
        "jax_pre": [(5000, "gim", 1), (5000, "gim", 2), (10000, "gim", 1),
                    (10000, "replay", 1), (10000, "rnd_src", 2)]}
    assert len(h2h.flag_verdict(rows, deltas)) == 12
    # the scores' scale: seed 2's real scores at 10000 against the JAX run's
    moments = h2h.load_run_moments(h2h.FLAG, str(docs))
    port_real_std = moments[("port", 10000, "gim")][(2, 1)][1]
    jax_real_std = moments[("jax", 10000, "gim")][0][1]
    assert (round(port_real_std, 4), round(jax_real_std, 4)) == (0.0050, 0.3024)
    for step in (5000, 10000):
        for a in h2h.ATTACKERS:
            assert np.load(docs / f"port_flag_s2_scores_{step:08d}" / f"scores_gim_{a}.npz")[
                "score_real"].shape == (300,)


def test_committed_noise_draw_readings(monkeypatch):
    """Seed 1 to 10000 on the tree whose bf16 noise takes ``jax.random.normal``'s values
    (``docs/flagship_head_to_head/noise_draw/``): the flag_cal run's columns, the
    run's record, its verdict against flag_cal as `PERF.md` reports it, and its scores
    at the init scale."""
    monkeypatch.chdir(REPO)
    docs = REPO / h2h.FLAG_DOCS_DIR / "noise_draw"
    rows = h2h.load_run_aucs(h2h.FLAG, str(docs))
    with open(REPO / h2h.JAX_FLAG_CAL_DIR / "cal_eval_00005000.csv", newline="") as f:
        header = next(csv.reader(f))
    for step in h2h.FLAG_BAR_STEPS:
        assert all(list(rows[("port", step, a)]) == [(1, 1)] for a in h2h.ATTACKERS)
        with open(docs / f"port_flag_s1_eval_{step:08d}.csv", newline="") as f:
            assert next(csv.reader(f)) == header
    args = json.loads((docs / "port_flag_s1_args.json").read_text())
    assert (args["seed"], args["n_epochs"], args["compute_dtype"], args["study_run"]["card"],
            args["study_run"]["stopped"]) == (1, 26, "bfloat16",
                                              "NVIDIA H100 80GB HBM3, 700.00 W", None)
    checks = h2h.flag_verdict(rows, h2h.flag_deltas(h2h.load_aucs(str(DOCS))))
    assert sorted((c["step"], c["attacker"]) for c in checks if not c["ok"]) == [
        (5000, "gim"), (10000, "gim"), (10000, "replay")]
    moments = h2h.load_run_moments(h2h.FLAG, str(docs))
    assert all(moments[("port", step, "gim")][(1, 1)][1] < 0.02
               for step in h2h.FLAG_BAR_STEPS)  # real scores' std; flag_cal's 0.11, 0.30


# the flagship bar's bands on the JAX run of the package's current game code
# (docs/flag_cal/): its reading at the step +- delta, the upper edge at most 1
FLAG_CAL_BANDS = {
    (5000, "gim"): (0.3761, 0.6001), (5000, "replay"): (0.95, 1.0),
    (5000, "rnd_src"): (0.4176, 0.7936), (10000, "gim"): (0.8496, 1.0),
    (10000, "replay"): (0.9498, 1.0), (10000, "rnd_src"): (0.5970, 0.9730)}


def write_cal_csv(path: Path, aucs: dict, moments: dict) -> None:
    """A CSV in the layout of the eval CLI with ``--calibrate_q`` (the flag_cal run's
    columns) with the given AUC and (real mean, real std, fake mean, fake std) per
    attacker."""
    with open(REPO / h2h.JAX_FLAG_CAL_DIR / "cal_eval_00005000.csv", newline="") as f:
        header = next(csv.reader(f))
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        for i, (im, auc) in enumerate(aucs.items()):
            row = dict.fromkeys(header, 0.5)
            row.update({"": i, "au_type": "gim", "im_type": im, "ds_root": "ds",
                        "gim_exp_dir": "exp", "m": 1, "n": 5, "k": 5, "auc": auc})
            row.update(zip(h2h.MOMENTS, moments[im]))
            w.writerow([row[c] for c in header])


def test_flag_cal_bands_and_moments_of_the_committed_csvs(tmp_path, monkeypatch):
    """The bar on the flag_cal run: its readings at 5000 and 10000 +- delta; its score
    moments read from its grids (JAX at 10000: real +0.4530 +- 0.3024, gim fake
    -0.7372 +- 0.6960)."""
    monkeypatch.chdir(REPO)
    for step in h2h.FLAG_BAR_STEPS:
        write_port_csv(tmp_path / f"port_flag_s1_eval_{step:08d}.csv",
                       {a: 0.9 for a in h2h.ATTACKERS})
    rows = h2h.load_run_aucs(h2h.FLAG, str(tmp_path))
    checks = h2h.flag_verdict(rows, h2h.flag_deltas(h2h.load_aucs(str(DOCS))))
    assert {(c["step"], c["attacker"]): (round(c["lo"], 4), round(c["hi"], 4))
            for c in checks} == FLAG_CAL_BANDS
    moments = h2h.load_run_moments(h2h.FLAG)
    assert {k[1] for k in moments if k[0] == "jax"} == {0, *range(5000, 66000, 5000), 66000}
    assert not any(k[0] == "jax_pre" for k in moments)  # flag100k_hard has no moments
    real_mean, real_std, fake_mean, fake_std = moments[("jax", 10000, "gim")][0]
    assert (round(real_mean, 4), round(real_std, 4), round(fake_mean, 4),
            round(fake_std, 4)) == (0.4530, 0.3024, -0.7372, 0.6960)


@pytest.mark.parametrize("side", ["inside", "outside"])
@pytest.mark.parametrize("edge", ["lo", "hi"])
@pytest.mark.parametrize("attacker", h2h.ATTACKERS)
@pytest.mark.parametrize("step", h2h.FLAG_BAR_STEPS)
def test_flag_cal_bar_on_synthetic_port_csvs(tmp_path, monkeypatch, step, attacker, edge,
                                             side):
    """A reading 1e-4 inside or outside one edge of its flag_cal band, every other
    reading in the middle of its band: the report's verdict on the flag_cal bar (its
    default), and every reading checked against both JAX runs."""
    monkeypatch.chdir(REPO)
    aucs_at = {s: {a: sum(FLAG_CAL_BANDS[(s, a)]) / 2 for a in h2h.ATTACKERS}
               for s in h2h.FLAG_BAR_STEPS}
    lo, hi = FLAG_CAL_BANDS[(step, attacker)]
    shift = 1e-4 if side == "inside" else -1e-4
    aucs_at[step][attacker] = lo + shift if edge == "lo" else hi - shift
    for s, aucs in aucs_at.items():
        write_port_csv(tmp_path / f"port_flag_s1_eval_{s:08d}.csv", aucs)
    rows = h2h.load_run_aucs(h2h.FLAG, str(tmp_path))
    checks = h2h.flag_verdict(rows, h2h.flag_deltas(h2h.load_aucs(str(DOCS))))
    assert len(checks) == 6
    assert {(c["step"], c["attacker"]) for c in checks if not c["ok"]} == (
        set() if side == "inside" else {(step, attacker)})
    assert h2h.game_report(h2h.FLAG, str(tmp_path)) == (side == "inside")
    assert len(h2h.flag_verdict(rows, h2h.flag_deltas(h2h.load_aucs(str(DOCS))),
                                "jax_pre")) == 6


def test_flagship_report_prints_both_bars_and_the_moments(tmp_path, monkeypatch, capsys):
    """``--flagship --report`` over a bf16 and an f32 run with moments (and the committed
    runs): each reading
    against flag_cal and flag100k_hard (labelled pre-dbb161f), the f32 run under its
    own label, and the GIM authenticator's score moments beside flag_cal's."""
    monkeypatch.chdir(REPO)
    moments = {"gim": (0.45, 0.3, -0.7, 0.7), "replay": (0.45, 0.3, -1.4, 0.5),
               "rnd_src": (0.45, 0.3, -0.3, 0.9)}
    aucs = {"gim": 0.9616, "replay": 0.9998, "rnd_src": 0.785}
    write_cal_csv(tmp_path / "port_flag_s7_eval_00010000.csv", aucs, moments)
    write_cal_csv(tmp_path / "port_flag_s7_f32_eval_00010000.csv",
                  dict(aucs, gim=0.5), moments)
    h2h.main(["--flagship", "--report", "--csv_dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert ("| 10000 | port s7, 1 card | +0.4500 ± 0.3000 | -0.7000 ± 0.7000 | "
            "-1.4000 ± 0.5000 | -0.3000 ± 0.9000 |") in out
    assert ("| 10000 | JAX | +0.4530 ± 0.3024 | -0.7372 ± 0.6960 | -1.4390 ± 0.4720 | "
            "-0.2890 ± 0.8760 |") in out
    assert ("bar step 10000 gim port s7, 1 card: port 0.9616, JAX 0.9616 +- 0.112 = "
            "[0.8496, 1.0000]: inside") in out
    assert ("bar step 10000 gim port f32 s7, 1 card: port 0.5000, JAX 0.9616 +- 0.112 = "
            "[0.8496, 1.0000]: MISSED") in out
    assert ("bar step 10000 gim port s7, 1 card: port 0.9616, JAX pre-dbb161f 0.7476 +- "
            "0.112 = [0.6356, 0.8596]: MISSED") in out
    # with the committed runs' readings (the report reads docs/flagship_head_to_head too)
    n = 6 + len(h2h.flag_verdict(h2h.load_run_aucs(h2h.FLAG, h2h.FLAG_DOCS_DIR),
                                 h2h.flag_deltas(h2h.load_aucs(str(DOCS)))))
    assert f"bar (JAX): missed or not read at {n} readings" in out
    assert f"bar (JAX pre-dbb161f): missed or not read at {n} readings" in out


@pytest.mark.parametrize("compute_dtype", [None, "float32"])
@pytest.mark.parametrize("cards", [1, 4])
def test_flagship_file_names_and_eval_command(compute_dtype, cards):
    """An f32 run's files end its tag in ``_f32`` and read back as the "port_f32" run;
    the flagship's grid writes the moments at ``--calibrate_q 0.95`` and the raw scores
    beside its CSV, the vox grid neither."""
    tag = h2h.run_tag(1, cards, compute_dtype)
    assert tag == "s1" + ("_cards4" if cards == 4 else "") + (
        "_f32" if compute_dtype else "")
    path = h2h.run_csv_path(h2h.FLAG, "out", 1, cards, 5000, compute_dtype)
    assert path == f"out/port_flag_{tag}_eval_00005000.csv"
    m = h2h.RUN_CSV_NAME.search(path)
    assert h2h.PORT_IMPLS[bool(m.group(4))] == ("port_f32" if compute_dtype else "port")
    assert h2h.scores_dir(path) == f"out/port_flag_{tag}_scores_00005000"
    cmd = h2h.eval_command(h2h.FLAG, "exp", path, 5000, "ds", "cuda", 32)
    assert cmd[:3] == [sys.executable, "-m", h2h.EVAL_MODULE]
    assert cmd[-4:] == ["--calibrate_q", "0.95", "--dump_scores_dir", h2h.scores_dir(path)]
    vox = h2h.eval_command(h2h.VOX, "exp", "out/port_hardvox_s1_eval_00002500.csv", 2500,
                           "ds", "cuda", 64)
    assert "--calibrate_q" not in vox and "--dump_scores_dir" not in vox
    assert vox[-2:] == ["--device", "cuda"]
