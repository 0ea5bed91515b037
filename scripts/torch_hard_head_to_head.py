"""The hard-glyph head-to-head on the port: build the set, train seeds at the
multi-seed CLI's defaults, score each checkpoint with the port's eval grid, and
hold the port's AUCs to the JAX package's recorded ones.

    python scripts/torch_hard_head_to_head.py [--seeds 2 3 4] [--device cuda|cpu]
        [--ds_root build/hard_glyphs32] [--outdir build/hard_head_to_head]
        [--csv_dir docs/hard_head_to_head] [--n_steps 4999] [--save_every 400]
        [--eval_steps 400 800 ...]
    python scripts/torch_hard_head_to_head.py --report   # the table and the bar only
    python scripts/torch_hard_head_to_head.py --vox [--seeds 1] [--n_steps 2500] [--cards N] ...
    python scripts/torch_hard_head_to_head.py --vox --report
    python scripts/torch_hard_head_to_head.py --flagship [--seeds 1] [--n_steps 10000] [--cards N] ...
    python scripts/torch_hard_head_to_head.py --flagship --report

1. The set: ``scripts/make_hard_glyph_ds.py`` with its own defaults (28
   alphabets x 20 characters, 3 alphabets for val, 20 images a class, 32 px,
   seed 0), run as a subprocess when ``--ds_root`` holds no set.  Its digest
   (SHA-256 over every image's path and decoded pixels) goes into
   ``<csv_dir>/port_hard_set.json`` beside the command, so that a later run can
   show it used the same set.
2. Training: the multi-seed CLI (``train_multiseed_gim_on_imgs``) at its
   defaults, which are the JAX studies' config (img 16, style 64, B16, m1 n5 k5,
   bf16, lr 1e-4 / 1e-4 / 1e-6), one process a seed, all started together: the
   step is host-bound and the loop steps its seeds one after another, so
   separate processes use separate host cores.  A seed's result does not
   depend on the others'.  Checkpoints land every ``--save_every`` steps and
   at ``--n_steps``.  Each seed's log is ``<outdir>/seed_<s>.log``.
3. Eval: ``eval_authentication_task`` on the val split at the trained image
   size (the flags of ``scripts/eval_hard_seeds.sh``), for each
   ``--eval_steps`` checkpoint that exists, into
   ``<csv_dir>/port_hard_s<seed>_eval_<step:08d>.csv``; each seed's
   ``args.json`` is copied to ``<csv_dir>/port_hard_s<seed>_args.json``.
4. The table of ``jax_``, ``ref_`` and ``port_`` CSVs in ``--csv_dir`` (and
   ``docs/hard_head_to_head``), then the bar: at each of ``BAR_STEPS``, for
   each attacker, the mean AUC of the port's seeds 2-4 lies inside the JAX
   seeds' [min, max] at that step, both rounded to 3 decimals as the table
   prints them; and, where the port has them, seeds 7-9 against the JAX
   seeds 7-9 at each step of theirs through 4800.
5. The pooled statistic (``--report``): every (seed, step) reading past step
   1200 through 4999, pooled over seeds and steps, of the JAX package, the
   port (``docs/hard_head_to_head`` and ``seed_spread/change``) and the port
   at 747d844 (``parent_747d844`` and ``seed_spread/parent_747d844``, the
   tree before the bf16 site repair).  For each attacker: the share of
   readings under ``POOL_THRESHOLDS`` and a two-sided Mann-Whitney U test of
   each port tree against the JAX readings, and of the two port trees
   against each other, over the readings and over the seeds' means.  One
   seed's readings at several steps are not independent, so the test over
   readings overstates its confidence; the test over seed means does not.

``--vox``: the VoxCeleb-shaped R1 game against the JAX package's hard-vox run
(``docs/hardvox_run/``: one seed of the VoxCeleb2 config, scored every 2500
steps with ``scripts/eval_hardvox_grid.sh``).
1. The set: ``scripts/make_hard_vox_ds.py`` at its defaults (230 identities,
   200 train / 30 val, x 3 videos x 20 frames, 64 px, seed 0) into
   ``build/hard_vox64``; its digest goes into ``<csv_dir>/port_hardvox_set.json``.
2. Training: the port's ``train_gim_on_imgs`` CLI at the VoxCeleb2 config of
   the JAX CLI's docstring (``--dataset_type voxceleb2 --img_size 64
   --img_channels 3 --au_lr 1e-4 --im_lr 1e-4 --env_noise_mapping_lr 1e-6
   --reg_param 10``), B=128, bf16, ``--device_data on``, 20 episodes a class
   an epoch (the JAX run's 14879 steps in 160 epochs are 93 steps an epoch:
   600 train videos x 20 / 128), as many epochs as reach ``--n_steps``, a
   checkpoint at ``--n_steps``; the JAX CLI's defaults otherwise, one process
   a seed, one after another.  ``--cudnn_benchmark`` passes the CLI's
   ``--cudnn_benchmark 1``: cuDNN picks each conv's algorithm by timing it (as
   XLA autotunes the JAX package's convs; runs are then not bit-reproducible):
   on the H100 the VoxCeleb step takes ~1.26 s instead of ~1.52, and 2500
   steps fit one hour.
3. Eval: the port's eval CLI with the flags of ``scripts/eval_hardvox_grid.sh``
   (voxceleb2, 64 px, 3 channels, m1 n5 k5) on the checkpoint at ``--n_steps``,
   into ``<csv_dir>/port_hardvox_s<seed>_eval_<step:08d>.csv``.
4. The table of the JAX run's CSVs and the port's, then the bar at step 2500:
   gim and replay AUC at least the JAX run's lowest over its six checkpoints,
   rnd_src AUC inside its [min, max] over them.

``--flagship``: the flagship game against the JAX package's runs of its CLI's
defaults on the hard glyph set, a grid every 5000 steps: ``docs/flag_cal/``, the run
of the package's current game code (77b1e69..5d543c3, 66k steps, its grids with the
score moments and raw scores), which the bar rests on, and ``docs/flag100k_hard/``,
the 100k-step run of 5752b10, before dbb161f changed the image step's bf16
arithmetic, printed beside it.
1. The set: the glyph study's (``scripts/make_hard_glyph_ds.py`` at its defaults);
   its digest goes into ``<csv_dir>/port_flag_set.json`` and is compared with
   ``docs/hard_head_to_head/port_hard_set.json``.
2. Training: the port's ``train_gim_on_imgs`` CLI at its own defaults, which are
   the JAX run's flags (Omniglot, 32 px, style 512, B=128, bf16, au / im / noise
   lr 1e-6 / 1e-5 / 1e-7, 100 episodes a class an epoch, no milestones), a
   checkpoint every ``--save_every`` (5000) steps, as many epochs as reach
   ``--n_steps`` (10000).
   ``--compute_dtype float32`` trains the f32 game (files ``..._s<seed>_f32_...``).
3. Eval: the port's eval CLI on the val split, 32 px, m1 n5 k5, with
   ``--calibrate_q 0.95`` (the columns of the flag_cal run's CSVs: the score
   moments), into ``<csv_dir>/port_flag_s<seed>_eval_<step:08d>.csv``, the raw
   scores into ``<csv_dir>/port_flag_s<seed>_scores_<step:08d>/``.
4. The bar at steps 5000 and 10000: each attacker's AUC inside the flag_cal run's
   reading +- delta, delta the largest range over seeds of the JAX glyph study's
   readings at steps 4999 and 10000 (gim 0.112, replay 0.050, rnd_src 0.188); the
   same against flag100k_hard's reading beside it, and the GIM authenticator's
   score mean and std beside flag_cal's.

Both modes: ``--cards N`` trains on N cards (``train_command``): 1, the default,
pins the CLI to one card; more leave N visible, and the CLI trains data parallel
at the same global batch with the host loader (``--device_data off``).  A run
with more than one card names its files ``..._s<seed>_cards<N>_...``.  Each
checkpoint is scored as it lands, on one card, while the run goes on, so that a
run stopped by ``--deadline`` keeps the readings it reached.  The run's steps/s
come from the write times of the image grids the CLI writes every 500 steps;
with the cards and the card's name they go into the copied ``args.json`` under
``study_run``.  ``--min_steps_per_sec`` stops a run that trains slower than that
over its first 500 steps.  ``--tpu_precision`` (one card) trains under
``scripts/torch_tpu_precision.py``'s dispatch mode, which computes every f32 product
on bf16 operands, as a TPU's default precision does; the grids score exactly.
"""

from __future__ import annotations

import argparse
import csv
import glob
import hashlib
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import NamedTuple

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

DOCS_DIR = "docs/hard_head_to_head"
MAKE_SET = "scripts/make_hard_glyph_ds.py"
TPU_PRECISION = "scripts/torch_tpu_precision.py"
TRAIN_MODULE = "optimalstrategiesagainstgenerativeattacks_torch.train_multiseed_gim_on_imgs"
ATTACKERS = ("gim", "replay", "rnd_src")
IMPLS = ("ref", "jax", "port")
BAR_STEPS = (400, 800, 1200, 2000, 4999)
BAR_SEEDS = (2, 3, 4)
# seeds 7-9, where the port has them, against the JAX seeds 7-9, which the JAX study
# read every 400 steps to 4800 (no 4999)
LATE_STEPS = (400, 800, 1200, 2000, 2800, 3600, 4400, 4800)
# every step the JAX CSVs of seeds 2-4 or 7-9 have, up to the study's 4999
EVAL_STEPS = (400, 800, 1200, 2000, 2800, 3600, 4400, 4800, 4999)
CSV_NAME = re.compile(r"(jax|ref|port)_hard_s(\d+)_eval_(\d+)\.csv$")

# the pooled statistic: readings past POOL_AFTER through the port's last step
POOL_AFTER, POOL_UNTIL = 1200, 4999
POOL_THRESHOLDS = {"gim": 0.9, "replay": 0.99, "rnd_src": 0.6}
POOL_GROUPS = {  # name: (implementation, CSV directories)
    "jax": ("jax", (DOCS_DIR,)),
    "port": ("port", (DOCS_DIR, DOCS_DIR + "/seed_spread/change")),
    "parent": ("port", (DOCS_DIR + "/parent_747d844",
                        DOCS_DIR + "/seed_spread/parent_747d844")),
}
POOL_TESTS = (("port", "jax"), ("parent", "jax"), ("port", "parent"))

VOX_DOCS_DIR = "docs/hard_vox_head_to_head"
JAX_VOX_DIR = "docs/hardvox_run"  # the JAX run's grids: eval_step<step:08d>.csv
MAKE_VOX_SET = "scripts/make_hard_vox_ds.py"
IMG_TRAIN_MODULE = "optimalstrategiesagainstgenerativeattacks_torch.train_gim_on_imgs"
EVAL_MODULE = "optimalstrategiesagainstgenerativeattacks_torch.eval_gim_on_authentication"
# the VoxCeleb2 config of the JAX CLI's docstring (train_gim_on_imgs.py:7-8)
VOX_CONFIG = ("--dataset_type", "voxceleb2", "--img_channels", "3", "--au_lr", "1e-4",
              "--im_lr", "1e-4", "--env_noise_mapping_lr", "1e-6", "--reg_param", "10")
VOX_EXAMPLES_PER_CLASS = 20  # 93 steps an epoch, as the JAX run's 14879 steps in 160 epochs
VOX_BAR_STEP = 2500
JAX_RUN_CSV_NAME = re.compile(r"eval_step(\d+)\.csv$")
JAX_CAL_CSV_NAME = re.compile(r"cal_eval_(\d+)\.csv$")

FLAG_DOCS_DIR = "docs/flagship_head_to_head"
# the JAX package's flagship runs on the hard glyph set: the run of its current game
# code (77b1e69..5d543c3, grids with the score moments: cal_eval_<step:08d>.csv and
# scores_<step:08d>/), which the bar rests on, and the 100k-step run of 5752b10,
# before dbb161f changed the bf16 arithmetic of the image step (eval_step<step:08d>.csv)
JAX_FLAG_CAL_DIR = "docs/flag_cal"
JAX_FLAG_DIR = "docs/flag100k_hard"
FLAG_CALIBRATE_Q = 0.95  # the eval's --calibrate_q, as the flag_cal run's grids
FLAG_BAR_STEPS = (5000, 10000)
# the JAX glyph study's readings whose largest seed range is the flagship bar's delta
FLAG_DELTA_STEPS = (4999, 10000)
FLAG_EXAMPLES_PER_CLASS = 100  # the CLI's default
# the images the CLI writes every save_imgs_every (its default) steps, whose write
# times give the run's steps/s
GRID_EVERY = 500


def set_command(ds_root: str, make_set: str = MAKE_SET) -> list:
    """The set's command: the generator's own defaults, into ``ds_root``."""
    return [sys.executable, make_set, "--out", ds_root]


def build_set(ds_root: str, make_set: str = MAKE_SET) -> bool:
    """Run the generator unless ``ds_root`` holds a set; True if it ran.  It writes
    into a sibling directory renamed on success, so a cut run leaves no half set."""
    if os.path.isdir(os.path.join(ds_root, "train")):
        return False
    tmp = ds_root.rstrip("/") + ".partial"
    shutil.rmtree(tmp, ignore_errors=True)
    subprocess.run(set_command(tmp, make_set), check=True, cwd=REPO)
    os.rename(tmp, ds_root)
    return True


def set_digest(ds_root: str, ext: str = "png") -> tuple:
    """(SHA-256 hex over each image's relative path and decoded pixels in path order,
    image count): independent of how the images were compressed."""
    from PIL import Image

    paths = sorted(glob.glob(os.path.join(ds_root, "**", f"*.{ext}"), recursive=True))
    h = hashlib.sha256()
    for p in paths:
        h.update(os.path.relpath(p, ds_root).encode())
        h.update(np.asarray(Image.open(p)).tobytes())
    return h.hexdigest(), len(paths)


def train_seeds(seeds, ds_root: str, outdir: str, n_steps: int, save_every: int,
                device: str) -> float:
    """Train each seed in its own process of the multi-seed CLI; returns the seconds."""
    os.makedirs(outdir, exist_ok=True)
    # the host's cores shared out: each process's own thread pools would oversubscribe them
    env = dict(os.environ, OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 1) // len(seeds))))
    procs = {}
    t0 = time.perf_counter()
    try:
        for s in seeds:
            cmd = [sys.executable, "-m", TRAIN_MODULE, "--dataset_root", ds_root, "-o", outdir,
                   "--seeds", str(s), "--n_steps", str(n_steps), "--save_every",
                   str(save_every), "--device", device]
            with open(os.path.join(outdir, f"seed_{s}.log"), "w") as log:
                procs[s] = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log,
                                            stderr=subprocess.STDOUT)
        for proc in procs.values():
            proc.wait()
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    seconds = time.perf_counter() - t0
    for s, proc in procs.items():
        lines = Path(outdir, f"seed_{s}.log").read_text().splitlines()
        progress = [ln for ln in lines if ln.startswith(("step ", "done:"))]
        print(f"seed {s}: exit {proc.returncode}; " + "; ".join(progress[-2:]))
        if proc.returncode != 0:
            print("\n".join(lines[-30:]))
            raise SystemExit(f"seed {s}: training failed")
    print(f"trained seeds {list(seeds)}, {n_steps} steps each, in {seconds:.1f} s")
    return seconds


def csv_path(csv_dir: str, seed: int, step: int) -> str:
    return os.path.join(csv_dir, f"port_hard_s{seed}_eval_{step:08d}.csv")


def evaluate(seeds, steps, ds_root: str, outdir: str, csv_dir: str, device: str) -> list:
    """The eval grid of each seed's checkpoint at each of ``steps`` that exists;
    returns the CSVs written."""
    from optimalstrategiesagainstgenerativeattacks_torch.eval.authentication import (
        eval_authentication_task,
        get_dataset,
    )
    from optimalstrategiesagainstgenerativeattacks_torch.utils.config import load_args

    os.makedirs(csv_dir, exist_ok=True)
    written = []
    for s in seeds:
        seed_dir = os.path.join(outdir, f"seed_{s}")
        args = load_args(seed_dir)
        shutil.copyfile(os.path.join(seed_dir, "args.json"),
                        os.path.join(csv_dir, f"port_hard_s{s}_args.json"))
        for step in steps:
            name = f"model_{step:08d}"
            if not os.path.exists(os.path.join(seed_dir, "ckpts", name)):
                continue
            t0 = time.perf_counter()
            path = csv_path(csv_dir, s, step)
            # a fresh set each grid, as each run of the eval CLI reads it: the
            # random-source attacker's draws advance the set's generator
            ds = get_dataset(ds_root, "val", "omniglot", example_cnt_per_class=5,
                             img_channels=args["img_channels"], img_size=args["img_size"],
                             m=args["m"], n=args["n"], k=args["k"])
            eval_authentication_task(ds=ds, m=args["m"], n=args["n"], k=args["k"],
                                     batch_size=64, num_workers=4, gim_exp_dir=seed_dir,
                                     csv_file_path=path, specific_model=name, device=device)
            print(f"seed {s} step {step}: {path} ({time.perf_counter() - t0:.1f} s)")
            written.append(path)
    return written


def load_aucs(*dirs) -> dict:
    """{(impl, step, attacker): {seed: auc}} from the CSVs named ``<impl>_hard_s<seed>_
    eval_<step>.csv`` in ``dirs`` (a later directory's file replaces an earlier one's)."""
    rows = defaultdict(dict)
    for d in dirs:
        for path in sorted(glob.glob(os.path.join(d, "*.csv"))):
            m = CSV_NAME.search(os.path.basename(path))
            if not m:
                continue
            impl, seed, step = m.group(1), int(m.group(2)), int(m.group(3))
            with open(path) as f:
                for r in csv.DictReader(f):
                    if r["au_type"] == "gim":
                        rows[(impl, step, r["im_type"])][seed] = float(r["auc"])
    return rows


def table(rows: dict) -> list:
    """Markdown lines: each step and implementation, the AUC mean (min..max, n seeds)."""
    out = ["| step | impl | " + " | ".join(ATTACKERS) + " |", "|---|---|" + "---|" * len(ATTACKERS)]
    for step in sorted({k[1] for k in rows}):
        for impl in IMPLS:
            cells = []
            for a in ATTACKERS:
                v = list(rows.get((impl, step, a), {}).values())
                cells.append(f"{np.mean(v):.3f} ({min(v):.3f}..{max(v):.3f}, {len(v)})"
                             if v else "—")
            if any(c != "—" for c in cells):
                out.append(f"| {step} | {impl} | " + " | ".join(cells) + " |")
    return out


def verdict(rows: dict, steps=BAR_STEPS, seeds=BAR_SEEDS, jax_seeds=None) -> list:
    """The bar at each (step, attacker) where the port has ``seeds`` and the JAX
    package has readings: a dict with the mean of the port's ``seeds``, the min, max
    and count of the JAX seeds (``jax_seeds``, or every one recorded), and ``ok``:
    the port's mean inside [min, max], all three rounded to 3 decimals."""
    out = []
    for step in steps:
        for a in ATTACKERS:
            port = {s: v for s, v in rows.get(("port", step, a), {}).items() if s in seeds}
            jax = {s: v for s, v in rows.get(("jax", step, a), {}).items()
                   if jax_seeds is None or s in jax_seeds}
            if len(port) < len(seeds) or not jax:
                continue
            mean, lo, hi = np.mean(list(port.values())), min(jax.values()), max(jax.values())
            out.append({"step": step, "attacker": a, "port_mean": float(mean),
                        "port_seeds": sorted(port), "jax_min": lo, "jax_max": hi,
                        "jax_n": len(jax),
                        "ok": bool(round(lo, 3) <= round(mean, 3) <= round(hi, 3))})
    return out


def report(rows: dict) -> bool:
    """Print the table, the bar's verdict of ``load_aucs``' rows and, where the port
    has seeds 7-9, those seeds against the JAX package's seeds 7-9 through step 4800;
    True when every reading of the bar meets it."""
    print("\n".join(table(rows)))
    checks = verdict(rows)
    for title, cs in (("bar", checks), ("seeds 7-9", verdict(rows, LATE_STEPS, (7, 8, 9),
                                                               (7, 8, 9)))):
        for c in cs:
            print(f"{title} step {c['step']} {c['attacker']}: port mean {c['port_mean']:.3f} over "
                  f"seeds {c['port_seeds']}, JAX [{c['jax_min']:.3f}, {c['jax_max']:.3f}] "
                  f"(n={c['jax_n']}): {'inside' if c['ok'] else 'MISSED'}")
    met = bool(checks) and all(c["ok"] for c in checks)
    print(f"bar: {'met' if met else 'missed or not read'} at {len(checks)} (step, attacker) "
          f"readings")
    return met


def pooled_readings(rows: dict, impl: str, attacker: str) -> dict:
    """{seed: [auc, ...]} of ``impl``'s readings of ``attacker`` at the steps in
    (POOL_AFTER, POOL_UNTIL]."""
    out = defaultdict(list)
    for (i, step, a), seeds in sorted(rows.items()):
        if i == impl and a == attacker and POOL_AFTER < step <= POOL_UNTIL:
            for seed, auc in seeds.items():
                out[seed].append(auc)
    return dict(out)


def pooled_statistic(groups: dict) -> list:
    """For each attacker and group (name: (rows, impl)): the readings' count and
    share under POOL_THRESHOLDS; then for each pair of POOL_TESTS whose groups are
    both given, the two-sided Mann-Whitney U p-value over the readings and over
    the seeds' means, and U / (n1 n2), the chance that a reading of the first
    exceeds one of the second (ties count half)."""
    from scipy.stats import mannwhitneyu

    out = []
    for a in ATTACKERS:
        per_seed = {name: pooled_readings(rows, impl, a) for name, (rows, impl) in groups.items()}
        flat = {name: [v for vs in seeds.values() for v in vs] for name, seeds in per_seed.items()}
        for name, v in flat.items():
            out.append({"attacker": a, "group": name, "n": len(v), "seeds": len(per_seed[name]),
                        "under": int(np.sum(np.asarray(v) < POOL_THRESHOLDS[a])),
                        "threshold": POOL_THRESHOLDS[a],
                        "median": float(np.median(v)) if v else float("nan")})
        for x, y in POOL_TESTS:
            if not (flat.get(x) and flat.get(y)):
                continue
            test = mannwhitneyu(flat[x], flat[y], alternative="two-sided")
            means = [[float(np.mean(vs)) for vs in per_seed[g].values()] for g in (x, y)]
            out.append({"attacker": a, "test": f"{x} vs {y}", "p_readings": float(test.pvalue),
                        "p_seed_means": float(mannwhitneyu(*means,
                                                           alternative="two-sided").pvalue),
                        "u_share": float(test.statistic) / (len(flat[x]) * len(flat[y]))})
    return out


def pooled_report(groups: dict) -> list:
    """Print ``pooled_statistic`` of ``groups`` and return it."""
    stats = pooled_statistic(groups)
    print(f"pooled readings at steps ({POOL_AFTER}, {POOL_UNTIL}], every seed:")
    for s in stats:
        if "group" in s:
            print(f"  {s['attacker']} {s['group']}: {s['under']} of {s['n']} readings "
                  f"({s['seeds']} seeds) under {s['threshold']}, median {s['median']:.4f}")
        else:
            print(f"  {s['attacker']} {s['test']}: Mann-Whitney p {s['p_readings']:.4f} over "
                  f"readings, {s['p_seed_means']:.4f} over seed means; "
                  f"P(first > second) {s['u_share']:.3f}")
    return stats


def record_set(ds_root: str, csv_dir: str, name: str, make_set: str, ext: str,
               built: bool, seconds: float) -> None:
    """Print the set's digest and write it, with its command, to ``csv_dir/name``."""
    digest, n_images = set_digest(ds_root, ext)
    print(f"set {ds_root}: {'built' if built else 'found'} ({seconds:.1f} s), {n_images} "
          f"images, sha256 {digest}", flush=True)
    os.makedirs(csv_dir, exist_ok=True)
    with open(os.path.join(csv_dir, name), "w") as f:
        json.dump({"command": ["python"] + set_command(ds_root, make_set)[1:],
                   "images": n_images, "sha256_paths_and_pixels": digest}, f, indent=1)
        f.write("\n")


class Game(NamedTuple):
    """One configuration of the port's image CLI held to one trained JAX run."""
    prefix: str  # of the CSVs and records in docs_dir
    docs_dir: str
    jax_runs: tuple  # ((impl, directory, CSV name pattern), ...): the bar's run first
    make_set: str
    ext: str  # the set's image files
    ds_root: str
    outdir: str
    n_steps: int
    img_size: int
    examples_per_class: int  # episodes a class an epoch
    config: tuple  # the config's flags where it is not the CLI's defaults
    one_card_data: tuple  # the loader's flag on one card
    eval_flags: tuple

    @property
    def set_record(self) -> str:
        return f"{self.prefix}_set.json"


VOX = Game("port_hardvox", VOX_DOCS_DIR, (("jax", JAX_VOX_DIR, JAX_RUN_CSV_NAME),),
           MAKE_VOX_SET, "jpg",
           "build/hard_vox64", "build/hard_vox_head_to_head", VOX_BAR_STEP, 64,
           VOX_EXAMPLES_PER_CLASS,
           VOX_CONFIG + ("--compute_dtype", "bfloat16", "--ds_n_examples_per_cls",
                         str(VOX_EXAMPLES_PER_CLASS)),
           ("--device_data", "on"), ("--dataset_type", "voxceleb2", "--img_channels", "3"))
# the CLI's defaults are the flagship config; on one card its loader stages the set
# on the card ("auto"), as the JAX CLI's does
FLAG = Game("port_flag", FLAG_DOCS_DIR, (("jax", JAX_FLAG_CAL_DIR, JAX_CAL_CSV_NAME),
                                         ("jax_pre", JAX_FLAG_DIR, JAX_RUN_CSV_NAME)),
            MAKE_SET, "png",
            "build/hard_glyphs32", "build/flagship_head_to_head", FLAG_BAR_STEPS[-1], 32,
            FLAG_EXAMPLES_PER_CLASS, (), (), ())
RUN_CSV_NAME = re.compile(
    r"(port_hardvox|port_flag)_s(\d+)(?:_cards(\d+))?(_f32)?_eval_(\d+)\.csv$")
# the port's runs in the CSVs' rows: the bf16 game, and the f32 game (``_f32`` files)
PORT_IMPLS = ("port", "port_f32")


def run_tag(seed: int, cards: int, compute_dtype=None) -> str:
    """A run's name in its files: the seed, the cards when more than one, and
    ``_f32`` for the f32 game."""
    return (f"s{seed}" + (f"_cards{cards}" if cards > 1 else "")
            + ("_f32" if compute_dtype == "float32" else ""))


def run_csv_path(game: Game, csv_dir: str, seed: int, cards: int, step: int,
                 compute_dtype=None) -> str:
    return os.path.join(csv_dir, f"{game.prefix}_{run_tag(seed, cards, compute_dtype)}"
                                 f"_eval_{step:08d}.csv")


def scores_dir(csv_path_: str) -> str:
    """The directory of a grid's raw scores beside its CSV: ``..._scores_<step>/``."""
    head, name = os.path.split(csv_path_)
    return os.path.join(head, name.replace("_eval_", "_scores_")[:-len(".csv")])


def visible_cards(device: str) -> list:
    """The ids of the cards this process sees (``["0"]`` on the CPU)."""
    if os.environ.get("CUDA_VISIBLE_DEVICES"):
        return os.environ["CUDA_VISIBLE_DEVICES"].split(",")
    if device == "cuda":
        import torch

        return [str(i) for i in range(torch.cuda.device_count())]
    return ["0"]


def train_command(game: Game, seed: int, ds_root: str, exp: str, sizes: list, n_epochs: int,
                  save_every: int, cudnn_benchmark: bool, cards: int, device: str,
                  visible: list, tpu_precision: bool = False) -> tuple:
    """(command, environment) of one run of the port's image CLI on ``cards`` cards.

    One card: the first of ``visible``, pinned through ``CUDA_VISIBLE_DEVICES`` (with
    more visible the CLI would train data parallel over all of them), and the game's
    loader.  More: ``cards`` of ``visible`` left visible and ``--device_data off``,
    since the CLI refuses the device loader in a process group; it then starts one
    worker a card and trains data parallel at the same global batch.  With
    ``--device cpu`` the ranks are started by ``torch.distributed.run`` and join over
    gloo.  ``tpu_precision`` (one card) runs the CLI under
    ``scripts/torch_tpu_precision.py``'s mode: its f32 products on bf16 operands."""
    if cards > len(visible) and device == "cuda":
        raise SystemExit(f"--cards {cards}: only {len(visible)} visible")
    if tpu_precision and cards != 1:
        raise SystemExit("--tpu_precision: one card only (the workers would run without it)")
    data = game.one_card_data if cards == 1 else ("--device_data", "off")
    flags = ["--dataset_root", ds_root, "-o", exp, *game.config, *sizes, *data,
             "--seed", str(seed), "--n_epochs", str(n_epochs), "--save_every", str(save_every),
             "--cudnn_benchmark", str(int(cudnn_benchmark)), "--device", device]
    launcher = ([sys.executable, str(REPO / TPU_PRECISION), "run", "-m"] if tpu_precision
                else [sys.executable, "-m"])
    env = dict(os.environ)
    if cards == 1:
        env["CUDA_VISIBLE_DEVICES"] = visible[0]
    elif device == "cpu":
        launcher += ["torch.distributed.run", "--standalone", "--nproc_per_node", str(cards),
                     "-m"]
    elif cards < len(visible):
        env["CUDA_VISIBLE_DEVICES"] = ",".join(visible[:cards])
    return launcher + [IMG_TRAIN_MODULE] + flags, env


def grid_marks(exp: str) -> list:
    """[(step, seconds since the epoch)] of the image grids the CLI wrote: each step's
    first write time.  The CLI writes them every ``GRID_EVERY`` steps from step 0."""
    first = {}
    for p in glob.glob(os.path.join(exp, "imgs", "**", "*.png"), recursive=True):
        step = int(Path(p).stem)
        first[step] = min(first.get(step, float("inf")), os.path.getmtime(p))
    return sorted(first.items())


def steps_per_sec(marks: list):
    """Steps over seconds from the first mark to the last; None with fewer than two."""
    if len(marks) < 2:
        return None
    (s0, t0), (s1, t1) = marks[0], marks[-1]
    return (s1 - s0) / (t1 - t0)


def run_training(cmd: list, env: dict, exp: str, log_path: str, steps: list, on_checkpoint,
                 min_rate=None, deadline=None, poll: float = 2.0) -> dict:
    """Run ``cmd`` and, while it trains, call ``on_checkpoint(step)`` for each of ``steps``
    whose checkpoint has landed (a checkpoint is written whole or not at all) and print
    each image grid's step and the steps/s since the last.  Stops the run (its whole
    process group: the CLI's workers too) when the steps/s from its first grid to its
    second is under ``min_rate``, or ``deadline`` seconds after its start.  Returns
    {"seconds", "stopped" (None, "min_rate" or "deadline"), "steps_per_sec",
    "grid_marks": [[step, seconds after the first grid], ...]}."""
    t0 = time.perf_counter()
    done, seen, stopped = set(), 0, None
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            while True:
                exited = proc.poll() is not None
                for step in steps:
                    ckpt = os.path.join(exp, "ckpts", f"model_{step:08d}")
                    if step not in done and os.path.exists(ckpt):
                        on_checkpoint(step)
                        done.add(step)
                marks = grid_marks(exp)
                for (s0, m0), (s1, m1) in zip(marks[max(seen - 1, 0):], marks[max(seen, 1):]):
                    print(f"  step {s1}: {(s1 - s0) / (m1 - m0):.4f} steps/s since step {s0}",
                          flush=True)
                seen = len(marks)
                if min_rate is not None and seen >= 2 and steps_per_sec(marks[:2]) < min_rate:
                    stopped = "min_rate"
                elif deadline is not None and time.perf_counter() - t0 > deadline:
                    stopped = "deadline"
                if exited or stopped:
                    break
                time.sleep(poll)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    if stopped is None and proc.returncode != 0:
        print("\n".join(Path(log_path).read_text().splitlines()[-30:]))
        raise SystemExit(f"training failed ({proc.returncode}); its log: {log_path}")
    marks = grid_marks(exp)
    return {"seconds": time.perf_counter() - t0, "stopped": stopped,
            "steps_per_sec": steps_per_sec(marks),
            "grid_marks": [[s, round(t - marks[0][1], 3)] for s, t in marks]}


def eval_command(game: Game, exp: str, path: str, step: int, ds_root: str, device: str,
                 img_size: int) -> list:
    """The port's eval CLI on the checkpoint at ``step``: the val split, m1 n5 k5, at
    the trained image size (``eval_hardvox_grid.sh``'s flags for vox); the flagship's
    grid also writes the score moments at the calibrated threshold and the raw scores
    (``scores_dir``), as the flag_cal run's grids did."""
    cmd = [sys.executable, "-m", EVAL_MODULE, "--ds_root", ds_root,
           "--img_size", str(img_size), *game.eval_flags,
           "--m", "1", "--n", "5", "--k", "5",
           "--gim_exp_dir", exp, "--specific_model", f"model_{step:08d}",
           "--csv_file_path", path, "--device", device]
    if game is FLAG:
        cmd += ["--calibrate_q", str(FLAG_CALIBRATE_Q), "--dump_scores_dir", scores_dir(path)]
    return cmd


def eval_run(game: Game, exp: str, path: str, step: int, ds_root: str, device: str,
             img_size: int, card: str) -> None:
    """``eval_command`` on one card."""
    t0 = time.perf_counter()
    subprocess.run(eval_command(game, exp, path, step, ds_root, device, img_size),
                   check=True, cwd=REPO, env=dict(os.environ, CUDA_VISIBLE_DEVICES=card))
    print(f"step {step}: {path} ({time.perf_counter() - t0:.1f} s)", flush=True)


def run_csvs(game: Game, *dirs):
    """(path, impl, step, run) of each JAX run's CSVs (run 0: their seeds were not
    recorded) and of the port's ``<game.prefix>_`` CSVs in ``dirs``, whose run is
    (seed, cards) and whose impl is "port" or, for the f32 game, "port_f32"."""
    for impl, jax_dir, name in game.jax_runs:
        for path in sorted(glob.glob(os.path.join(jax_dir, "*.csv"))):
            m = name.search(os.path.basename(path))
            if m:
                yield path, impl, int(m.group(1)), 0
    for d in dirs:
        for path in sorted(glob.glob(os.path.join(d, "*.csv"))):
            m = RUN_CSV_NAME.search(os.path.basename(path))
            if m and m.group(1) == game.prefix:
                yield (path, PORT_IMPLS[bool(m.group(4))], int(m.group(5)),
                       (int(m.group(2)), int(m.group(3) or 1)))


def load_run_aucs(game: Game, *dirs) -> dict:
    """{(impl, step, attacker): {run: auc}} of ``run_csvs``."""
    rows = defaultdict(dict)
    for path, impl, step, run in run_csvs(game, *dirs):
        _read_aucs(path, rows, impl, step, run)
    return rows


MOMENTS = ("score_real_mean", "score_real_std", "score_fake_mean", "score_fake_std")


def load_run_moments(game: Game, *dirs) -> dict:
    """{(impl, step, attacker): {run: (real mean, real std, fake mean, fake std)}} of
    the GIM authenticator's scores, from the CSVs of ``run_csvs`` that have them
    (grids written with ``--calibrate_q``)."""
    rows = defaultdict(dict)
    for path, impl, step, run in run_csvs(game, *dirs):
        with open(path) as f:
            for r in csv.DictReader(f):
                if r["au_type"] == "gim" and r.get(MOMENTS[0]):
                    rows[(impl, step, r["im_type"])][run] = tuple(float(r[k]) for k in MOMENTS)
    return rows


def load_vox_aucs(*dirs) -> dict:
    return load_run_aucs(VOX, *dirs)


def _read_aucs(path: str, rows: dict, impl: str, step: int, run) -> None:
    with open(path) as f:
        for r in csv.DictReader(f):
            if r["au_type"] == "gim":
                rows[(impl, step, r["im_type"])][run] = float(r["auc"])


JAX_LABELS = {"jax": "JAX", "jax_pre": "JAX pre-dbb161f"}


def run_label(impl: str, run) -> str:
    if impl in JAX_LABELS:
        return JAX_LABELS[impl]
    seed, cards = run
    return (f"port{' f32' if impl == 'port_f32' else ''} s{seed}, "
            f"{cards} card{'s' if cards > 1 else ''}")


def run_table(rows: dict) -> list:
    """Markdown lines: each step and run, its AUC of each attacker."""
    runs = sorted({(step, impl, run) for (impl, step, _), v in rows.items() for run in v},
                  key=lambda x: (x[0], x[1], repr(x[2])))
    out = ["| step | run | " + " | ".join(ATTACKERS) + " |", "|---|---|" + "---|" * len(ATTACKERS)]
    for step, impl, run in runs:
        cells = [rows.get((impl, step, a), {}).get(run) for a in ATTACKERS]
        out.append(f"| {step} | {run_label(impl, run)} | "
                   + " | ".join("—" if v is None else f"{v:.4f}" for v in cells) + " |")
    return out


def vox_verdict(rows: dict, step: int = VOX_BAR_STEP) -> list:
    """Each port run's AUC at ``step`` against the JAX run's checkpoints: gim and
    replay at least the lowest, rnd_src inside [min, max]."""
    out = []
    for a in ATTACKERS:
        jax = [v for (impl, _, att), seeds in rows.items() if impl == "jax" and att == a
               for v in seeds.values()]
        for (seed, cards), auc in sorted(rows.get(("port", step, a), {}).items()):
            lo, hi = min(jax), (max(jax) if a == "rnd_src" else 1.0)
            out.append({"step": step, "attacker": a, "seed": seed, "cards": cards, "port": auc,
                        "jax_min": lo, "jax_max": hi, "ok": bool(lo <= auc <= hi)})
    return out


def flag_deltas(rows: dict) -> dict:
    """{attacker: delta}: the largest range over seeds of the JAX glyph study's
    readings (``load_aucs``' rows) at ``FLAG_DELTA_STEPS``, to 3 decimals."""
    return {a: round(max(max(v) - min(v) for v in (
        list(rows[("jax", step, a)].values()) for step in FLAG_DELTA_STEPS)), 3)
        for a in ATTACKERS}


def flag_verdict(rows: dict, deltas: dict, ref: str = "jax") -> list:
    """Each port run's AUC (bf16 and f32 games) at each of ``FLAG_BAR_STEPS`` inside
    the reading of the JAX run ``ref`` ("jax": flag_cal, the package's current code;
    "jax_pre": flag100k_hard) at that step +- the attacker's delta (the upper edge at
    most 1)."""
    out = []
    for step in FLAG_BAR_STEPS:
        for a in ATTACKERS:
            jax = rows.get((ref, step, a), {}).get(0)
            for impl in PORT_IMPLS:
                for (seed, cards), auc in sorted(rows.get((impl, step, a), {}).items()):
                    lo, hi = jax - deltas[a], min(1.0, jax + deltas[a])
                    out.append({"step": step, "attacker": a, "seed": seed, "cards": cards,
                                "impl": impl, "port": auc, "jax": jax, "lo": lo, "hi": hi,
                                "ok": bool(lo <= auc <= hi)})
    return out


def moments_table(moments: dict) -> list:
    """Markdown lines: each step and run, the GIM authenticator's real and fake score
    mean +- std against each attacker (real: the same for every attacker)."""
    runs = sorted({(step, impl, run) for (impl, step, _), v in moments.items() for run in v},
                  key=lambda x: (x[0], x[1], repr(x[2])))
    out = ["| step | run | real | " + " | ".join(f"{a} fake" for a in ATTACKERS) + " |",
           "|---|---|---|" + "---|" * len(ATTACKERS)]
    for step, impl, run in runs:
        cells = [moments.get((impl, step, a), {}).get(run) for a in ATTACKERS]
        real = next((c for c in cells if c), None)
        out.append(f"| {step} | {run_label(impl, run)} | {real[0]:+.4f} ± {real[1]:.4f} | "
                   + " | ".join("—" if c is None else f"{c[2]:+.4f} ± {c[3]:.4f}"
                                for c in cells) + " |")
    return out


def print_runs(game: Game, *dirs) -> None:
    """Each port run's record beside its CSVs: cards, steps/s, the card, the set."""
    for d in dirs:
        for path in sorted(glob.glob(os.path.join(d, f"{game.prefix}_s*_args.json"))):
            run = json.loads(Path(path).read_text()).get("study_run")
            if run:
                rate = run["steps_per_sec"]
                print(f"{os.path.basename(path)}: {run['cards']} card(s), "
                      f"{'not read' if rate is None else f'{rate:.4f}'} steps/s "
                      f"(grids every {GRID_EVERY} steps), {run['train_seconds']:.1f} s, "
                      f"stopped {run['stopped']}, {run['card']}")
        record = os.path.join(d, game.set_record)
        if game is FLAG and os.path.exists(record):
            print(f"{record}: {set_verdict(record)}")


def set_verdict(record: str) -> str:
    """Whether the digest in ``record`` is the glyph study's."""
    study = os.path.join(DOCS_DIR, "port_hard_set.json")
    mine, its = (json.loads(Path(p).read_text())["sha256_paths_and_pixels"]
                 for p in (record, study))
    return f"{'the' if mine == its else 'NOT the'} glyph study's set ({study})"


def game_report(game: Game, *dirs, ref: str = "jax") -> bool:
    """Print the table, each run's record and the bar of the game's CSVs in ``dirs``
    (the flagship's against each JAX run, and the score moments beside flag_cal's);
    True when every reading of every port run at the bar's steps meets the bar of
    the JAX run ``ref`` (the flagship's "jax_pre": flag100k_hard's)."""
    dirs = dict.fromkeys(os.path.normpath(d) for d in dirs)  # each once, in order
    rows = load_run_aucs(game, *dirs)
    print("\n".join(run_table(rows)))
    print_runs(game, *dirs)
    if game is VOX:
        checks = {"jax": vox_verdict(rows)}
        lines = {"jax": [
            f"bar step {c['step']} {c['attacker']} {run_label('port', (c['seed'], c['cards']))}: "
            f"port {c['port']:.4f}, JAX [{c['jax_min']:.4f}, {c['jax_max']:.4f}]"
            for c in checks["jax"]]}
    else:
        moments = load_run_moments(game, *dirs)
        if moments:
            print("GIM authenticator's scores, mean ± std:")
            print("\n".join(moments_table(moments)))
        deltas = flag_deltas(load_aucs(DOCS_DIR))
        checks = {r: flag_verdict(rows, deltas, r) for r, _, _ in game.jax_runs}
        lines = {r: [f"bar step {c['step']} {c['attacker']} "
                     f"{run_label(c['impl'], (c['seed'], c['cards']))}: port {c['port']:.4f}, "
                     f"{JAX_LABELS[r]} {c['jax']:.4f} +- {deltas[c['attacker']]:.3f} = "
                     f"[{c['lo']:.4f}, {c['hi']:.4f}]" for c in cs] for r, cs in checks.items()}
    for r, cs in checks.items():
        for line, c in zip(lines[r], cs):
            print(f"{line}: {'inside' if c['ok'] else 'MISSED'}")
        met = bool(cs) and all(c["ok"] for c in cs)
        print(f"bar ({JAX_LABELS[r]}): {'met' if met else 'missed or not read'} at "
              f"{len(cs)} readings")
    return bool(checks[ref]) and all(c["ok"] for c in checks[ref])


def main_game(game: Game, args) -> None:
    """Build the set, train each seed on ``--cards`` cards (scoring each checkpoint as
    it lands), copy its arguments and run record, and print the report."""
    if args.report:
        game_report(game, game.docs_dir, args.csv_dir)
        return
    t0 = time.perf_counter()
    built = build_set(args.ds_root, game.make_set)
    record_set(args.ds_root, args.csv_dir, game.set_record, game.make_set, game.ext, built,
               time.perf_counter() - t0)
    if game is FLAG:
        print(f"set: {set_verdict(os.path.join(args.csv_dir, game.set_record))}", flush=True)
    sizes = ["--img_size", str(args.img_size), "--style_dim", str(args.style_dim),
             "--batch_size", str(args.batch_size)]
    if args.compute_dtype:
        sizes += ["--compute_dtype", args.compute_dtype]
    n_train = len(glob.glob(os.path.join(args.ds_root, "train", "*", "*")))  # classes
    per_epoch = n_train * game.examples_per_class // args.batch_size
    # the loop numbers its steps from 0: the epochs run past step n_steps
    n_epochs = args.n_steps // per_epoch + 1
    visible = visible_cards(args.device)
    steps = args.eval_steps or list(range(args.save_every, args.n_steps + 1, args.save_every))
    os.makedirs(args.outdir, exist_ok=True)
    for seed in args.seeds:
        tag = run_tag(seed, args.cards, args.compute_dtype)
        exp = os.path.join(args.outdir, "seed_" + tag[1:])
        shutil.rmtree(exp, ignore_errors=True)  # the grids' times are this run's
        cmd, env = train_command(game, seed, args.ds_root, exp, sizes, n_epochs,
                                 args.save_every, args.cudnn_benchmark, args.cards,
                                 args.device, visible, args.tpu_precision)
        print(" ".join(cmd[1:]) + f"  ({per_epoch} steps an epoch, {n_epochs} epochs; "
              f"CUDA_VISIBLE_DEVICES={env.get('CUDA_VISIBLE_DEVICES', '')})", flush=True)

        def score(step, exp=exp, seed=seed):
            eval_run(game, exp, run_csv_path(game, args.csv_dir, seed, args.cards, step,
                                             args.compute_dtype),
                     step, args.ds_root, args.device, args.img_size, visible[0])
            if args.delete_scored:
                os.remove(os.path.join(exp, "ckpts", f"model_{step:08d}"))

        run = run_training(cmd, env, exp, exp + ".log", steps,
                           score, args.min_steps_per_sec, args.deadline)
        print(f"{tag}: {run['seconds']:.1f} s, stopped {run['stopped']}, steps/s "
              f"{run['steps_per_sec']}", flush=True)
        args_json = json.loads(Path(exp, "args.json").read_text())
        args_json["study_run"] = {"cards": args.cards, "card": args.card,
                                  "tpu_precision": args.tpu_precision,
                                  "train_seconds": run["seconds"], "stopped": run["stopped"],
                                  "steps_per_sec": run["steps_per_sec"],
                                  "grid_marks": run["grid_marks"]}
        with open(os.path.join(args.csv_dir, f"{game.prefix}_{tag}_args.json"), "w") as f:
            json.dump(args_json, f, indent=1)
            f.write("\n")
        if run["stopped"] == "min_rate":
            raise SystemExit(f"{tag}: under {args.min_steps_per_sec} steps/s from its first "
                             f"grid to its second: stopped")
    game_report(game, game.docs_dir, args.csv_dir)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--vox", action="store_true",
                      help="the VoxCeleb-shaped R1 game against the JAX hard-vox run")
    mode.add_argument("--flagship", action="store_true",
                      help="the flagship game against the JAX run on the hard glyph set")
    ap.add_argument("--seeds", type=int, nargs="+", default=None,
                    help="default: 2 3 4 (glyphs), 1 (--vox, --flagship: the JAX CLI's "
                         "default seed)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ds_root", default=None,
                    help="default: build/hard_glyphs32, or build/hard_vox64 with --vox")
    ap.add_argument("--outdir", default=None,
                    help="experiment directories (seed_<s>/args.json, ckpts/; --vox and "
                         "--flagship: seed_<s>[_cards<N>]/) and logs; default "
                         "build/hard_head_to_head, build/hard_vox_head_to_head or "
                         "build/flagship_head_to_head")
    ap.add_argument("--csv_dir", default=None,
                    help=f"default {DOCS_DIR}, {VOX_DOCS_DIR} (--vox) or {FLAG_DOCS_DIR} "
                         "(--flagship)")
    ap.add_argument("--n_steps", type=int, default=None,
                    help="default 4999, 2500 (--vox) or 10000 (--flagship)")
    ap.add_argument("--save_every", type=int, default=None,
                    help="default 400, --n_steps (--vox) or 5000 (--flagship)")
    ap.add_argument("--eval_steps", type=int, nargs="+", default=None,
                    help="default: the glyph study's steps; --vox and --flagship: each "
                         "checkpoint of --save_every through --n_steps")
    ap.add_argument("--img_size", type=int, default=None,
                    help="--vox, --flagship: default 64 and 32")
    ap.add_argument("--style_dim", type=int, default=512, help="--vox, --flagship")
    ap.add_argument("--batch_size", type=int, default=128, help="--vox, --flagship")
    ap.add_argument("--compute_dtype", default=None, choices=["bfloat16", "float32"],
                    help="--flagship: the CLI's --compute_dtype (default: its bfloat16); "
                         "an f32 run's files are named ..._s<seed>[_cards<N>]_f32_...")
    ap.add_argument("--cudnn_benchmark", action="store_true",
                    help="--vox, --flagship: the CLI's --cudnn_benchmark 1 (cuDNN times its "
                         "conv algorithms)")
    ap.add_argument("--cards", type=int, default=1,
                    help="--vox, --flagship: 1 pins the CLI to one card; N > 1 leaves N "
                         "visible and the CLI trains data parallel over them (the eval "
                         "runs on one card)")
    ap.add_argument("--min_steps_per_sec", type=float, default=None,
                    help="--vox, --flagship: stop a run that trains slower than this from "
                         "its first image grid (step 0) to its second")
    ap.add_argument("--deadline", type=float, default=None,
                    help="--vox, --flagship: stop training this many seconds after a run's "
                         "start; the checkpoints scored by then keep their CSVs")
    ap.add_argument("--delete_scored", action="store_true",
                    help="--vox, --flagship: delete each checkpoint once its grid is written "
                         "(a grid every 500 steps of the flagship: 20 checkpoints of 943 MB)")
    ap.add_argument("--tpu_precision", action="store_true",
                    help="--vox, --flagship, one card: train under "
                         "scripts/torch_tpu_precision.py's mode (every f32 product on bf16 "
                         "operands, as a TPU's default precision computes it); the grids "
                         "score exactly")
    ap.add_argument("--report", action="store_true",
                    help="print the table and the bar of the CSVs present, and stop")
    args = ap.parse_args(argv)
    game = VOX if args.vox else FLAG if args.flagship else None
    args.seeds = args.seeds or ([1] if game else [2, 3, 4])
    args.ds_root = args.ds_root or (game.ds_root if game else "build/hard_glyphs32")
    args.outdir = args.outdir or (game.outdir if game else "build/hard_head_to_head")
    args.csv_dir = args.csv_dir or (game.docs_dir if game else DOCS_DIR)
    args.n_steps = args.n_steps or (game.n_steps if game else 4999)
    args.save_every = args.save_every or (
        args.n_steps if game is VOX else FLAG_BAR_STEPS[0] if game else 400)
    args.img_size = args.img_size or (game.img_size if game else None)
    args.card = "cpu"
    os.chdir(REPO)  # the paths are the checkout's, as the CSVs record them
    if args.device == "cuda" and not args.report:
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: torch.cuda.is_available() is false")
        args.card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                    "--format=csv,noheader"], capture_output=True, text=True,
                                   check=True).stdout.strip()
        print(args.card, flush=True)
    if game:
        main_game(game, args)
        return
    if args.report:
        report(load_aucs(DOCS_DIR, args.csv_dir))
        pooled_report({name: (load_aucs(*dirs), impl)
                       for name, (impl, dirs) in POOL_GROUPS.items()})
        return

    t0 = time.perf_counter()
    built = build_set(args.ds_root)
    record_set(args.ds_root, args.csv_dir, "port_hard_set.json", MAKE_SET, "png", built,
               time.perf_counter() - t0)

    train_seeds(args.seeds, args.ds_root, args.outdir, args.n_steps, args.save_every,
                args.device)
    evaluate(args.seeds, args.eval_steps or list(EVAL_STEPS), args.ds_root, args.outdir,
             args.csv_dir, args.device)
    report(load_aucs(DOCS_DIR, args.csv_dir))


if __name__ == "__main__":
    main()
