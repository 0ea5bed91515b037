"""The hard-glyph head-to-head on the port: build the set, train seeds at the
multi-seed CLI's defaults, score each checkpoint with the port's eval grid, and
hold the port's AUCs to the JAX package's recorded ones.

    python scripts/torch_hard_head_to_head.py [--seeds 2 3 4] [--device cuda|cpu]
        [--ds_root build/hard_glyphs32] [--outdir build/hard_head_to_head]
        [--csv_dir docs/hard_head_to_head] [--n_steps 4999] [--save_every 400]
        [--eval_steps 400 800 ...]
    python scripts/torch_hard_head_to_head.py --report   # the table and the bar only
    python scripts/torch_hard_head_to_head.py --vox [--seeds 1] [--n_steps 2500] ...
    python scripts/torch_hard_head_to_head.py --vox --report

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
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

DOCS_DIR = "docs/hard_head_to_head"
MAKE_SET = "scripts/make_hard_glyph_ds.py"
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
VOX_TRAIN_MODULE = "optimalstrategiesagainstgenerativeattacks_torch.train_gim_on_imgs"
EVAL_MODULE = "optimalstrategiesagainstgenerativeattacks_torch.eval_gim_on_authentication"
# the VoxCeleb2 config of the JAX CLI's docstring (train_gim_on_imgs.py:7-8)
VOX_CONFIG = ["--dataset_type", "voxceleb2", "--img_channels", "3", "--au_lr", "1e-4",
              "--im_lr", "1e-4", "--env_noise_mapping_lr", "1e-6", "--reg_param", "10"]
VOX_EXAMPLES_PER_CLASS = 20  # 93 steps an epoch, as the JAX run's 14879 steps in 160 epochs
VOX_BAR_STEP = 2500
VOX_CSV_NAME = re.compile(r"port_hardvox_s(\d+)_eval_(\d+)\.csv$")
JAX_VOX_CSV_NAME = re.compile(r"eval_step(\d+)\.csv$")


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


def vox_csv_path(csv_dir: str, seed: int, step: int) -> str:
    return os.path.join(csv_dir, f"port_hardvox_s{seed}_eval_{step:08d}.csv")


def train_vox(seed: int, ds_root: str, outdir: str, n_steps: int, device: str,
              sizes: list, cudnn_benchmark: bool = False) -> str:
    """One seed of the VoxCeleb2 config through the port's CLI, to ``n_steps``;
    returns its experiment directory."""
    n_train = len(glob.glob(os.path.join(ds_root, "train", "*", "*")))  # one class a video
    batch = int(sizes[sizes.index("--batch_size") + 1])
    per_epoch = n_train * VOX_EXAMPLES_PER_CLASS // batch
    exp = os.path.join(outdir, f"seed_{seed}")
    cmd = [sys.executable, "-m", VOX_TRAIN_MODULE, "--dataset_root", ds_root, "-o", exp,
           *VOX_CONFIG, *sizes, "--compute_dtype", "bfloat16", "--device_data", "on",
           "--ds_n_examples_per_cls", str(VOX_EXAMPLES_PER_CLASS), "--seed", str(seed),
           # the loop numbers its steps from 0: the epochs run past step n_steps
           "--n_epochs", str(n_steps // per_epoch + 1), "--save_every", str(n_steps),
           "--cudnn_benchmark", str(int(cudnn_benchmark)), "--device", device]
    os.makedirs(outdir, exist_ok=True)
    print(" ".join(cmd[1:]), flush=True)
    t0 = time.perf_counter()
    # one card, the card the bar was set on: with more visible the CLI trains data
    # parallel over all of them (and refuses --device_data on)
    env = dict(os.environ,
               CUDA_VISIBLE_DEVICES=os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0])
    with open(os.path.join(outdir, f"seed_{seed}.log"), "w") as log:
        proc = subprocess.run(cmd, cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
    lines = Path(outdir, f"seed_{seed}.log").read_text().splitlines()
    if proc.returncode != 0:
        print("\n".join(lines[-30:]))
        raise SystemExit(f"seed {seed}: training failed")
    print(f"seed {seed}: {per_epoch} steps an epoch, {n_steps} steps and on to the epoch's "
          f"end in {time.perf_counter() - t0:.1f} s; " + "; ".join(lines[-2:]), flush=True)
    return exp


def eval_vox(exp: str, seed: int, step: int, ds_root: str, csv_dir: str, device: str,
             img_size: int) -> str:
    """The eval CLI on the checkpoint at ``step``, flags of ``eval_hardvox_grid.sh``."""
    path = vox_csv_path(csv_dir, seed, step)
    os.makedirs(csv_dir, exist_ok=True)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", EVAL_MODULE, "--ds_root", ds_root,
                    "--dataset_type", "voxceleb2", "--img_size", str(img_size),
                    "--img_channels", "3", "--m", "1", "--n", "5", "--k", "5",
                    "--gim_exp_dir", exp, "--specific_model", f"model_{step:08d}",
                    "--csv_file_path", path, "--device", device], check=True, cwd=REPO)
    shutil.copyfile(os.path.join(exp, "args.json"),
                    os.path.join(csv_dir, f"port_hardvox_s{seed}_args.json"))
    print(f"seed {seed} step {step}: {path} ({time.perf_counter() - t0:.1f} s)", flush=True)
    return path


def load_vox_aucs(*dirs) -> dict:
    """{(impl, step, attacker): {seed: auc}} of the JAX run's CSVs (seed 0: its seed
    was not recorded) and the port's ``port_hardvox_`` CSVs in ``dirs``."""
    rows = defaultdict(dict)
    for path in sorted(glob.glob(os.path.join(JAX_VOX_DIR, "*.csv"))):
        m = JAX_VOX_CSV_NAME.search(path)
        if m:
            _read_aucs(path, rows, "jax", int(m.group(1)), 0)
    for d in dirs:
        for path in sorted(glob.glob(os.path.join(d, "*.csv"))):
            m = VOX_CSV_NAME.search(os.path.basename(path))
            if m:
                _read_aucs(path, rows, "port", int(m.group(2)), int(m.group(1)))
    return rows


def _read_aucs(path: str, rows: dict, impl: str, step: int, seed: int) -> None:
    with open(path) as f:
        for r in csv.DictReader(f):
            if r["au_type"] == "gim":
                rows[(impl, step, r["im_type"])][seed] = float(r["auc"])


def vox_verdict(rows: dict, step: int = VOX_BAR_STEP) -> list:
    """Each port seed's AUC at ``step`` against the JAX run's checkpoints: gim and
    replay at least the lowest, rnd_src inside [min, max]."""
    out = []
    for a in ATTACKERS:
        jax = [v for (impl, _, att), seeds in rows.items() if impl == "jax" and att == a
               for v in seeds.values()]
        for seed, auc in sorted(rows.get(("port", step, a), {}).items()):
            lo, hi = min(jax), (max(jax) if a == "rnd_src" else 1.0)
            out.append({"step": step, "attacker": a, "seed": seed, "port": auc,
                        "jax_min": lo, "jax_max": hi, "ok": bool(lo <= auc <= hi)})
    return out


def vox_report(rows: dict) -> bool:
    """Print the table and the bar of ``load_vox_aucs``' rows; True when every reading
    of every port seed at the bar step meets it."""
    print("\n".join(table(rows)))
    checks = vox_verdict(rows)
    for c in checks:
        print(f"bar step {c['step']} {c['attacker']} seed {c['seed']}: port {c['port']:.4f}, "
              f"JAX [{c['jax_min']:.4f}, {c['jax_max']:.4f}]: "
              f"{'inside' if c['ok'] else 'MISSED'}")
    met = bool(checks) and all(c["ok"] for c in checks)
    print(f"bar: {'met' if met else 'missed or not read'} at {len(checks)} readings")
    return met


def main_vox(args) -> None:
    if args.report:
        vox_report(load_vox_aucs(VOX_DOCS_DIR, args.csv_dir))
        return
    t0 = time.perf_counter()
    built = build_set(args.ds_root, MAKE_VOX_SET)
    record_set(args.ds_root, args.csv_dir, "port_hardvox_set.json", MAKE_VOX_SET, "jpg", built,
               time.perf_counter() - t0)
    sizes = ["--img_size", str(args.img_size), "--style_dim", str(args.style_dim),
             "--batch_size", str(args.batch_size)]
    for seed in args.seeds:
        exp = train_vox(seed, args.ds_root, args.outdir, args.n_steps, args.device, sizes,
                        args.cudnn_benchmark)
        eval_vox(exp, seed, args.n_steps, args.ds_root, args.csv_dir, args.device,
                 args.img_size)
    vox_report(load_vox_aucs(VOX_DOCS_DIR, args.csv_dir))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--vox", action="store_true",
                    help="the VoxCeleb-shaped R1 game against the JAX hard-vox run")
    ap.add_argument("--seeds", type=int, nargs="+", default=None,
                    help="default: 2 3 4 (glyphs), 1 (--vox: the JAX CLI's default seed)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ds_root", default=None,
                    help="default: build/hard_glyphs32, or build/hard_vox64 with --vox")
    ap.add_argument("--outdir", default=None,
                    help="experiment directories (seed_<s>/args.json, ckpts/) and logs; "
                         "default build/hard_head_to_head or build/hard_vox_head_to_head")
    ap.add_argument("--csv_dir", default=None,
                    help=f"default {DOCS_DIR}, or {VOX_DOCS_DIR} with --vox")
    ap.add_argument("--n_steps", type=int, default=None, help="default 4999, or 2500 (--vox)")
    ap.add_argument("--save_every", type=int, default=400)
    ap.add_argument("--eval_steps", type=int, nargs="+", default=list(EVAL_STEPS))
    ap.add_argument("--img_size", type=int, default=64, help="--vox")
    ap.add_argument("--style_dim", type=int, default=512, help="--vox")
    ap.add_argument("--batch_size", type=int, default=128, help="--vox")
    ap.add_argument("--cudnn_benchmark", action="store_true",
                    help="--vox: the CLI's --cudnn_benchmark 1 (cuDNN times its conv "
                         "algorithms)")
    ap.add_argument("--report", action="store_true",
                    help="print the table and the bar of the CSVs present, and stop")
    args = ap.parse_args(argv)
    vox = args.vox
    args.seeds = args.seeds or ([1] if vox else [2, 3, 4])
    args.ds_root = args.ds_root or ("build/hard_vox64" if vox else "build/hard_glyphs32")
    args.outdir = args.outdir or ("build/hard_vox_head_to_head" if vox
                                  else "build/hard_head_to_head")
    args.csv_dir = args.csv_dir or (VOX_DOCS_DIR if vox else DOCS_DIR)
    args.n_steps = args.n_steps or (VOX_BAR_STEP if vox else 4999)
    os.chdir(REPO)  # the paths are the checkout's, as the CSVs record them
    if args.device == "cuda" and not args.report:
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: torch.cuda.is_available() is false")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)
    if vox:
        main_vox(args)
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
    evaluate(args.seeds, args.eval_steps, args.ds_root, args.outdir, args.csv_dir, args.device)
    report(load_aucs(DOCS_DIR, args.csv_dir))


if __name__ == "__main__":
    main()
