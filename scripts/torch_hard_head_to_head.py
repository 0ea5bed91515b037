"""The hard-glyph head-to-head on the port: build the set, train seeds at the
multi-seed CLI's defaults, score each checkpoint with the port's eval grid, and
hold the port's AUCs to the JAX package's recorded ones.

    python scripts/torch_hard_head_to_head.py [--seeds 2 3 4] [--device cuda|cpu]
        [--ds_root build/hard_glyphs32] [--outdir build/hard_head_to_head]
        [--csv_dir docs/hard_head_to_head] [--n_steps 4999] [--save_every 400]
        [--eval_steps 400 800 ...]
    python scripts/torch_hard_head_to_head.py --report   # the table and the bar only

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


def set_command(ds_root: str) -> list:
    """The set's command: the generator's own defaults, into ``ds_root``."""
    return [sys.executable, MAKE_SET, "--out", ds_root]


def build_set(ds_root: str) -> bool:
    """Run the generator unless ``ds_root`` holds a set; True if it ran.  It writes
    into a sibling directory renamed on success, so a cut run leaves no half set."""
    if os.path.isdir(os.path.join(ds_root, "train")):
        return False
    tmp = ds_root.rstrip("/") + ".partial"
    shutil.rmtree(tmp, ignore_errors=True)
    subprocess.run(set_command(tmp), check=True, cwd=REPO)
    os.rename(tmp, ds_root)
    return True


def set_digest(ds_root: str) -> tuple:
    """(SHA-256 hex over each image's relative path and decoded pixels in path order,
    image count): independent of how the PNGs were compressed."""
    from PIL import Image

    paths = sorted(glob.glob(os.path.join(ds_root, "*", "*", "*", "*.png")))
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[2, 3, 4])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ds_root", default="build/hard_glyphs32")
    ap.add_argument("--outdir", default="build/hard_head_to_head",
                    help="experiment directories (seed_<s>/args.json, ckpts/) and logs")
    ap.add_argument("--csv_dir", default=DOCS_DIR)
    ap.add_argument("--n_steps", type=int, default=4999)
    ap.add_argument("--save_every", type=int, default=400)
    ap.add_argument("--eval_steps", type=int, nargs="+", default=list(EVAL_STEPS))
    ap.add_argument("--report", action="store_true",
                    help="print the table and the bar of the CSVs present, and stop")
    args = ap.parse_args(argv)
    os.chdir(REPO)  # the paths are the checkout's, as the CSVs record them
    if args.report:
        report(load_aucs(DOCS_DIR, args.csv_dir))
        return
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: torch.cuda.is_available() is false")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)

    t0 = time.perf_counter()
    built = build_set(args.ds_root)
    digest, n_images = set_digest(args.ds_root)
    print(f"set {args.ds_root}: {'built' if built else 'found'} "
          f"({time.perf_counter() - t0:.1f} s), {n_images} images, sha256 {digest}", flush=True)
    os.makedirs(args.csv_dir, exist_ok=True)
    with open(os.path.join(args.csv_dir, "port_hard_set.json"), "w") as f:
        json.dump({"command": ["python"] + set_command(args.ds_root)[1:], "images": n_images,
                   "sha256_paths_and_pixels": digest}, f, indent=1)
        f.write("\n")

    train_seeds(args.seeds, args.ds_root, args.outdir, args.n_steps, args.save_every,
                args.device)
    evaluate(args.seeds, args.eval_steps, args.ds_root, args.outdir, args.csv_dir, args.device)
    report(load_aucs(DOCS_DIR, args.csv_dir))


if __name__ == "__main__":
    main()
