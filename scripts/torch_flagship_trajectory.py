"""The flagship game of the JAX package and of the port side by side on the CPU, over
many steps at small widths; or the port's game alone, on the card or the CPU.

    python scripts/torch_flagship_trajectory.py --compute_dtype float32 --seed 1
        [--minutes 30] [--every 25] [--style_dim 32] [--batch_size 8]
        [--out docs/flagship_trajectory]
    python scripts/torch_flagship_trajectory.py --port_only [--device cuda|cpu] ...
    python scripts/torch_flagship_trajectory.py --report [--out docs/flagship_trajectory]
    python scripts/torch_flagship_trajectory.py --signature <CSV or grid dir> ...

One run is one (compute dtype, seed).  Both games start from one state: the port's
initialisation (``create_state`` with the seed) carried into Flax
(``port/transplant.py:state_dict_to_flax``).  They take the same steps at the
flagship's step settings (``ImageGameConfig``'s defaults: au / im / noise-mapper lr
1e-6 / 1e-5 / 1e-7, Adam beta (0, 0.99), reg 0, m1 n5 k5, 32 px) at small widths,
on one seeded stream of episodes.  The JAX step is compiled once; each step's noise
is the JAX step's own draw (``split(fold_in(state.rng, step))``), injected into the
port's step.

The episodes come from ``scripts/make_hard_glyph_ds.py``'s generator, built in
memory at a size that fits here (``--n_alphabets`` 8 x ``--n_chars`` 12 classes of
20 images, the first 2 alphabets held out).  An episode takes one train class and
m + n + k of its images without replacement (leaked, real, si), drawn by a numpy
generator seeded with ``--seed``.  The held-out set: ``--eval_episodes`` episodes of
the held-out classes, fixed for every run.

Every ``--every`` steps each side records, in ``<out>/traj_<dtype>_s<seed>.csv``:
  * the mean over those steps of ``au_out_on_real``, ``au_out_on_fake`` and the
    losses;
  * each player's displacement from the start (the L2 norm over its parameters),
    and the distance between the two sides' parameters;
  * the GIM and replay AUC of its current authenticator on the held-out episodes,
    and the mean and std of its scores of the real episodes and of each
    attacker's fakes: each side's own score function (the JAX package's and the
    port's ``eval/authentication.py:get_au_function``) and AUC (sklearn's
    ``roc_auc_score`` and the port's ``eval/scorer.py:roc_auc``); the GIM fakes
    are each side's impersonator with one fixed JAX noise draw, the replay fake
    the leaked image repeated n times.
The run stops after ``--minutes`` (the last full block of ``--every`` steps) or
``--n_steps``.  ``--report`` prints, per dtype and recorded step, each quantity's
range over the JAX seeds and the port's seeds, and how many of the port's readings
lie inside the JAX seeds' [min, max].

Runs on the CPU only (JAX and the port in one process, one thread each).

``--port_only`` runs the port's side alone, without JAX (the card's host has none),
on ``--device`` (default cuda): the same set, episodes, held-out episodes and
columns, the noise the port's own draw from its state's generator (seeded with
``--seed``), the held-out GIM fakes' noise one draw of a generator seeded 999, and
the ``gap_*`` columns empty.  f32 runs with TF32 off (``ops/precision.py:exact_f32``).
Its files are ``<out>/port_<dtype>_style<S>_b<B>_s<seed>.csv`` and ``.json``.

``--signature`` reads the swing from each run's records (``swing_signature``): a
trajectory CSV (each side), or a directory of the flagship study's grids
(``port_flag_s<seed>[_f32]_eval_<step>.csv``: the GIM authenticator's row against
the GIM attacker).
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import glob
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

COLUMNS = ("step", "side", "au_out_on_real", "au_out_on_fake", "im_loss", "au_loss",
           "au_loss_on_real", "au_loss_on_fake", "disp_au", "disp_im", "gap_au", "gap_im",
           "auc_gim", "auc_replay", "score_real_mean", "score_real_std", "score_gim_mean",
           "score_gim_std", "score_replay_mean", "score_replay_std")
WINDOW_KEYS = COLUMNS[2:8]
EVAL_KEYS = COLUMNS[12:]
REPORT_KEYS = ("au_out_on_real", "au_out_on_fake", "disp_au", "disp_im", "auc_gim",
               "auc_replay", "score_real_std", "score_gim_mean")
# the swing: the real scores' std rises to SWING_RISE x its first record's, and a later
# record within SWING_WITHIN steps has GIM AUC <= SWING_AUC and the real std back under
# SWING_BACK x the first record's
SWING_RISE, SWING_WITHIN, SWING_AUC, SWING_BACK = 50.0, 2500, 0.2, 5.0
EVAL_NOISE_SEED = 999
GRID_NAME = re.compile(r"port_flag_s(\d+)(?:_cards\d+)?(_f32)?_eval_(\d+)\.csv$")


def glyph_set(n_alphabets: int, n_chars: int, imgs_per_class: int, val_alphabets: int,
              img_size: int, seed: int = 0):
    """(train, held out): uint8 [classes, images, H, W, 1] from the hard glyph set's
    generator, in the order ``make_hard_glyph_ds.py`` draws them."""
    import numpy as np

    spec = importlib.util.spec_from_file_location("make_hard_glyph_ds",
                                                  REPO / "scripts" / "make_hard_glyph_ds.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    rng = np.random.default_rng(seed)
    train, val = [], []
    for a in range(n_alphabets):
        for _ in range(n_chars):
            skeleton = gen.sample_class_skeleton(rng)
            imgs = np.stack([gen.render_example(rng, skeleton, img_size)
                             for _ in range(imgs_per_class)])[..., None]
            (val if a < val_alphabets else train).append(imgs)
    return np.stack(train), np.stack(val)


def episodes(classes, b: int, m: int, n: int, k: int, rng):
    """b episodes: one class each, m + n + k of its images without replacement."""
    import numpy as np

    cls = rng.integers(len(classes), size=b)
    picks = np.stack([rng.permutation(classes.shape[1])[: m + n + k] for _ in range(b)])
    imgs = classes[cls[:, None], picks]
    return {"leaked_sample": imgs[:, :m], "real_sample": imgs[:, m:m + n],
            "si_sample": imgs[:, m + n:]}


def flat_params(tree_or_module):
    """{name: float64 numpy} of a Flax params tree or a torch module's parameters."""
    import numpy as np

    if hasattr(tree_or_module, "named_parameters"):
        return {k: p.detach().double().cpu().numpy()
                for k, p in tree_or_module.named_parameters()}
    from optimalstrategiesagainstgenerativeattacks_torch.port.transplant import (
        flax_to_state_dict,
    )

    return {k: np.asarray(v, np.float64) for k, v in flax_to_state_dict(tree_or_module, {}).items()}


def moments(real, fakes) -> list:
    """[real mean, real std, then each fake's mean and std] of score vectors."""
    import numpy as np

    return [float(f(x)) for x in (real, *fakes) for f in (np.mean, np.std)]


def distance(a: dict, b: dict) -> float:
    import numpy as np

    return float(np.sqrt(sum(np.sum((a[k] - b[k]) ** 2) for k in a)))


def port_readings(state, cfg, prep: dict, replay, z) -> list:
    """[GIM AUC, replay AUC, then the score moments] of the port's players on the
    held-out episodes: the authenticator's scores of the real episodes, of the
    impersonator's fakes with noise ``z`` and of the replayed leaked image."""
    import numpy as np
    import torch

    from optimalstrategiesagainstgenerativeattacks_torch.eval import authentication as teval
    from optimalstrategiesagainstgenerativeattacks_torch.eval.scorer import roc_auc
    from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg

    dt = timg.compute_dtype(cfg) or torch.float32
    score = teval.get_au_function(state.au, dt, state.device)
    with torch.no_grad():
        fake = state.im(torch.from_numpy(prep["leaked_sample"]).to(state.device, dt), cfg.n,
                        cfg.remove_noise_mean, z=z.to(state.device, dt))
    real = score(prep["real_sample"], prep["si_sample"]).float().cpu().numpy().ravel()
    fakes = [score(f, prep["si_sample"]).float().cpu().numpy().ravel()
             for f in (fake.float().cpu().numpy(), replay)]
    return [float(roc_auc(np.r_[np.ones(len(real)), np.zeros(len(f))], np.r_[real, f]))
            for f in fakes] + moments(real, fakes)


def held_out(args, cfg):
    """(train classes, prepared held-out episodes, the replay fakes) of a run."""
    import numpy as np

    train, val = glyph_set(args.n_alphabets, args.n_chars, 20, 2, cfg.img_size)
    eval_batch = episodes(val, args.eval_episodes, cfg.m, cfg.n, cfg.k,
                          np.random.default_rng(12345))
    prep = {k: (v.astype(np.float32) / 127.5 - 1.0) for k, v in eval_batch.items()}
    return train, prep, np.repeat(prep["leaked_sample"][:, :1], cfg.n, axis=1)


def write_rows(path: str, rows: list) -> None:
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, COLUMNS, lineterminator="\n")
        w.writeheader()
        w.writerows(rows)


def run_info(args, cfg, step: int, seconds: float, **extra) -> dict:
    return {"config": dataclasses.asdict(cfg), "steps": step, "seconds": seconds,
            "every": args.every, "eval_episodes": args.eval_episodes,
            "set": {"n_alphabets": args.n_alphabets, "n_chars": args.n_chars,
                    "imgs_per_class": 20, "held_out_alphabets": 2}, **extra}


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card, or "not read"."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "not read"


def port_name(args) -> str:
    return f"port_{args.compute_dtype}_style{args.style_dim}_b{args.batch_size}_s{args.seed}"


def run_port(args) -> None:
    """The port's side alone on ``args.device``: its own noise, the gaps left empty."""
    import numpy as np
    import torch

    from optimalstrategiesagainstgenerativeattacks_torch.ops.precision import exact_f32
    from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg
    from optimalstrategiesagainstgenerativeattacks_torch.utils.config import ImageGameConfig

    torch.set_num_threads(1)
    exact_f32()
    t0 = time.perf_counter()
    cfg = ImageGameConfig(img_size=32, style_dim=args.style_dim, batch_size=args.batch_size,
                          compute_dtype=args.compute_dtype, seed=args.seed)
    train, prep, replay = held_out(args, cfg)
    stream = np.random.default_rng(args.seed)
    au, im = timg.build_models(cfg)
    state = timg.create_state(cfg, au, im, args.seed, args.device)
    eval_z = timg.noise(cfg, args.eval_episodes,
                        torch.Generator(device=args.device).manual_seed(EVAL_NOISE_SEED),
                        args.device)
    start = {"au": flat_params(state.au), "im": flat_params(state.im)}
    card = card_line() if args.device == "cuda" else "cpu"
    print(f"port only, {args.compute_dtype} style {args.style_dim} B {args.batch_size} seed "
          f"{args.seed} on {args.device} ({card}): set {train.shape}", flush=True)

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, port_name(args) + ".csv")
    rows, window = [], []
    deadline = t0 + 60 * args.minutes
    step = 0
    while step < args.n_steps:
        metrics, _ = timg.train_step(
            state, episodes(train, cfg.batch_size, cfg.m, cfg.n, cfg.k, stream))
        window.append(torch.stack([metrics[k] for k in WINDOW_KEYS]))
        step += 1
        if step % args.every:
            continue
        row = {"step": step, "side": "port", "gap_au": "", "gap_im": ""}
        row.update(zip(WINDOW_KEYS, torch.stack(window).mean(0).tolist()))
        window = []
        for p, module in (("au", state.au), ("im", state.im)):
            row[f"disp_{p}"] = distance(flat_params(module), start[p])
        row.update(zip(EVAL_KEYS, port_readings(state, cfg, prep, replay, eval_z)))
        rows.append(row)
        write_rows(path, rows)
        print(f"step {step} ({time.perf_counter() - t0:.0f} s): out real/fake "
              f"{row['au_out_on_real']:+.4f}/{row['au_out_on_fake']:+.4f}; gim AUC "
              f"{row['auc_gim']:.4f}; real score std {row['score_real_std']:.4g}", flush=True)
        if time.perf_counter() + (time.perf_counter() - t0) / step * args.every > deadline:
            break
    seconds = time.perf_counter() - t0
    signature = swing_signature(records(rows, "port"))
    with open(os.path.join(args.out, port_name(args) + ".json"), "w") as f:
        json.dump(run_info(args, cfg, step, seconds, mode="port_only", device=args.device,
                           card=card, steps_per_sec=step / seconds, signature=signature),
                  f, indent=1)
        f.write("\n")
    print(f"{path}: {step} steps in {seconds:.1f} s; swing {signature}")


def records(rows: list, side: str) -> list:
    """[(step, real scores' std, GIM AUC)] of one side's rows, in step order."""
    return sorted((int(float(r["step"])), float(r["score_real_std"]), float(r["auc_gim"]))
                  for r in rows if r["side"] == side)


def grid_records(csv_dir: str) -> dict:
    """{(seed, "bf16" or "f32"): records} of the flagship study's grids in ``csv_dir``:
    the GIM authenticator's row against the GIM attacker."""
    out = {}
    for path in sorted(glob.glob(os.path.join(csv_dir, "port_flag_s*_eval_*.csv"))):
        m = GRID_NAME.search(os.path.basename(path))
        if not m:
            continue
        with open(path, newline="") as f:
            row = next(r for r in csv.DictReader(f)
                       if r["au_type"] == "gim" and r["im_type"] == "gim")
        out.setdefault((int(m.group(1)), "f32" if m.group(2) else "bf16"), []).append(
            (int(m.group(3)), float(row["score_real_std"]), float(row["auc"])))
    return {k: sorted(v) for k, v in out.items()}


def swing_signature(recs: list):
    """The swing in records [(step, real std, GIM AUC)], or None.

    The first record's real std is the scale.  The swing is met at the first record
    whose GIM AUC is at most ``SWING_AUC`` and whose real std is at most
    ``SWING_BACK`` x the scale, when an earlier record within ``SWING_WITHIN`` steps
    before it had a real std of at least ``SWING_RISE`` x the scale.  Returns
    {"first", "scale", "rise" (that earlier record's step, the first such), "peak",
    "collapse" (the step it is met at), "auc", "std"}."""
    if not recs:
        return None
    first, scale, _ = recs[0]
    for i, (step, std, auc) in enumerate(recs):
        if auc > SWING_AUC or std > SWING_BACK * scale:
            continue
        risen = [(s, v) for s, v, _ in recs[:i]
                 if v >= SWING_RISE * scale and step - s <= SWING_WITHIN]
        if risen:
            return {"first": first, "scale": scale, "rise": risen[0][0],
                    "peak": max(v for _, v in risen) / scale, "collapse": step,
                    "auc": auc, "std": std}
    return None


def signature_report(paths: list) -> dict:
    """Print the swing verdict of each trajectory CSV's sides and each grid
    directory's runs; returns {label: signature or None}."""
    out = {}
    for path in paths:
        if os.path.isdir(path):
            runs = {f"{path} s{seed} {dtype}": recs
                    for (seed, dtype), recs in grid_records(path).items()}
        else:
            with open(path, newline="") as f:
                rows = list(csv.DictReader(f))
            runs = {f"{path} {side}": records(rows, side)
                    for side in dict.fromkeys(r["side"] for r in rows)}
        for label, recs in runs.items():
            sig = out[label] = swing_signature(recs)
            last = recs[-1] if recs else None
            print(f"{label}: {len(recs)} records to step {last and last[0]}; " + (
                f"swing MET at {sig['collapse']} (real std x{sig['peak']:.0f} of step "
                f"{sig['first']}'s {sig['scale']:.4g} from step {sig['rise']}; GIM AUC "
                f"{sig['auc']:.4f}, real std {sig['std']:.4g})" if sig else "swing not met"))
    return out


def run(args) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from sklearn.metrics import roc_auc_score

    from optimalstrategiesagainstgenerativeattacks_torch.port.transplant import (
        load_flax,
        state_dict_to_flax,
    )
    from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg
    from optimalstrategiesagainstgenerativeattacks_torch.utils.config import ImageGameConfig
    from optimalstrategiesagainstgenerativeattacks_tpu.eval import authentication as jeval
    from optimalstrategiesagainstgenerativeattacks_tpu.train import image as jimg
    from optimalstrategiesagainstgenerativeattacks_tpu.train.state import GameState
    from optimalstrategiesagainstgenerativeattacks_tpu.utils import config as jconfig

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    cfg = ImageGameConfig(img_size=32, style_dim=args.style_dim, batch_size=args.batch_size,
                          compute_dtype=args.compute_dtype, seed=args.seed)
    jcfg = jconfig.ImageGameConfig(**dataclasses.asdict(cfg), au_microbatch=1)
    train, prep, replay = held_out(args, cfg)
    stream = np.random.default_rng(args.seed)

    # the start: the port's initialisation, carried into Flax and back
    au, im = timg.build_models(cfg)
    tstate = timg.create_state(cfg, au, im, args.seed, "cpu")
    av, iv = ({"params": p, "spectral": s} for p, s in (
        state_dict_to_flax({k: v.numpy() for k, v in module.state_dict().items()})
        for module in (tstate.au, tstate.im)))
    for module, v in ((tstate.au, av), (tstate.im, iv)):
        load_flax(module, v["params"], v["spectral"])
    jau, jim = jimg.build_models(jcfg)
    opt_au, opt_im, _ = jimg.make_optimizers(jcfg)
    jstate = GameState(step=jnp.asarray(-1, jnp.int32), params_au=av["params"],
                       params_im=iv["params"], spectral_au=av["spectral"],
                       spectral_im=iv["spectral"], opt_au=opt_au.init(av["params"]),
                       opt_im=opt_im.init(iv["params"]),
                       rng=jax.random.PRNGKey(args.seed))
    first = episodes(train, cfg.batch_size, cfg.m, cfg.n, cfg.k, np.random.default_rng(0))
    step_fn = jax.jit(jimg.make_train_step_fn(jcfg, jau, jim, opt_au, opt_im)).lower(
        jstate, {k: jnp.asarray(v) for k, v in first.items()}).compile()
    z_dtype = jnp.bfloat16 if cfg.compute_dtype == "bfloat16" else jnp.float32

    def draw(key, b):
        return jim.apply(iv, method=lambda mod: jax.random.normal(
            mod.make_rng("noise"), (b, cfg.n, cfg.style_dim), z_dtype), rngs={"noise": key})

    draw = jax.jit(draw, static_argnums=1)
    eval_z = np.asarray(draw(jax.random.PRNGKey(EVAL_NOISE_SEED), args.eval_episodes),
                        np.float32)
    start = {"au": flat_params(av["params"]), "im": flat_params(iv["params"])}
    print(f"{args.compute_dtype} seed {args.seed}: set {train.shape}, "
          f"compiled in {time.perf_counter() - t0:.1f} s", flush=True)

    def jax_aucs(state):
        variables = {"params": state.params_au, "spectral": state.spectral_au}
        score = jeval.get_au_function(jau, variables)
        fake = jim.apply({"params": state.params_im, "spectral": state.spectral_im},
                         jnp.asarray(prep["leaked_sample"]), cfg.n,
                         cfg.remove_noise_mean, False, z=jnp.asarray(eval_z, z_dtype))
        real = score(prep["real_sample"], prep["si_sample"]).ravel()
        fakes = [score(f, prep["si_sample"]).ravel() for f in (np.asarray(fake, np.float32), replay)]
        return [float(roc_auc_score(np.r_[np.ones(len(real)), np.zeros(len(f))], np.r_[real, f]))
                for f in fakes] + moments(real, fakes)

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"traj_{args.compute_dtype}_s{args.seed}.csv")
    rows, windows = [], {"jax": [], "port": []}
    deadline = t0 + 60 * args.minutes
    step = 0
    while step < args.n_steps:
        batch = episodes(train, cfg.batch_size, cfg.m, cfg.n, cfg.k, stream)
        z = np.asarray(draw(jax.random.split(jax.random.fold_in(jstate.rng, step))[1],
                            cfg.batch_size), np.float32)
        jstate, jmetrics, _ = step_fn(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tmetrics, _ = timg.train_step(tstate, batch, z=torch.from_numpy(z.copy()))
        windows["jax"].append({k: float(jmetrics[k]) for k in WINDOW_KEYS})
        windows["port"].append({k: float(tmetrics[k]) for k in WINDOW_KEYS})
        step += 1
        if step % args.every:
            continue
        params = {"jax": {"au": flat_params(jstate.params_au), "im": flat_params(jstate.params_im)},
                  "port": {"au": flat_params(tstate.au), "im": flat_params(tstate.im)}}
        aucs = {"jax": jax_aucs(jstate),
                "port": port_readings(tstate, cfg, prep, replay, torch.from_numpy(eval_z.copy()))}
        for side in ("jax", "port"):
            row = {"step": step, "side": side}
            row.update({k: float(np.mean([w[k] for w in windows[side]])) for k in WINDOW_KEYS})
            for p in ("au", "im"):
                row[f"disp_{p}"] = distance(params[side][p], start[p])
                row[f"gap_{p}"] = distance(params["port"][p], params["jax"][p])
            row.update(zip(EVAL_KEYS, aucs[side]))
            rows.append(row)
        windows = {"jax": [], "port": []}
        write_rows(path, rows)
        j, p = rows[-2], rows[-1]
        print(f"step {step} ({time.perf_counter() - t0:.0f} s): out real/fake jax "
              f"{j['au_out_on_real']:+.4f}/{j['au_out_on_fake']:+.4f} port "
              f"{p['au_out_on_real']:+.4f}/{p['au_out_on_fake']:+.4f}; gim AUC jax "
              f"{j['auc_gim']:.4f} port {p['auc_gim']:.4f}; real score std jax "
              f"{j['score_real_std']:.4g} port {p['score_real_std']:.4g}; gap au "
              f"{p['gap_au']:.3g} im {p['gap_im']:.3g}", flush=True)
        if time.perf_counter() + (time.perf_counter() - t0) / step * args.every > deadline:
            break
    with open(os.path.join(args.out, f"traj_{args.compute_dtype}_s{args.seed}.json"), "w") as f:
        json.dump(run_info(args, cfg, step, time.perf_counter() - t0), f, indent=1)
        f.write("\n")
    print(f"{path}: {step} steps in {time.perf_counter() - t0:.1f} s")


def load(out: str) -> dict:
    """{(dtype, seed): [row, ...]} of the CSVs in ``out``."""
    runs = {}
    for path in sorted(glob.glob(os.path.join(out, "traj_*_s*.csv"))):
        dtype, seed = Path(path).stem[len("traj_"):].rsplit("_s", 1)
        with open(path, newline="") as f:
            runs[(dtype, int(seed))] = [
                {k: (v if k == "side" else float(v)) for k, v in r.items()}
                for r in csv.DictReader(f)]
    return runs


def report(out: str) -> dict:
    """Print, per dtype and step that every seed reached, each quantity's [min, max]
    over the JAX seeds and over the port's; returns {dtype: (port readings inside
    the JAX seeds' range, port readings)}."""
    runs = load(out)
    verdict = {}
    for dtype in sorted({d for d, _ in runs}):
        seeds = sorted(s for d, s in runs if d == dtype)
        by = {s: {(r["step"], r["side"]): r for r in runs[(dtype, s)]} for s in seeds}
        steps = sorted(set.intersection(*({st for st, side in b} for b in by.values())))
        print(f"\n{dtype}, seeds {seeds}: JAX [min, max] over seeds | port [min, max]")
        print("| step | " + " | ".join(f"{k} JAX | port" for k in REPORT_KEYS) + " |")
        print("|---|" + "---|---|" * len(REPORT_KEYS))
        inside = total = 0
        for st in steps:
            cells = []
            for k in REPORT_KEYS:
                j = [by[s][(st, "jax")][k] for s in seeds]
                p = [by[s][(st, "port")][k] for s in seeds]
                inside += sum(min(j) <= v <= max(j) for v in p)
                total += len(p)
                cells.append(f"[{min(j):.4g}, {max(j):.4g}] | [{min(p):.4g}, {max(p):.4g}]")
            print(f"| {int(st)} | " + " | ".join(cells) + " |")
        gaps = [by[s][(steps[-1], "port")] for s in seeds] if steps else []
        if gaps:
            print(f"last step {int(steps[-1])}: the port's distance to the JAX run of its seed, "
                  f"au {max(g['gap_au'] for g in gaps):.4g}, im "
                  f"{max(g['gap_im'] for g in gaps):.4g}; JAX displacement from the start "
                  f"au {min(by[s][(steps[-1], 'jax')]['disp_au'] for s in seeds):.4g}, im "
                  f"{min(by[s][(steps[-1], 'jax')]['disp_im'] for s in seeds):.4g}")
        print(f"{dtype}: {inside} of {total} port readings inside the JAX seeds' range")
        verdict[dtype] = (inside, total)
    return verdict


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--minutes", type=float, default=30.0)
    ap.add_argument("--n_steps", type=int, default=10 ** 9)
    ap.add_argument("--every", type=int, default=25)
    ap.add_argument("--style_dim", type=int, default=32)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--n_alphabets", type=int, default=8)
    ap.add_argument("--n_chars", type=int, default=12)
    ap.add_argument("--eval_episodes", type=int, default=96)
    ap.add_argument("--out", default="docs/flagship_trajectory")
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--port_only", action="store_true",
                    help="the port's side alone on --device, its own noise, no JAX")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="--port_only: the port's device")
    ap.add_argument("--signature", nargs="+", metavar="PATH",
                    help="print the swing verdict of these trajectory CSVs or grid "
                         "directories, and stop")
    args = ap.parse_args(argv)
    os.chdir(REPO)
    if args.report:
        report(args.out)
    elif args.signature:
        signature_report(args.signature)
    elif args.port_only:
        run_port(args)
    else:
        run(args)


if __name__ == "__main__":
    main()
