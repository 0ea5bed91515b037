"""Authentication evaluation: GIM and baseline authenticators against GIM, replay and
random-source attackers, from the port's own checkpoints.

Counterpart of ``optimalstrategiesagainstgenerativeattacks_tpu/eval/authentication.py``
(parity with the reference's ``authentication_eval/eval_gim_on_authentication.py``):
it loads a GIM checkpoint (the latest by default) with its ``args.json``,
rebuilds the models, builds score closures for the gim / siamese / arcface
authenticators and the gim / replay / rnd_src impersonators, runs the grid,
and writes a CSV with the exact column set (:210-215) in the layout
``pandas.DataFrame.to_csv`` writes (a leading unnamed index column), using
the ``csv`` module.

The closures run under ``torch.inference_mode()`` on the eval's device and
return tensors there: the GIM attacker's fake never leaves the device, and
the scores reach the host once per pairing (``eval/scorer.py``).  The GIM
players use the spectral u, v stored in the checkpoint (no power
iteration), and their inputs are cast to the game's compute dtype.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from optimalstrategiesagainstgenerativeattacks_torch.baselines.training import (
    build_arcface,
    build_siamese,
)
from optimalstrategiesagainstgenerativeattacks_torch.eval.agents import (
    Authenticator,
    Impersonator,
    rand_source_impersonator,
    replay_impersonator,
)
from optimalstrategiesagainstgenerativeattacks_torch.eval.scorer import (
    acc_at_threshold,
    balanced_threshold,
    eval_authenticator_and_impersonator,
    real_quantile_threshold,
)
from optimalstrategiesagainstgenerativeattacks_torch.ops.precision import exact_f32
from optimalstrategiesagainstgenerativeattacks_torch.train.checkpoints import (
    CheckpointIO,
    get_latest_ckpt,
)
from optimalstrategiesagainstgenerativeattacks_torch.train.image import (
    build_models,
    compute_dtype,
    create_state,
)
from optimalstrategiesagainstgenerativeattacks_torch.utils.config import (
    ImageGameConfig,
    load_args,
)

CSV_COLS = (
    "au_type", "im_type", "ds_root", "gim_exp_dir",
    "m", "n", "k", "acc", "acc_on_fake", "acc_on_real", "auc",
)
# appended with ``calibrate_q``
CAL_COLS = (
    "th_cal", "acc_cal", "acc_on_fake_cal", "acc_on_real_cal",
    "th_balanced", "acc_balanced",
    "score_real_mean", "score_real_std",
    "score_fake_mean", "score_fake_std",
)
PRINTED_COLS = ("au_type", "im_type", "acc", "acc_on_fake", "acc_on_real")


def _to(x, device, dtype=torch.float32) -> torch.Tensor:
    """A sample (tensor or numpy) on ``device`` in ``dtype``."""
    return torch.as_tensor(x, device=device).to(dtype)


########################################################################################################################
# Score closures
########################################################################################################################


def get_au_function(au, dtype: torch.dtype, device) -> Callable:
    """GIM authenticator score fn (:28-48): [B, 1] logits in the compute dtype."""

    @torch.inference_mode()
    def au_model_func(test_sample, si_sample):
        return au(_to(test_sample, device, dtype), _to(si_sample, device, dtype))

    return au_model_func


def get_im_function(im, dtype: torch.dtype, remove_noise_mean: bool, n: int, device,
                    seed: int = 0) -> Callable:
    """GIM impersonator generation fn (:75-80).  The noise comes from a generator
    on ``device`` seeded ``seed`` that every call advances; ``z`` [B, n, style]
    replaces the draw (tests inject it)."""
    generator = torch.Generator(device=device).manual_seed(seed)

    @torch.inference_mode()
    def im_model_func(leaked_sample, n=n, z: Optional[torch.Tensor] = None):
        if z is not None:
            z = _to(z, device, dtype)
        return im(_to(leaked_sample, device, dtype), n, remove_noise_mean, z=z,
                  generator=generator)

    return im_model_func


def get_siamese_au_function(model, device) -> Callable:
    """Siamese score fn: mean-pooled embeddings -> |diff| classifier (:51-65)."""
    model.eval()

    def embed(sample):
        b, s = sample.shape[:2]
        emb = model.encode(sample.reshape(b * s, *sample.shape[2:]))
        return emb.reshape(b, s, -1).mean(dim=1)

    @torch.inference_mode()
    def au_model_func(test_sample, si_sample):
        return model.classify(embed(_to(si_sample, device)), embed(_to(test_sample, device)))

    return au_model_func


def get_arcface_au_function(arcface, device) -> Callable:
    """ArcFace score fn: mean image per sample -> -||emb1 - emb2||^2 (:68-76)."""
    arcface.eval()

    @torch.inference_mode()
    def au_model_func(test_sample, si_sample):
        x1 = _to(test_sample, device).mean(dim=1)
        x2 = _to(si_sample, device).mean(dim=1)
        return arcface.predict(x1, x2)[0]

    return au_model_func


########################################################################################################################
# Agents from checkpoints
########################################################################################################################


# One grid restores the same checkpoint up to six times (gim au x 3
# pairings + gim im + baseline rows): cache the last two restored states
# (the au dir and the im dir), keyed by path, modification time, device and
# the arguments the models are built from.
_RESTORE_CACHE: dict = {}


def _restore_gim_state(ckpt_path: str, args_dict: dict, device):
    """(cfg, au, im, state): the game's models built from ``args_dict``, the players
    restored from the snapshot, on ``device``."""
    path = os.path.abspath(ckpt_path)
    key = (path, os.stat(path).st_mtime_ns, str(torch.device(device)),
           json.dumps(args_dict, sort_keys=True, default=str))
    if key in _RESTORE_CACHE:
        return _RESTORE_CACHE[key]
    cfg = ImageGameConfig.from_dict(args_dict)
    au, im = build_models(cfg)
    state = create_state(cfg, au, im, cfg.seed, device)
    CheckpointIO(os.path.dirname(path)).load(path, state, players_only=True)
    while len(_RESTORE_CACHE) >= 2:
        _RESTORE_CACHE.pop(next(iter(_RESTORE_CACHE)))
    _RESTORE_CACHE[key] = (cfg, au, im, state)
    return cfg, au, im, state


def get_gim_authenticator(ckpt_path: str, args_dict: dict, device) -> Authenticator:
    cfg, _, _, state = _restore_gim_state(ckpt_path, args_dict, device)
    return Authenticator(get_au_function(state.au, compute_dtype(cfg) or torch.float32, device))


def get_gim_impersonator(ckpt_path: str, args_dict: dict, device) -> Impersonator:
    cfg, _, _, state = _restore_gim_state(ckpt_path, args_dict, device)
    return Impersonator(get_im_function(state.im, compute_dtype(cfg) or torch.float32,
                                        cfg.remove_noise_mean, cfg.n, device))


def _load_payload(ckpt_path: str) -> dict:
    return torch.load(os.path.abspath(ckpt_path), map_location="cpu", weights_only=True)


def get_siamese_authenticator(ckpt_path: str, args_dict: dict, device) -> Authenticator:
    model = build_siamese(args_dict.get("img_channels", 1), args_dict.get("img_size", 32))
    model.load_state_dict(_load_payload(ckpt_path)["model"])
    return Authenticator(get_siamese_au_function(model.to(device), device))


def get_arcface_authenticator(ckpt_path: str, args_dict: dict, device) -> Authenticator:
    weights = _load_payload(ckpt_path)["arcface"]
    arcface = build_arcface(args_dict, n_classes=weights["head.weight"].shape[0])
    arcface.load_state_dict(weights)
    return Authenticator(get_arcface_au_function(arcface.to(device), device), th=arcface.th)


def get_authenticator(au_type: str, ckpt_path: str, args_dict: dict, device) -> Authenticator:
    if au_type == "gim":
        return get_gim_authenticator(ckpt_path, args_dict, device)
    if au_type == "siamese":
        return get_siamese_authenticator(ckpt_path, args_dict, device)
    if au_type == "arcface":
        return get_arcface_authenticator(ckpt_path, args_dict, device)
    raise ValueError("unsupported authenticator type")


def get_impersonator(im_type: str, ckpt_path: str, ds, args_dict: dict, device) -> Impersonator:
    if im_type == "gim":
        return get_gim_impersonator(ckpt_path, args_dict, device)
    if im_type == "replay":
        rng = np.random.default_rng(0)
        return Impersonator(lambda leaked_sample, n: replay_impersonator(leaked_sample, n, rng))
    if im_type == "rnd_src":
        rng = np.random.default_rng(1)
        return Impersonator(
            lambda leaked_sample, n: rand_source_impersonator(leaked_sample, n, ds, rng)
        )
    raise ValueError("unsupported impersonator type")


########################################################################################################################
# The grid
########################################################################################################################


def get_exp_args_from_dir(outdir: str, ckpt_dir: str = "ckpts", specific_model=None):
    """Latest (or named) checkpoint + args.json from an experiment dir (:182-192)."""
    ckpt_dir_path = os.path.join(outdir, ckpt_dir)
    if specific_model is None:
        model_file_path = get_latest_ckpt(ckpt_dir_path)
    else:
        model_file_path = os.path.join(ckpt_dir_path, specific_model)
    return model_file_path, load_args(outdir)


def eval_game_for_pair(
    au_type: str, im_type: str, au_outdir: str, im_outdir: str,
    ds, batch_size: int, num_workers: int = 0,
    ckpt_dir: str = "ckpts", specific_model=None, return_scores: bool = False,
    device="cuda",
):
    """(acc, acc_on_fake, acc_on_real, auc) for one au/im pairing (:155-179).

    ``specific_model`` names a checkpoint of the *GIM* experiment; when the
    authenticator lives in another directory (a baseline's) that lacks the
    name, the authenticator falls back to that directory's latest
    checkpoint, so a cross-directory GIM-vs-GIM pairing still honours
    ``specific_model`` (the reference applies it to both directories and
    fails on baselines, ``eval_gim_on_authentication.py:163-164``).
    """
    au_specific = specific_model
    if (
        specific_model is not None
        and au_outdir != im_outdir
        and not os.path.exists(os.path.join(au_outdir, ckpt_dir, specific_model))
    ):
        print(
            f"warning: {specific_model!r} not found under {au_outdir}/{ckpt_dir}; "
            "falling back to the latest checkpoint for the authenticator"
        )
        au_specific = None
    au_ckpt_path, au_args_dict = get_exp_args_from_dir(au_outdir, ckpt_dir, au_specific)
    im_ckpt_path, im_args_dict = get_exp_args_from_dir(im_outdir, ckpt_dir, specific_model)
    au_agent = get_authenticator(au_type, au_ckpt_path, au_args_dict, device)
    im_agent = get_impersonator(im_type, im_ckpt_path, ds, im_args_dict, device)
    return eval_authenticator_and_impersonator(
        ds=ds, batch_size=batch_size, authenticator=au_agent, impersonator=im_agent,
        num_workers=num_workers, return_scores=return_scores, device=device,
    )


def format_table(rows, cols) -> str:
    """Rows as a right-aligned text table with an index column."""
    cells = [[""] + list(cols)] + [[str(i)] + [str(r[c]) for c in cols]
                                   for i, r in enumerate(rows)]
    widths = [max(len(line[j]) for line in cells) for j in range(len(cells[0]))]
    return "\n".join("  ".join(v.rjust(w) for v, w in zip(line, widths)) for line in cells)


def write_csv(csv_file_path: str, rows, cols) -> None:
    """``rows`` in the layout of ``pandas.DataFrame(rows, columns=cols).to_csv``."""
    with open(csv_file_path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow([""] + list(cols))
        for i, row in enumerate(rows):
            writer.writerow([i] + ["" if row.get(c) is None else row[c] for c in cols])


def eval_authentication_task(
    ds, m: int, n: int, k: int,
    batch_size: int, num_workers: int,
    gim_exp_dir: str, csv_file_path: str,
    specific_model=None, baseline_exp_dir=None, baseline_type=None,
    calibrate_q=None, dump_scores_dir=None, device="cuda",
):
    """Full evaluation grid -> CSV (:195-252); returns the rows as dicts.

    ``calibrate_q`` (e.g. 0.95) appends calibrated-operating-point columns:
    ``th_cal`` = the threshold accepting that fraction of REAL scores
    (deployable: computed from enrollment data only, no attacker
    knowledge), the acc trio at ``th_cal``, score-distribution stats and the
    oracle balanced-accuracy threshold/acc for analysis.  The
    reference-parity columns (CSV_COLS) are unchanged.  ``dump_scores_dir``
    writes the raw real/fake score vectors per pairing as
    ``scores_{au}_{im}.npz``.
    """
    exact_f32()
    os.makedirs(os.path.dirname(os.path.abspath(csv_file_path)), exist_ok=True)
    want_scores = calibrate_q is not None or dump_scores_dir is not None
    rows = []
    au_type_list = ["gim"] if baseline_type is None else ["gim", baseline_type]
    for au_type in au_type_list:
        for im_type in ("gim", "replay", "rnd_src"):
            print(f"running {au_type} vs. {im_type}")
            au_outdir = gim_exp_dir if au_type == "gim" else baseline_exp_dir
            res = eval_game_for_pair(
                au_type=au_type, im_type=im_type,
                au_outdir=au_outdir, im_outdir=gim_exp_dir,
                ds=ds, batch_size=batch_size, num_workers=num_workers,
                specific_model=specific_model, return_scores=want_scores, device=device,
            )
            acc, acc_on_fake, acc_on_real, auc = res[:4]
            row = {
                "au_type": au_type, "im_type": im_type,
                "ds_root": ds.root, "gim_exp_dir": gim_exp_dir,
                "m": m, "n": n, "k": k,
                "acc": acc, "acc_on_fake": acc_on_fake,
                "acc_on_real": acc_on_real, "auc": auc,
            }
            if want_scores:
                score_real, score_fake = res[4]
                if dump_scores_dir is not None:
                    os.makedirs(dump_scores_dir, exist_ok=True)
                    np.savez(
                        os.path.join(dump_scores_dir, f"scores_{au_type}_{im_type}.npz"),
                        score_real=score_real, score_fake=score_fake,
                    )
                if calibrate_q is not None:
                    th_cal = real_quantile_threshold(score_real, calibrate_q)
                    c_acc, c_fake, c_real = acc_at_threshold(score_real, score_fake, th_cal)
                    th_bal = balanced_threshold(score_real, score_fake)
                    b_acc, _, _ = acc_at_threshold(score_real, score_fake, th_bal)
                    row.update({
                        "th_cal": th_cal, "acc_cal": c_acc,
                        "acc_on_fake_cal": c_fake, "acc_on_real_cal": c_real,
                        "th_balanced": th_bal, "acc_balanced": b_acc,
                        "score_real_mean": float(np.mean(score_real)),
                        "score_real_std": float(np.std(score_real)),
                        "score_fake_mean": float(np.mean(score_fake)),
                        "score_fake_std": float(np.std(score_fake)),
                    })
            rows.append(row)
            print(format_table([row], PRINTED_COLS))

    cols = list(CSV_COLS) + (list(CAL_COLS) if calibrate_q is not None else [])
    write_csv(csv_file_path, rows, cols)
    print(format_table(rows, PRINTED_COLS))
    return rows


def get_dataset(dataset_root, split, dataset_type, example_cnt_per_class,
                img_channels, img_size, m, n, k, seed: int = 0):
    """Episodic eval dataset factory (:255-290)."""
    from optimalstrategiesagainstgenerativeattacks_torch.data.episodic import (
        ImgGIMDataSet,
        OmniglotGIMDataSet,
    )

    common = dict(root=dataset_root, split=split, img_channels=img_channels, img_size=img_size,
                  m=m, n=n, si=k, example_cnt_per_class=example_cnt_per_class, seed=seed)
    if dataset_type == "omniglot":
        return OmniglotGIMDataSet(**common)
    if dataset_type == "voxceleb2":
        return ImgGIMDataSet(hierarchical=True, mirror=True, **common)
    if dataset_type == "general_imgs":
        return ImgGIMDataSet(hierarchical=False, mirror=True, **common)
    raise ValueError("Supports only dataset_type in ['omniglot','voxceleb2','general_imgs']")
