"""Batched authentication-game rollout and scoring.

Counterpart of ``optimalstrategiesagainstgenerativeattacks_tpu/eval/scorer.py``
(protocol parity with the reference's
``authentication_eval/authentication_score.py``: score real vs si, generate
the fake from the leaked images, score fake vs si; accuracy =
0.5 * (acc_on_real + acc_on_fake), ``comp_acc:31-42``; AUC over the
concatenated score vectors, ``:94-96``):

  * **Fixed batch shape.** Every call of an agent sees exactly
    ``batch_size`` episodes: the last partial batch is padded by wrapping
    the epoch around, and the padding's scores are dropped on the host.
    The padding decides how many draws the random-source attacker takes,
    so it is part of the result, not only of the TPU's compile cache.
  * **uint8 feeding.** Batches cross to the device as uint8 and are shifted
    to [-1, 1] f32 there (``train/image.py:prepare``).
  * **One transfer.** Scores stay on the device and reach the host in one
    transfer after the loop.
  * **AUC without sklearn.** ``roc_auc`` is the Mann-Whitney U statistic
    from average ranks (ties shared), which equals sklearn's
    ``roc_auc_score``.

The calibration helpers (``real_quantile_threshold``, ``balanced_threshold``,
``acc_at_threshold``) and ``comp_acc`` are copies of the JAX package's.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from optimalstrategiesagainstgenerativeattacks_torch.data.episodic import EpisodicBatchLoader
from optimalstrategiesagainstgenerativeattacks_torch.train.image import prepare


def write_results(file_path, acc, acc_on_fake, acc_on_real, print_to_stdout=False):
    s = (
        f"accuracy: {acc}\naccuracy on fake: {acc_on_fake}\n"
        f"accuracy on real: {acc_on_real}\n"
    )
    os.makedirs(os.path.dirname(file_path), exist_ok=True)
    with open(file_path, "w") as f:
        f.write(s)
    if print_to_stdout:
        print(s)


def comp_acc(pred_on_real: np.ndarray, pred_on_fake: np.ndarray):
    """(acc, acc_on_fake, acc_on_real) from 1-d prediction vectors."""
    pred_on_real = np.asarray(pred_on_real).reshape(-1)
    pred_on_fake = np.asarray(pred_on_fake).reshape(-1)
    assert pred_on_real.shape[0] == pred_on_fake.shape[0]
    acc_on_real = pred_on_real.astype(np.float64).mean()
    acc_on_fake = (pred_on_fake == 0).astype(np.float64).mean()
    acc = 0.5 * (acc_on_real + acc_on_fake)
    return float(acc), float(acc_on_fake), float(acc_on_real)


def real_quantile_threshold(score_real: np.ndarray, accept_frac: float) -> float:
    """Deployable calibration: the threshold that accepts ``accept_frac`` of
    the REAL scores (no attacker knowledge needed: an operator can compute
    it from enrollment data alone)."""
    score_real = np.asarray(score_real, np.float64).reshape(-1)
    return float(np.quantile(score_real, 1.0 - accept_frac))


def balanced_threshold(score_real: np.ndarray, score_fake: np.ndarray) -> float:
    """Oracle calibration (analysis only): the threshold maximising balanced
    accuracy 0.5*(TPR + TNR) over the pooled real/fake scores."""
    sr = np.sort(np.asarray(score_real, np.float64).reshape(-1))
    sf = np.sort(np.asarray(score_fake, np.float64).reshape(-1))
    cand = np.unique(np.concatenate([sr, sf]))
    # midpoints between consecutive candidates + outer sentinels
    th = np.concatenate([[cand[0] - 1.0], (cand[:-1] + cand[1:]) / 2.0,
                         [cand[-1] + 1.0]])
    # searchsorted(x, th, 'left') counts x < th, so TPR = P(sr >= th) and
    # TNR = P(sf < th) without the O(N^2) matrices
    tpr = 1.0 - np.searchsorted(sr, th, side="left") / sr.size
    tnr = np.searchsorted(sf, th, side="left") / sf.size
    return float(th[np.argmax(0.5 * (tpr + tnr))])


def acc_at_threshold(score_real: np.ndarray, score_fake: np.ndarray, th: float):
    """(acc, acc_on_fake, acc_on_real) of the >= th operating point."""
    sr = np.asarray(score_real, np.float64).reshape(-1)
    sf = np.asarray(score_fake, np.float64).reshape(-1)
    return comp_acc((sr >= th).astype(np.int64), (sf >= th).astype(np.int64))


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Area under the ROC curve: (sum of the positives' average ranks - n_pos (n_pos + 1) / 2)
    / (n_pos n_neg), tied scores sharing their ranks (= sklearn's ``roc_auc_score``)."""
    from scipy.stats import rankdata

    positive = np.asarray(labels).reshape(-1) > 0
    ranks = rankdata(np.asarray(scores, np.float64).reshape(-1))
    n_pos = int(positive.sum())
    n_neg = positive.size - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("roc_auc needs both classes among the labels")
    return float((ranks[positive].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def _pad_to(arr: np.ndarray, size: int) -> np.ndarray:
    """Grow axis 0 to ``size`` by cyclic repetition of whole items."""
    if arr.shape[0] == size:
        return arr
    reps = -(-size // arr.shape[0])
    return np.concatenate([arr] * reps, axis=0)[:size]


def _device_batches(
    ds, batch_size: int, num_workers: int, seed: int, max_iters: int, device
) -> Iterator[Tuple[Dict[str, torch.Tensor], int]]:
    """Yield ([-1, 1] f32 batch on ``device``, n_valid) at a fixed batch shape."""
    loader = EpisodicBatchLoader(
        ds, batch_size=batch_size, shuffle=True, drop_last=False,
        num_workers=num_workers, seed=seed,
    )
    for i, raw in enumerate(loader):
        if i >= max_iters:
            return
        n_valid = raw["real_sample"].shape[0]
        batch = {
            key: prepare(None, _pad_to(raw[key], batch_size), device)
            for key in ("real_sample", "leaked_sample", "si_sample")
        }
        yield batch, n_valid


def eval_authenticator_and_impersonator(
    ds,
    batch_size: int,
    authenticator,
    impersonator,
    num_workers: int = 0,
    dbg: bool = False,
    seed: int = 0,
    return_scores: bool = False,
    device="cuda",
):
    """Full-game rollout over the dataset -> (acc, acc_on_fake, acc_on_real, auc)
    [+ (score_real, score_fake) when ``return_scores``].

    The agents take and return tensors on ``device`` (an attacker may return
    a numpy array; the authenticator's closure moves it); the scores of
    every batch reach the host in one transfer after the loop.
    """
    max_iters = 1000 if dbg else len(ds)
    score = authenticator.au_model_func
    dev_real, dev_fake, valids = [], [], []
    for batch, n_valid in _device_batches(ds, batch_size, num_workers, seed, max_iters, device):
        real, si = batch["real_sample"], batch["si_sample"]
        n = real.shape[1]
        dev_real.append(torch.as_tensor(score(test_sample=real, si_sample=si)).reshape(-1))
        fake = impersonator.act(leaked_sample=batch["leaked_sample"], n=n)
        dev_fake.append(torch.as_tensor(score(test_sample=fake, si_sample=si)).reshape(-1))
        valids.append(n_valid)
    host = torch.stack(dev_real + dev_fake).float().cpu().numpy()  # one transfer
    host_real, host_fake = host[: len(valids)], host[len(valids):]
    score_real = np.concatenate([s[:v] for s, v in zip(host_real, valids)])
    score_fake = np.concatenate([s[:v] for s, v in zip(host_fake, valids)])
    th = authenticator.th
    acc, acc_on_fake, acc_on_real = comp_acc((score_real >= th).astype(np.int64),
                                             (score_fake >= th).astype(np.int64))
    labels = np.concatenate([np.ones_like(score_real), np.zeros_like(score_fake)])
    auc = roc_auc(labels, np.concatenate([score_real, score_fake]))
    if return_scores:
        return acc, acc_on_fake, acc_on_real, auc, (score_real, score_fake)
    return acc, acc_on_fake, acc_on_real, auc


def eval_dis_on_multiple_im(
    ds, batch_size: int, authenticator, impersonator_dict: Dict, num_workers: int = 0,
    device="cuda",
):
    """Sweep one authenticator over several impersonators (:100-121)."""
    results = {}
    for im_key, im_agent in impersonator_dict.items():
        print(f"\nEvaluating on impersonator: {im_key}\n")
        acc, acc_on_fake, acc_on_real, auc = eval_authenticator_and_impersonator(
            ds=ds, batch_size=batch_size, authenticator=authenticator,
            impersonator=im_agent, num_workers=num_workers, device=device,
        )
        results[im_key] = {
            "acc": acc, "acc_on_fake": acc_on_fake, "acc_on_real": acc_on_real, "auc": auc,
        }
    return results
