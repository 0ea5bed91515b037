"""Training loops of the baseline authenticators (ArcFace, Siamese).

Counterpart of ``optimalstrategiesagainstgenerativeattacks_tpu/baselines/training.py``
(the reference ships the baseline models and eval loading only), with the
same recipes, seeds and checkpoint names:

  * ArcFace: classification with the angular-margin head over
    ``ArcfaceDataSet`` (one class per identity); checkpoint payload
    ``{"arcface": state_dict}`` and args.json with num_layers / dropout /
    img_size / img_channels / emb_dim / th.
  * Siamese: binary same/different-source classification over pairs drawn
    from the episodic dataset; payload ``{"model": state_dict}``.  Two pair
    recipes: batch-hard mining on the device (default: hardest positive
    inside the episode, hardest negative across episodes, scored by the
    model's own classifier head) and random pairs (``mining="random"``).

Both use ``torch.optim.Adam`` with its defaults (those of ``optax.adam``).
A checkpoint is one ``torch.save`` file at ``<outdir>/ckpts/model_{step:08d}``.
Each step leaves the parameters' gradients in ``.grad`` until the next.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from optimalstrategiesagainstgenerativeattacks_torch.baselines.arcface import ArcFace, Backbone
from optimalstrategiesagainstgenerativeattacks_torch.baselines.siamese import (
    ProtonetEmbeddingNet,
    SiameseNet,
)
from optimalstrategiesagainstgenerativeattacks_torch.data.episodic import EpisodicBatchLoader
from optimalstrategiesagainstgenerativeattacks_torch.nn.init import init_module
from optimalstrategiesagainstgenerativeattacks_torch.train.checkpoints import CKPT_PREFIX
from optimalstrategiesagainstgenerativeattacks_torch.train.image import prepare
from optimalstrategiesagainstgenerativeattacks_torch.train.losses import bce_with_logits
from optimalstrategiesagainstgenerativeattacks_torch.utils.config import save_args


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _adam_step(optimizer, loss) -> None:
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()


def _epochs(n_epochs: int, desc: str, progress: bool):
    epochs = range(n_epochs)
    if progress:
        try:
            from tqdm import tqdm

            epochs = tqdm(epochs, desc=desc)
        except ImportError:
            pass
    return epochs


def save_checkpoint(outdir: str, step: int, payload: dict) -> str:
    """One ``torch.save`` file at ``<outdir>/ckpts/model_{step:08d}``, written whole or not at all."""
    path = os.path.join(outdir, "ckpts", f"{CKPT_PREFIX}{step:08d}")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


########################################################################################################################
# ArcFace
########################################################################################################################


def build_arcface(cfg: Dict[str, Any], n_classes: int) -> ArcFace:
    emb_model = Backbone(
        num_layers=cfg.get("num_layers", 50), drop_ratio=cfg.get("dropout", 0.6), mode="ir_se",
        img_size=cfg.get("img_size", 32), img_channels=cfg.get("img_channels", 1),
        emb_dim=cfg.get("emb_dim", 512),
    )
    return ArcFace(emb_model=emb_model, embedding_size=cfg.get("emb_dim", 512),
                   n_classes=n_classes, th=cfg.get("th", 1.5))


def make_arcface_train_step(model: ArcFace, optimizer):
    """step(batch {"image": uint8 [B, H, W, C], "label": [B]}, generator) -> metrics."""

    def train_step(batch, generator=None):
        model.train()
        device = _device(model)
        imgs = prepare(None, batch["image"], device)
        labels = torch.as_tensor(batch["label"], device=device).long()
        _, logits = model(imgs, labels, generator)
        loss = F.cross_entropy(logits, labels)
        _adam_step(optimizer, loss)
        acc = (logits.argmax(-1) == labels).float().mean()
        return {"loss": loss.detach(), "acc": acc}

    return train_step


def train_arcface(cfg: Dict[str, Any], ds, progress: bool = True, device="cuda"):
    """cfg keys: outdir, num_layers, dropout, img_size, img_channels, emb_dim,
    th, lr, batch_size, n_epochs, save_every, seed.  Returns (model, metrics
    of the last step as floats)."""
    os.makedirs(cfg["outdir"], exist_ok=True)
    save_args(cfg, cfg["outdir"])
    seed = cfg.get("seed", 1)
    model = build_arcface(cfg, ds.n_classes)
    init_module(model, torch.Generator().manual_seed(seed))
    model.to(device)
    optimizer = torch.optim.Adam(model.parameters(), lr=cfg["lr"])
    train_step = make_arcface_train_step(model, optimizer)
    dropout_gen = torch.Generator(device=device).manual_seed(seed)

    n = len(ds)
    bs = cfg["batch_size"]
    order_rng = np.random.default_rng(seed)
    step = 0
    metrics = {}
    for _ in _epochs(cfg["n_epochs"], "ArcFace epochs", progress):
        order = order_rng.permutation(n)
        for start in range(0, n - bs + 1, bs):
            imgs, labels = zip(*(ds[int(i)] for i in order[start: start + bs]))
            batch = {"image": np.stack(imgs), "label": np.asarray(labels, np.int64)}
            metrics = train_step(batch, dropout_gen)
            step += 1
            if step % cfg.get("save_every", 1000) == 0:
                save_checkpoint(cfg["outdir"], step, {"arcface": model.state_dict()})
    save_checkpoint(cfg["outdir"], step, {"arcface": model.state_dict()})
    return model, {k: float(v) for k, v in metrics.items()}


########################################################################################################################
# Siamese
########################################################################################################################


def build_siamese(img_channels: int, img_size: int) -> SiameseNet:
    encoder = ProtonetEmbeddingNet(img_channels, img_size)
    return SiameseNet(embedding_net=encoder, embedding_dim=encoder.embedding_dim)


def make_siamese_train_step(model: SiameseNet, optimizer):
    """Random-pair step: step(x1, x2 uint8 [P, H, W, C], targets [P]) -> metrics."""

    def train_step(x1, x2, targets):
        model.train()
        device = _device(model)
        logits = model(prepare(None, x1, device), prepare(None, x2, device)).squeeze(-1)
        t = torch.as_tensor(targets, device=device, dtype=torch.float32)
        loss = (torch.clamp(logits, min=0.0) - logits * t
                + torch.log1p(torch.exp(-logits.abs()))).mean()
        _adam_step(optimizer, loss)
        acc = ((logits >= 0) == (t > 0.5)).float().mean()
        return {"loss": loss.detach(), "acc": acc}

    return train_step


def make_siamese_batchhard_step(model: SiameseNet, optimizer):
    """Batch-hard mined verification step (the default recipe).

    Embed the whole episode pool once, score every pair with the model's own
    ``classify(|e1-e2|)`` head, and train each anchor against its hardest
    positive (lowest same-source logit inside its episode, not itself) and
    hardest negative (highest logit across episodes): one encoder pass and
    one [N, N] pair-logit matrix, N = batch_size * (m+n+k).
    """

    def train_step(pool):
        b, s = pool.shape[:2]
        if b < 2:
            # one episode leaves no cross-episode negative: argmax over -inf
            # would pick a same-episode pair and train it as a negative
            raise ValueError("batch-hard mining needs batch_size >= 2 episodes per step")
        model.train()
        device = _device(model)
        n = b * s
        imgs = prepare(None, pool, device).reshape(n, *pool.shape[2:])
        episode = torch.arange(b, device=device).repeat_interleave(s)
        same = episode[:, None] == episode[None, :]
        eye = torch.eye(n, dtype=torch.bool, device=device)
        emb = model.encode(imgs)
        logits = model.classify(emb[:, None, :], emb[None, :, :])[..., 0].float()  # [N, N]
        sel = logits.detach()
        pos_idx = torch.where(same & ~eye, sel, torch.full_like(sel, 1e30)).argmin(dim=1)
        neg_idx = torch.where(~same, sel, torch.full_like(sel, -1e30)).argmax(dim=1)
        rows = torch.arange(n, device=device)
        pos_logit, neg_logit = logits[rows, pos_idx], logits[rows, neg_idx]
        loss = 0.5 * (bce_with_logits(pos_logit[:, None], 1.0)
                      + bce_with_logits(neg_logit[:, None], 0.0)).mean()
        _adam_step(optimizer, loss)
        acc = 0.5 * ((pos_logit >= 0).float().mean() + (neg_logit < 0).float().mean())
        return {"loss": loss.detach(), "acc": acc.detach()}

    return train_step


def _siamese_pairs(batch, rng: np.random.Generator, pairs_per_episode: int = 2):
    """Same/different-source pairs for the verification loss.

    Positives come from the whole episode pool (real + si + leaked images of
    one source: the eval compares test with registration images);
    negatives pair pool images across episodes.  ``pairs_per_episode``
    positive and negative pairs per episode.
    """
    pool = np.concatenate(
        [batch["real_sample"], batch["si_sample"], batch["leaked_sample"]], axis=1
    )  # [B, n+k+m, H, W, C] uint8
    b, n = pool.shape[:2]
    x1, x2, y = [], [], []
    for i in range(b):
        for _ in range(pairs_per_episode):
            a, c = rng.choice(n, 2, replace=False)
            x1.append(pool[i, a]); x2.append(pool[i, c]); y.append(1.0)
            j = (i + 1 + int(rng.integers(b - 1))) % b
            x1.append(pool[i, a]); x2.append(pool[j, int(rng.integers(n))]); y.append(0.0)
    return np.stack(x1), np.stack(x2), np.asarray(y, np.float32)


def train_siamese(cfg: Dict[str, Any], ds, progress: bool = True, device="cuda"):
    """cfg keys: outdir, img_size, img_channels, lr, batch_size, n_epochs,
    save_every, seed, and optionally mining ("batch_hard" | "random") and
    num_workers.  Returns (model, metrics of the last step as floats)."""
    os.makedirs(cfg["outdir"], exist_ok=True)
    save_args(cfg, cfg["outdir"])
    seed = cfg.get("seed", 1)
    model = build_siamese(cfg["img_channels"], cfg["img_size"])
    init_module(model, torch.Generator().manual_seed(seed))
    model.to(device)
    optimizer = torch.optim.Adam(model.parameters(), lr=cfg["lr"])
    mining = cfg.get("mining", "batch_hard")
    if mining == "batch_hard":
        train_step = make_siamese_batchhard_step(model, optimizer)
    elif mining == "random":
        train_step = make_siamese_train_step(model, optimizer)
    else:
        raise ValueError(f"unknown mining mode {mining!r}")

    loader = EpisodicBatchLoader(ds, batch_size=cfg["batch_size"], shuffle=True,
                                 num_workers=cfg.get("num_workers", 0), seed=seed)
    pair_rng = np.random.default_rng(seed)
    step = 0
    metrics = {}
    for ep in _epochs(cfg["n_epochs"], "Siamese epochs", progress):
        loader.set_epoch(ep)
        for batch in loader:
            if mining == "batch_hard":
                metrics = train_step(np.concatenate(
                    [batch["real_sample"], batch["si_sample"], batch["leaked_sample"]], axis=1))
            else:
                metrics = train_step(*_siamese_pairs(batch, pair_rng))
            step += 1
            if step % cfg.get("save_every", 1000) == 0:
                save_checkpoint(cfg["outdir"], step, {"model": model.state_dict()})
    save_checkpoint(cfg["outdir"], step, {"model": model.state_dict()})
    return model, {k: float(v) for k, v in metrics.items()}
