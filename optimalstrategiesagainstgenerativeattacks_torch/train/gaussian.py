"""Gaussian GIM game: the alternating train step, chunks of steps and the loop.

Counterpart of ``optimalstrategiesagainstgenerativeattacks_tpu/train/gaussian.py``
(identical math):

  * ``synth_batch`` draws each batch on the device from the state's
    generator: mu ~ N(0, prior^2 I), then real, leaked and si ~ N(mu, src^2 I);
  * ``train_step`` takes one impersonator step against the frozen
    authenticator (BCE toward 1), then one authenticator step on the
    detached fake (real -> 1, fake -> 0), plus, when ``reg_param > 0``, the R1
    penalty reg_param * (|d out_real / d real|^2 + |d out_real / d si|^2) per
    episode, sharing the loss's forward (``create_graph=True``);
  * ``train_chunk`` runs ``n_steps`` steps with no host synchronisation and
    returns their metrics stacked on the device, so the host reads them once
    per chunk (the JAX package's ``make_train_fn``, a ``lax.scan``);
  * ``train_gim_gaussian`` is the loop: every-step scalars, the distance
    statistics every ``save_stats_every`` steps, step-keyed checkpoints,
    ``pretrained``, resume, and a save on KeyboardInterrupt.

Data parallel (``parallel/mesh.py``, the JAX step's ``mesh`` argument): in a
process group every rank draws the global batch and noise from the shared
generator and keeps its slice, the gradients are averaged over the ranks
before each Adam step and the metrics are means over the ranks, so k ranks
take the step one process takes; ``cfg.batch_size`` is the global batch and
the world size must divide it.  Rank 0 alone writes logs and checkpoints.

Both players use Adam at torch's defaults (betas 0.9 / 0.999, eps 1e-8),
which are optax ``adam``'s.  The models have no spectral norm and the game no
hand-written kernel: a step is two small MLPs.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from optimalstrategiesagainstgenerativeattacks_torch.models import gaussian as gmodels
from optimalstrategiesagainstgenerativeattacks_torch.nn.init import init_module
from optimalstrategiesagainstgenerativeattacks_torch.ops.precision import exact_f32
from optimalstrategiesagainstgenerativeattacks_torch.ops.stats import custom_std
from optimalstrategiesagainstgenerativeattacks_torch.parallel import mesh
from optimalstrategiesagainstgenerativeattacks_torch.train.checkpoints import (
    CheckpointIO,
    resolve_ckpt_path,
)
from optimalstrategiesagainstgenerativeattacks_torch.train.losses import (
    bce_with_logits,
    gan_accuracy,
)
from optimalstrategiesagainstgenerativeattacks_torch.train.state import GaussianState, adam_step
from optimalstrategiesagainstgenerativeattacks_torch.utils.config import GaussianGameConfig

METRIC_KEYS = (
    "im_loss",
    "au_loss",
    "au_loss_on_real",
    "au_loss_on_fake",
    "au_reg",
    "au_out_on_real",
    "au_out_on_fake",
    "au_acc",
    "au_acc_on_real",
    "au_acc_on_fake",
    "im_l1_dist_from_leaked_sample_mean",
    "im_l1_dist_from_gt_sample_mean",
    "im_l1_dist_from_gt_std",
    "real_l1_dist_from_gt_sample_mean",
    "real_l1_dist_from_gt_std",
)
# (category, tag, metric) of the scalars logged every step, and every save_stats_every steps
STEP_SCALARS = (
    *(("train_losses", k, k) for k in ("im_loss", "au_loss", "au_loss_on_real",
                                       "au_loss_on_fake", "au_reg")),
    *(("train_au_out", k, k) for k in ("au_out_on_real", "au_out_on_fake")),
    *(("train_accuracy", k, k) for k in ("au_acc", "au_acc_on_real", "au_acc_on_fake")),
)
STATS_SCALARS = tuple(
    (f"{who}_distances", f"l1_dist_from_{what}", f"{who}_l1_dist_from_{what}")
    for who, what in (("im", "leaked_sample_mean"), ("im", "gt_sample_mean"), ("im", "gt_std"),
                      ("real", "gt_sample_mean"), ("real", "gt_std"))
)


def build_models(cfg: GaussianGameConfig):
    """(au, im) for a config, on the CPU, parameters not yet initialised."""
    au = gmodels.get_au(cfg.src_dim, stat_type=cfg.au_stat, hidden_scale=cfg.au_hidden_scale)
    return au, gmodels.get_im(cfg.src_dim)


def create_state(cfg: GaussianGameConfig, device) -> GaussianState:
    """Both players initialised from ``cfg.seed`` on the CPU, moved to ``device``,
    their Adams, and the device generator of batches and noise seeded ``cfg.seed``."""
    au, im = build_models(cfg)
    gen = torch.Generator().manual_seed(cfg.seed)
    init_module(au, gen)
    init_module(im, gen)
    au.to(device)
    im.to(device)
    return GaussianState(cfg, au, im, torch.optim.Adam(au.parameters(), lr=cfg.au_lr),
                         torch.optim.Adam(im.parameters(), lr=cfg.im_lr),
                         torch.Generator(device=device).manual_seed(cfg.seed))


def synth_batch(cfg: GaussianGameConfig, generator: torch.Generator,
                device) -> Dict[str, torch.Tensor]:
    """mu ~ N(0, prior^2 I) [B, d]; real [B, n, d], leaked [B, m, d], si [B, k, d]
    ~ N(mu, src^2 I); sigma = src [B, d].  In a process group, this rank's slice
    of the global batch's draws (B = cfg.batch_size / world)."""
    lo, hi = mesh.shard_bounds(cfg.batch_size)  # the world size must divide the batch
    b, d = hi - lo, cfg.src_dim
    mu = cfg.prior_sigma * mesh.randn_slice((b, d), generator, device)

    def draw(s):
        return mu[:, None, :] + cfg.src_sigma * mesh.randn_slice((b, s, d), generator, device)

    return {"mu": mu, "sigma": torch.full((b, d), cfg.src_sigma, device=device),
            "real_sample": draw(cfg.n), "leaked_sample": draw(cfg.m), "si_sample": draw(cfg.k)}


def train_step(state: GaussianState, batch: Optional[dict] = None,
               z: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One game step, updating ``state`` in place.

    ``batch`` (``synth_batch``'s keys) and ``z`` [B, n, d] replace the draws
    from the state's generator (tests inject both; in a process group, this
    rank's slices).  Returns the metrics as 0-dim f32 tensors on the device
    (no host sync), means over the ranks in a process group.
    """
    cfg = state.cfg
    au, im = state.au, state.im
    if batch is None:
        batch = synth_batch(cfg, state.generator, state.device)
    real, leaked, si = batch["real_sample"], batch["leaked_sample"], batch["si_sample"]
    if z is None:
        z = mesh.randn_slice((leaked.shape[0], cfg.n, cfg.src_dim), state.generator,
                             state.device, leaked.dtype)

    # ---- impersonator step, the authenticator frozen
    fake = im(leaked, cfg.n, cfg.remove_noise_mean, z=z)
    im_loss = bce_with_logits(au(fake, si), 1.0).mean()
    adam_step(im, state.opt_im, im_loss)
    fake = fake.detach()

    # ---- authenticator step on the detached fake
    r1 = cfg.reg_param > 0
    if r1:
        real = real.detach().requires_grad_(True)
        si = si.detach().requires_grad_(True)
    out_real = au(real, si)
    loss_on_real = bce_with_logits(out_real, 1.0)
    if r1:
        g_real, g_si = torch.autograd.grad(out_real.sum(), (real, si), create_graph=True)
        b = real.shape[0]
        reg = cfg.reg_param * (g_real.float().square().reshape(b, -1).sum(1)
                               + g_si.float().square().reshape(b, -1).sum(1))
    else:
        reg = torch.zeros_like(loss_on_real)
    out_fake = au(fake, si)
    loss_on_fake = bce_with_logits(out_fake, 0.0)
    au_loss = (loss_on_real + loss_on_fake + reg).mean()
    adam_step(au, state.opt_au, au_loss)
    state.step += 1

    with torch.no_grad():
        acc, acc_on_real, acc_on_fake = gan_accuracy(out_real, out_fake)
        mu, sigma = batch["mu"], batch["sigma"]

        def l1(a, b_):
            return (a - b_).abs().mean()

        return mesh.all_reduce_mean_dict({
            "im_loss": im_loss.detach(),
            "au_loss": au_loss.detach(),
            "au_loss_on_real": loss_on_real.mean(),
            "au_loss_on_fake": loss_on_fake.mean(),
            "au_reg": reg.detach().mean(),
            "au_out_on_real": out_real.mean(),
            "au_out_on_fake": out_fake.mean(),
            "au_acc": acc,
            "au_acc_on_real": acc_on_real,
            "au_acc_on_fake": acc_on_fake,
            "im_l1_dist_from_leaked_sample_mean": l1(fake.mean(1), leaked.mean(1)),
            "im_l1_dist_from_gt_sample_mean": l1(fake.mean(1), mu),
            "im_l1_dist_from_gt_std": l1(custom_std(fake), sigma),
            "real_l1_dist_from_gt_sample_mean": l1(real.mean(1), mu),
            "real_l1_dist_from_gt_std": l1(custom_std(real), sigma),
        })


def train_chunk(state: GaussianState, n_steps: int) -> torch.Tensor:
    """``n_steps`` train steps from the state's generator; returns their metrics as
    one [n_steps, len(METRIC_KEYS)] f32 tensor on the device, columns in
    METRIC_KEYS order.  Nothing inside waits for the device."""
    rows = []
    for _ in range(n_steps):
        m = train_step(state)
        rows.append(torch.stack([m[k] for k in METRIC_KEYS]))
    return torch.stack(rows)


def train_gim_gaussian(cfg: GaussianGameConfig, logger=None, checkpoint_io=None,
                       progress: bool = True, device="cuda") -> GaussianState:
    """Full Gaussian-game training (the reference's ``train_gim_gaussian``).

    Runs the steps ``[start, n_iters)`` in chunks of max(1, min(log_every,
    save_stats_every)) steps (a remainder shorter than a chunk is not run, as
    in the JAX package), logging every step's scalars and, at steps that are
    multiples of ``save_stats_every``, the distance statistics.  A checkpoint
    is written when a chunk crosses a multiple of ``save_every`` (and after
    the first chunk when ``save_every <= chunk``), at the end, and on
    KeyboardInterrupt (then it returns).  In a process group every rank takes
    the steps and rank 0 writes, with a barrier after each save.  Returns the
    state.
    """
    from optimalstrategiesagainstgenerativeattacks_torch.train.logger import Logger

    exact_f32()
    logger = logger or Logger(
        log_dir=os.path.join(cfg.outdir, "logs"),
        img_dir=os.path.join(cfg.outdir, "imgs"),
        tensorboard_dir=os.path.join(cfg.outdir, "tb"),
    )
    checkpoint_io = checkpoint_io or CheckpointIO(os.path.join(cfg.outdir, "ckpts"))
    state = create_state(cfg, device)
    if mesh.is_main():
        print(f"Authenticator has {sum(p.numel() for p in state.au.parameters())} parameters")
        print(f"impersonator has {sum(p.numel() for p in state.im.parameters())} parameters")
    if cfg.pretrained:
        checkpoint_io.load(resolve_ckpt_path(cfg.pretrained, cfg.outdir), state,
                           players_only=True)
    if cfg.resume_from_ckpt:
        gstep, _ = checkpoint_io.load(resolve_ckpt_path(cfg.resume_from_ckpt, cfg.outdir), state)
        if mesh.is_main():
            print(f"Resuming training from iteration {gstep}")

    chunk = max(1, min(cfg.log_every, cfg.save_stats_every))
    start_step = state.step + 1
    n_chunks = max(0, (cfg.n_iters - start_step) // chunk)
    def log_chunk(first_step: int, metrics: torch.Tensor) -> None:
        rows = metrics.cpu().tolist()  # one transfer a chunk
        for i, row in enumerate(rows):
            host = dict(zip(METRIC_KEYS, row))
            gs = first_step + i
            for category, k, key in STEP_SCALARS:
                logger.add_scalar(category, k, host[key], gs)
            if gs % cfg.save_stats_every == 0:
                for category, k, key in STATS_SCALARS:
                    logger.add_scalar(category, k, host[key], gs)

    iterator = range(n_chunks)
    if progress and mesh.is_main():
        try:
            from tqdm import tqdm

            iterator = tqdm(iterator, total=n_chunks, desc="Training (x%d steps)" % chunk)
        except ImportError:
            pass

    try:
        for ci in iterator:
            first_step = start_step + ci * chunk
            log_chunk(first_step, train_chunk(state, chunk))
            gs = first_step + chunk - 1
            if (first_step // cfg.save_every) != ((gs + 1) // cfg.save_every) or (
                    first_step == 0 and cfg.save_every <= chunk):
                checkpoint_io.save(state, state.step)
                mesh.barrier()
    except KeyboardInterrupt:
        print("\nKeyboardInterrupt\nSaving checkpoint...\n")
        checkpoint_io.save(state, state.step)
        return state
    checkpoint_io.save(state, state.step)
    mesh.barrier()
    return state
