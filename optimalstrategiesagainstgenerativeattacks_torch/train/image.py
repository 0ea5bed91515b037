"""Image GIM game: the alternating train step and a loop around it.

Counterpart of ``optimalstrategiesagainstgenerativeattacks_tpu/train/image.py``
(``make_train_step_fn`` / ``make_split_train_step``, identical math):

  1. Impersonator phase, run when (step + 1) % n_au_steps == 0: one power
     iteration of the impersonator's spectral state, generate the fake, score
     it with the authenticator at its current weights and *old* spectral
     state, BCE toward 1, one Adam step.  The gradient is taken with
     ``torch.autograd.grad`` over the impersonator's parameters only, so the
     frozen authenticator's ``.grad`` stays untouched.  On the other steps
     the fake is generated without a gradient from the unchanged state.
  2. Authenticator phase: one power iteration of its spectral state, one
     pass of both encoders over [si; real; fake.detach()], two head calls,
     BCE with real -> 1 and fake -> 0, one Adam step.

Batches are uint8 ``[B, S, H, W, C]`` arrays normalised on the device as
x / 127.5 - 1, then cast to the compute dtype.  The authenticator phase runs
the whole batch at once: the reference's ``au_microbatch`` is a memory policy
for a 16 GB TPU and is not carried.  ``reg_param > 0`` (the R1 penalty) is
not ported yet.
"""

from __future__ import annotations

import itertools
from typing import Iterable, Optional

import torch

from optimalstrategiesagainstgenerativeattacks_torch.models import image as imodels
from optimalstrategiesagainstgenerativeattacks_torch.nn.init import init_module
from optimalstrategiesagainstgenerativeattacks_torch.ops.spectral import power_iterate
from optimalstrategiesagainstgenerativeattacks_torch.train.losses import (
    bce_with_logits,
    gan_accuracy,
)
from optimalstrategiesagainstgenerativeattacks_torch.train.state import GameState
from optimalstrategiesagainstgenerativeattacks_torch.utils.config import ImageGameConfig

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
    "im_trained",
)


def compute_dtype(cfg: ImageGameConfig) -> Optional[torch.dtype]:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None


def build_models(cfg: ImageGameConfig):
    """(au, im) for a config, on the CPU, parameters not yet initialised."""
    if cfg.use_img_att:
        raise NotImplementedError("use_img_att (ImgAttention) is not ported yet")
    dtype = compute_dtype(cfg)
    au = imodels.get_au(cfg.img_size, cfg.img_channels, cfg.style_dim, dtype=dtype)
    im = imodels.get_im(cfg.img_size, cfg.img_channels, cfg.style_dim,
                        num_env_noise_layers=cfg.num_env_noise_layers, dtype=dtype)
    return au, im


def make_optimizers(cfg: ImageGameConfig, au, im):
    """Adam(beta1, beta2, eps=1e-8) per player; the env-noise mapper has its own LR.

    Learning rates follow MultiStepLR stepped once per optimizer step, which
    matches the reference's optax piecewise-constant schedule on the Adam
    step count.
    """
    betas = (cfg.beta1, cfg.beta2)
    opt_au = torch.optim.Adam(au.parameters(), lr=cfg.au_lr, betas=betas, eps=1e-8)
    noise_params = list(im.env_noise_mapper.parameters())
    noise_ids = {id(p) for p in noise_params}
    main_params = [p for p in im.parameters() if id(p) not in noise_ids]
    opt_im = torch.optim.Adam(
        [{"params": main_params, "lr": cfg.im_lr},
         {"params": noise_params, "lr": cfg.env_noise_mapping_lr}],
        betas=betas, eps=1e-8,
    )
    sched_au = torch.optim.lr_scheduler.MultiStepLR(opt_au, list(cfg.milestones), cfg.lr_gamma)
    sched_im = torch.optim.lr_scheduler.MultiStepLR(opt_im, list(cfg.milestones), cfg.lr_gamma)
    return opt_au, opt_im, sched_au, sched_im


def create_state(cfg: ImageGameConfig, au, im, seed: int, device) -> GameState:
    """Initialise both players from ``seed`` (on the CPU), move them to ``device``,
    and build the optimizers and the noise generator."""
    gen = torch.Generator().manual_seed(seed)
    init_module(au, gen)
    init_module(im, gen)
    au.to(device)
    im.to(device)
    opt_au, opt_im, sched_au, sched_im = make_optimizers(cfg, au, im)
    noise_gen = torch.Generator(device=device).manual_seed(seed)
    return GameState(cfg, au, im, opt_au, opt_im, sched_au, sched_im, noise_gen)


def prepare_batch(cfg: ImageGameConfig, batch, device):
    """uint8 (real, leaked, si) -> [-1, 1] images in the compute dtype on ``device``."""
    dt = compute_dtype(cfg) or torch.float32

    def prep(x):
        x = torch.as_tensor(x, device=device)
        return (x.float() / 127.5 - 1.0).to(dt)

    return tuple(prep(batch[k]) for k in ("real_sample", "leaked_sample", "si_sample"))


def au_outputs(au, real, fake, si):
    """One pass of each encoder over [si; real; fake], then two head calls -> (out_real, out_fake)."""
    b, n, k = real.shape[0], real.shape[1], si.shape[1]
    img = real.shape[2:]
    flat = torch.cat([si.reshape(b * k, *img), real.reshape(b * n, *img),
                      fake.reshape(b * n, *img)])
    src, env = au.encode_flat(flat)

    def split(x):
        return (x[: b * k].reshape(b, k, -1), x[b * k: b * (k + n)].reshape(b, n, -1),
                x[b * (k + n):].reshape(b, n, -1))

    si_src, real_src, fake_src = split(src)
    si_env, real_env, fake_env = split(env)
    return (au.discriminate(real_src, real_env, si_src, si_env),
            au.discriminate(fake_src, fake_env, si_src, si_env))


def train_step(state: GameState, batch, z: Optional[torch.Tensor] = None):
    """One game step, updating ``state`` in place.

    ``z`` [B, n, style] replaces the impersonator's noise draw (tests inject
    it); otherwise it comes from ``state.generator``.  Returns (metrics, fake)
    with the metrics as 0-dim f32 tensors on the device (no host sync).
    """
    cfg = state.cfg
    if cfg.reg_param > 0:
        raise NotImplementedError("reg_param > 0 (R1 penalty) is not ported yet")
    au, im = state.au, state.im
    step = state.step + 1
    real, leaked, si = prepare_batch(cfg, batch, state.device)

    def im_loss():
        fake = im(leaked, cfg.n, cfg.remove_noise_mean, z=z, generator=state.generator)
        return bce_with_logits(au(fake, si), 1.0).mean(), fake

    # ---- impersonator
    if (step + 1) % cfg.n_au_steps == 0:
        power_iterate(im)
        im_loss_value, fake = im_loss()
        params = list(im.parameters())
        for p, g in zip(params, torch.autograd.grad(im_loss_value, params)):
            p.grad = g
        state.opt_im.step()
        state.sched_im.step()
        state.opt_im.zero_grad(set_to_none=True)
        im_trained = 1.0
    else:
        with torch.no_grad():
            im_loss_value, fake = im_loss()
        im_trained = 0.0
    fake = fake.detach()

    # ---- authenticator on the detached fake
    power_iterate(au)
    out_real, out_fake = au_outputs(au, real, fake, si)
    loss_on_real = bce_with_logits(out_real, 1.0)
    loss_on_fake = bce_with_logits(out_fake, 0.0)
    reg = torch.zeros_like(loss_on_real)
    au_loss = (loss_on_real + loss_on_fake + reg).mean()
    state.opt_au.zero_grad(set_to_none=True)
    au_loss.backward()
    state.opt_au.step()
    state.sched_au.step()

    state.step = step
    with torch.no_grad():
        acc, acc_on_real, acc_on_fake = gan_accuracy(out_real, out_fake)
        metrics = {
            "im_loss": im_loss_value.detach(),
            "au_loss": au_loss.detach(),
            "au_loss_on_real": loss_on_real.mean(),
            "au_loss_on_fake": loss_on_fake.mean(),
            "au_reg": reg.mean(),
            "au_out_on_real": out_real.float().mean(),
            "au_out_on_fake": out_fake.float().mean(),
            "au_acc": acc,
            "au_acc_on_real": acc_on_real,
            "au_acc_on_fake": acc_on_fake,
            # a fill on the device: copying a host scalar would synchronise
            "im_trained": torch.full((), im_trained, device=real.device),
        }
    return metrics, fake


def train_gim_imgs_steps(cfg: ImageGameConfig, batches: Iterable, n_steps: int,
                         state: Optional[GameState] = None, device="cuda"):
    """Run ``n_steps`` train steps over ``batches``; builds the state from
    ``cfg.seed`` on ``device`` when none is given.  Returns (state, history)
    with one dict of Python floats per step."""
    if state is None:
        au, im = build_models(cfg)
        state = create_state(cfg, au, im, cfg.seed, device)
    history = []
    for batch in itertools.islice(batches, n_steps):
        metrics, _ = train_step(state, batch)
        history.append(metrics)
    if len(history) != n_steps:
        raise ValueError(f"batches ran out after {len(history)} of {n_steps} steps")
    history = [{k: float(v) for k, v in m.items()} for m in history]
    return state, history
