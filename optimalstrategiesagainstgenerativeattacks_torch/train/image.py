"""Image GIM game: the alternating train step, eval, sampling and the loop.

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
     BCE with real -> 1 and fake -> 0, plus, when ``reg_param > 0``, the R1
     penalty reg_param * (|d out_real / d real|^2 + |d out_real / d si|^2)
     per episode; one Adam step.  R1 shares the loss's forward, as the
     reference's ``jax.vjp`` does: its input gradient is taken with
     ``create_graph=True`` on the same graph, and the parameter gradient of
     the loss then runs a double backward through the encoders (the
     attention core's backward included).

Batches are uint8 ``[B, S, H, W, C]`` arrays normalised on the device as
x / 127.5 - 1, then cast to the compute dtype.  The authenticator phase runs
the whole batch at once: the reference's ``au_microbatch`` is a memory policy
for a 16 GB TPU and is not carried.

``train_gim_imgs`` is the reference's loop (its ``train_gim_imgs:357-447``,
as the JAX package's ``train_gim_imgs`` ports it): epochs over the loader
that ``cfg.device_data`` picks (``train_loader``: the dataset resident on the
device, or the host loader behind a prefetch thread), the same scalar tags
and cadences, checkpoints, image grids, eval over the val set, and a save on
KeyboardInterrupt or PermissionError.  Per-step metrics stay on the device in a [log_every, K]
buffer that reaches the host in one transfer per flush.

Data parallel (``parallel/mesh.py``, the JAX step's ``mesh`` argument): in a
process group each rank takes its shard of every batch and its slice of the
global noise draw, the gradients are averaged over the ranks before each Adam
step, and the metrics, diagnostics and eval sums are means over the ranks, so
k ranks take the step one process takes on the global batch.  With a model
axis (``create_mesh(model_parallel)``, then ``parallel/tensor.py``'s
``shard_state_``) the shards and slices are the data index's, so a model
group's ranks take the same rows and noise; the sharded layers gather their
outputs, the rest of the step runs whole on each of them, and the means are
over the data axis: the step is the one ``make_train_step(..., mesh)`` takes
on the JAX package's ``param_shardings``.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import Iterable, Optional

import numpy as np
import torch

from optimalstrategiesagainstgenerativeattacks_torch.data.device_sampler import DeviceEpisodicLoader
from optimalstrategiesagainstgenerativeattacks_torch.data.episodic import EpisodicBatchLoader
from optimalstrategiesagainstgenerativeattacks_torch.data.prefetch import device_prefetch
from optimalstrategiesagainstgenerativeattacks_torch.models import image as imodels
from optimalstrategiesagainstgenerativeattacks_torch.nn.init import init_module
from optimalstrategiesagainstgenerativeattacks_torch.ops.precision import widen
from optimalstrategiesagainstgenerativeattacks_torch.ops.spectral import power_iterate
from optimalstrategiesagainstgenerativeattacks_torch.ops.stats import custom_std
from optimalstrategiesagainstgenerativeattacks_torch.parallel import mesh
from optimalstrategiesagainstgenerativeattacks_torch.train.checkpoints import (
    CheckpointIO,
    resolve_ckpt_path,
)
from optimalstrategiesagainstgenerativeattacks_torch.train.logger import Logger
from optimalstrategiesagainstgenerativeattacks_torch.train.losses import (
    bce_with_logits,
    gan_accuracy,
)
from optimalstrategiesagainstgenerativeattacks_torch.train.state import GameState, adam_step
from optimalstrategiesagainstgenerativeattacks_torch.utils.config import ImageGameConfig
from optimalstrategiesagainstgenerativeattacks_torch.utils.rng import noise_generator

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
EVAL_KEYS = tuple(k for k in METRIC_KEYS if k not in ("au_reg", "im_trained"))
DIAG_KEYS = tuple(
    f"au_{enc}_{what}"
    for enc in ("src", "env")
    for what in ("mean_abs_real_minus_si", "mean_abs_fake_minus_si",
                 "std_real", "std_si", "std_fake")
)


def compute_dtype(cfg: ImageGameConfig) -> Optional[torch.dtype]:
    """bf16 for "bfloat16", None (f32, no casts) for "float32"."""
    if cfg.compute_dtype not in ("bfloat16", "float32"):
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: bfloat16 or float32")
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None


def build_models(cfg: ImageGameConfig):
    """(au, im) for a config, on the CPU, parameters not yet initialised."""
    dtype = compute_dtype(cfg)
    au = imodels.get_au(cfg.img_size, cfg.img_channels, cfg.style_dim, dtype=dtype)
    im = imodels.get_im(cfg.img_size, cfg.img_channels, cfg.style_dim,
                        use_img_att=cfg.use_img_att,
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


def prepare(cfg: Optional[ImageGameConfig], x, device) -> torch.Tensor:
    """uint8 images -> [-1, 1] in the compute dtype on ``device`` (f32 without a cfg)."""
    x = torch.as_tensor(x, device=device)
    return (x.float() / 127.5 - 1.0).to((cfg and compute_dtype(cfg)) or torch.float32)


def prepare_batch(cfg: ImageGameConfig, batch, device):
    """uint8 (real, leaked, si) -> [-1, 1] images in the compute dtype on ``device``."""
    return tuple(prepare(cfg, batch[k], device)
                 for k in ("real_sample", "leaked_sample", "si_sample"))


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


def r1_penalty(cfg: ImageGameConfig, out_real, real, si):
    """reg_param * per-episode squared norm of d sum(out_real) / d (real, si), in f32,
    kept differentiable (``create_graph``) for the parameter gradient."""
    g_real, g_si = torch.autograd.grad(out_real.sum(), (real, si), create_graph=True)
    b = real.shape[0]
    return cfg.reg_param * (widen(g_real).square().reshape(b, -1).sum(1)
                            + widen(g_si).square().reshape(b, -1).sum(1))


def noise(cfg: ImageGameConfig, b: int, generator: Optional[torch.Generator], device):
    """The impersonator's noise z [b, n, style] for ``b`` episodes: this rank's
    slice of the global batch's draw (``mesh.randn_slice``), the model's own
    draw without a process group."""
    return mesh.randn_slice((b, cfg.n, cfg.style_dim), generator, device,
                            compute_dtype(cfg) or torch.float32)


def train_step(state: GameState, batch, z: Optional[torch.Tensor] = None):
    """One game step, updating ``state`` in place.

    ``batch`` is this rank's shard of the global batch.  ``z`` [B, n, style]
    (this rank's rows) replaces the impersonator's noise draw (tests inject
    it); otherwise it comes from ``state.generator`` (``noise``).  In a process
    group the gradients and the metrics are means over the ranks.  Returns
    (metrics, fake) with the metrics as 0-dim f32 tensors on the device (no
    host sync) and this rank's fake.
    """
    cfg = state.cfg
    au, im = state.au, state.im
    step = state.step + 1
    real, leaked, si = prepare_batch(cfg, batch, state.device)
    if z is None:
        z = noise(cfg, real.shape[0], state.generator, state.device)

    def im_loss():
        fake = im(leaked, cfg.n, cfg.remove_noise_mean, z=z)
        return bce_with_logits(au(fake, si), 1.0).mean(), fake

    # ---- impersonator
    if (step + 1) % cfg.n_au_steps == 0:
        power_iterate(im)
        im_loss_value, fake = im_loss()
        adam_step(im, state.opt_im, im_loss_value)
        state.sched_im.step()
        im_trained = 1.0
    else:
        with torch.no_grad():
            im_loss_value, fake = im_loss()
        im_trained = 0.0
    fake = fake.detach()

    # ---- authenticator on the detached fake
    power_iterate(au)
    r1 = cfg.reg_param > 0
    if r1:
        real.requires_grad_(True)
        si.requires_grad_(True)
    out_real, out_fake = au_outputs(au, real, fake, si)
    loss_on_real = bce_with_logits(out_real, 1.0)
    loss_on_fake = bce_with_logits(out_fake, 0.0)
    reg = r1_penalty(cfg, out_real, real, si) if r1 else torch.zeros_like(loss_on_real)
    au_loss = (loss_on_real + loss_on_fake + reg).mean()
    adam_step(au, state.opt_au, au_loss)
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
    return mesh.all_reduce_mean_dict(metrics), fake


@torch.no_grad()
def sample(state: GameState, leaked, generator: Optional[torch.Generator] = None,
           z: Optional[torch.Tensor] = None):
    """The impersonator's fake for uint8 leaked images [B, m, H, W, C] (no gradient,
    no change to the state): [B, n, H, W, C] in the compute dtype.  ``z``
    [B, n, style] replaces the noise draw from ``generator``."""
    cfg = state.cfg
    return state.im(prepare(cfg, leaked, state.device), cfg.n, cfg.remove_noise_mean,
                    z=z, generator=generator)


@torch.no_grad()
def eval_step(state: GameState, batch, generator: Optional[torch.Generator] = None,
              z: Optional[torch.Tensor] = None):
    """Both players' losses and accuracies on a batch, without any update
    (the reference's ``make_eval_step``): 0-dim f32 tensors on the device.
    ``z`` [B, n, style] replaces the noise draw from ``generator``.  In a
    process group ``batch`` is this rank's shard, the noise its slice of the
    global draw, and the metrics this rank's (``run_eval`` averages them)."""
    cfg = state.cfg
    real, leaked, si = prepare_batch(cfg, batch, state.device)
    if z is None:
        z = noise(cfg, real.shape[0], generator, state.device)
    fake = state.im(leaked, cfg.n, cfg.remove_noise_mean, z=z)
    im_loss = bce_with_logits(state.au(fake, si), 1.0).mean()
    out_real, out_fake = au_outputs(state.au, real, fake, si)
    loss_on_real = bce_with_logits(out_real, 1.0)
    loss_on_fake = bce_with_logits(out_fake, 0.0)
    acc, acc_on_real, acc_on_fake = gan_accuracy(out_real, out_fake)
    return {
        "im_loss": im_loss,
        "au_loss": (loss_on_real + loss_on_fake).mean(),
        "au_loss_on_real": loss_on_real.mean(),
        "au_loss_on_fake": loss_on_fake.mean(),
        "au_out_on_real": out_real.float().mean(),
        "au_out_on_fake": out_fake.float().mean(),
        "au_acc": acc,
        "au_acc_on_real": acc_on_real,
        "au_acc_on_fake": acc_on_fake,
    }


@torch.no_grad()
def diag(state: GameState, batch, fake):
    """Encoder-statistic diagnostics of the authenticator (the reference's
    ``make_diag_fn``): how far the real and fake sets' mean features sit from
    the registration set's, and each set's feature std, per encoder.  One
    pass of both encoders over [real; si; fake].  Each is a mean of
    per-episode values, so in a process group the mean of the ranks' shards
    is the global batch's."""
    cfg = state.cfg
    real, _, si = prepare_batch(cfg, batch, state.device)
    b, n, k = real.shape[0], real.shape[1], si.shape[1]
    img = real.shape[2:]
    feats = state.au.encode_flat(torch.cat([real.reshape(b * n, *img), si.reshape(b * k, *img),
                                            fake.reshape(-1, *img).to(real.dtype)]))
    out = {}
    for enc, x in zip(("src", "env"), feats):
        x_real, x_si, x_fake = (x[: b * n].reshape(b, n, -1), x[b * n: b * (n + k)].reshape(b, k, -1),
                                x[b * (n + k):].reshape(b, -1, x.shape[-1]))
        si_mean = x_si.mean(1)
        out[f"au_{enc}_mean_abs_real_minus_si"] = (x_real.mean(1) - si_mean).abs().mean()
        out[f"au_{enc}_mean_abs_fake_minus_si"] = (x_fake.mean(1) - si_mean).abs().mean()
        for name, s in (("real", x_real), ("si", x_si), ("fake", x_fake)):
            out[f"au_{enc}_std_{name}"] = custom_std(s).mean()
    return mesh.all_reduce_mean_dict(out)


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


########################################################################################################################
# Loop
########################################################################################################################


def _to_01(img_sample: np.ndarray) -> np.ndarray:
    """[-1, 1] -> [0, 1] with clamp (the reference's ``save_imgs``)."""
    return (np.clip(np.asarray(img_sample, np.float32), -1, 1) + 1.0) / 2.0


def sample_and_save_imgs(logger, state: GameState, ds, ds_prefix: str, indices, key: int,
                         dbg: bool = False) -> None:
    """Leaked and impersonator (and, with ``dbg``, real and si) grids for chosen
    episodes (the reference's ``gim_img_training.py:34-73``); the j-th episode's
    noise comes from ``noise_generator(device, key, j)``, at every step alike."""
    gs = state.step
    for j, idx in enumerate(indices):
        data = ds[idx]
        fake = sample(state, data["leaked_sample"][None], noise_generator(state.device, key, j))
        cat = f"{ds_prefix} imgs_{idx:04d}"
        logger.add_imgs(_to_01(data["leaked_sample"] / 127.5 - 1.0), cat, "leaked", gs)
        logger.add_imgs(_to_01(fake[0].float().cpu().numpy()), cat, "impersonator", gs)
        if dbg:
            logger.add_imgs(_to_01(data["real_sample"] / 127.5 - 1.0), cat, "real", gs)
            logger.add_imgs(_to_01(data["si_sample"] / 127.5 - 1.0), cat, "si", gs)


def run_eval(state: GameState, ds, logger, batch_size: int, key: int) -> dict:
    """Eval over the val set (the reference's ``gim_img_training.py:98-154``),
    logging the means; the sums reach the host in one transfer.  Batch i's noise
    comes from ``noise_generator(device, key, state.step, i)``.  In a process
    group each rank evaluates its shard of every batch and the sums are
    averaged over the ranks."""
    data = mesh.data_axis()
    loader = EpisodicBatchLoader(ds, batch_size=batch_size, shuffle=False, drop_last=True,
                                 shard=(data.rank, data.size))
    sums, count = None, 0
    for i, batch in enumerate(loader):
        m = eval_step(state, batch, noise_generator(state.device, key, state.step, i))
        vec = torch.stack([m[k] for k in EVAL_KEYS])
        sums = vec if sums is None else sums + vec
        count += 1
    if count == 0:
        return {}
    means = dict(zip(EVAL_KEYS, (mesh.all_reduce_mean(sums) / count).cpu().tolist()))
    gs = state.step
    logger.add_scalar("eval_losses", "dis_loss", means["au_loss"], gs)
    logger.add_scalar("eval_losses", "dis_loss_on_real", means["au_loss_on_real"], gs)
    logger.add_scalar("eval_losses", "dis_loss_on_fake", means["au_loss_on_fake"], gs)
    logger.add_scalar("eval_au_out", "au_out_on_real", means["au_out_on_real"], gs)
    logger.add_scalar("eval_au_out", "au_out_on_fake", means["au_out_on_fake"], gs)
    logger.add_scalar("eval_accuracy", "dis_acc", means["au_acc"], gs)
    logger.add_scalar("eval_accuracy", "dis_acc_on_real", means["au_acc_on_real"], gs)
    logger.add_scalar("eval_accuracy", "dis_acc_on_fake", means["au_acc_on_fake"], gs)
    logger.add_scalar("eval_losses", "gen_loss", means["im_loss"], gs)
    return means


def train_loader(cfg: ImageGameConfig, train_ds, batch_size: int, device):
    """The training loader that ``cfg.device_data`` picks, as the JAX loop picks it.

    "auto" stages the dataset on ``device`` (``DeviceEpisodicLoader``) when it
    has a uniform ``stacked_cache()``; "on" requires that; "off", or no such
    cache, takes the host's ``EpisodicBatchLoader``, whose batches the loop
    copies through ``device_prefetch``.  In a process group the device loader
    is refused ("on" raises, "auto" takes the host loader) and each rank's
    host loader assembles its shard of every global batch of ``batch_size``.
    """
    if cfg.device_data not in ("auto", "on", "off"):
        raise ValueError(f"device_data {cfg.device_data!r}: auto, on or off")
    world = mesh.world_size()
    if cfg.device_data == "on" and world > 1:
        raise ValueError("device_data='on' is single-card only; a data-parallel run shards "
                         "the host loader's batches over the ranks")
    cache = None
    if cfg.device_data != "off" and world == 1 and hasattr(train_ds, "stacked_cache"):
        cache = train_ds.stacked_cache()
    if cache is not None:
        print(f"device-resident dataset: {cache.nbytes / 1e6:.0f} MB uint8 staged to "
              f"{torch.device(device)} ({cache.shape[0]} classes x {cache.shape[1]})")
        return DeviceEpisodicLoader(train_ds, batch_size=batch_size, seed=cfg.seed, device=device)
    if cfg.device_data == "on":
        raise ValueError("device_data='on' but the dataset has no uniform stacked cache "
                         "(unequal images per class?)")
    if mesh.is_main():
        print(f"host loader, prefetch depth {cfg.prefetch_depth}"
              + (f", each of {world} ranks assembling {batch_size // world} of {batch_size}"
                 if world > 1 else ""))
    data = mesh.data_axis()
    return EpisodicBatchLoader(train_ds, batch_size=batch_size, shuffle=True, drop_last=True,
                               num_workers=cfg.num_workers, seed=cfg.seed,
                               shard=(data.rank, data.size))


def train_gim_imgs(cfg: ImageGameConfig, train_ds, val_ds, logger=None, progress: bool = True,
                   device="cuda", cudnn_benchmark: bool = False) -> GameState:
    """Full image-game training (the reference's ``train_gim_imgs:357-447``).

    Epochs ``[last_epoch, n_epochs)`` of ``len(loader)`` steps (50 with
    ``cfg.dbg``) over the loader of ``train_loader``.  After the step that
    makes the state's step ``gs``: scalars flush when gs % log_every == 0,
    encoder diagnostics when gs % log_enc_every == 0, a checkpoint when
    gs % save_every == 0, image grids when gs % save_imgs_every == 0 and an eval over ``val_ds`` when
    gs % eval_every == 0 (so all at gs = 0).  A last checkpoint is written at
    the end, on KeyboardInterrupt (then it returns) and on PermissionError
    (then it goes on with the next epoch).  Sampling and eval draw their
    noise from generators seeded from (seed + 17, episode) and (seed + 17,
    step, batch): they leave the training run's stream as it is, and a resumed
    run samples and evaluates as an uninterrupted one.  ``cudnn_benchmark``: cuDNN
    picks each conv's algorithm by timing it (on the H100 the VoxCeleb step takes
    ~17 % less); the run is then not bit-reproducible.

    In a process group (``parallel/mesh.py``) every rank runs the loop on its
    shard of each batch (``adjust_batch_size`` rounds both batches to a
    multiple of the world size), loads the same checkpoints, and takes the
    same steps; rank 0 alone writes logs, image grids and checkpoints, with a
    barrier after each save.  A PermissionError there is raised after its
    save, since the other ranks cannot skip the rest of the epoch with it.
    Returns the state.
    """
    torch.backends.cudnn.benchmark = cudnn_benchmark
    au, im = build_models(cfg)
    logger = logger or Logger(
        log_dir=os.path.join(cfg.outdir, "logs"),
        img_dir=os.path.join(cfg.outdir, "imgs"),
        tensorboard_dir=os.path.join(cfg.outdir, "tb"),
    )
    checkpoint_io = CheckpointIO(os.path.join(cfg.outdir, cfg.ckpt_dir_name))

    state = create_state(cfg, au, im, cfg.seed, device)
    world = mesh.world_size()
    if mesh.is_main():
        print(f"Authenticator has {sum(p.numel() for p in au.parameters())} parameters")
        print(f"impersonator has {sum(p.numel() for p in im.parameters())} parameters")
    if cfg.pretrained:
        checkpoint_io.load(resolve_ckpt_path(cfg.pretrained, cfg.outdir), state,
                           players_only=True)
    last_epoch = 0
    if cfg.resume_from_ckpt:
        gstep, last_epoch = checkpoint_io.load(
            resolve_ckpt_path(cfg.resume_from_ckpt, cfg.outdir), state)
        if mesh.is_main():
            print(f"Resuming training from iteration {gstep}")

    train_bs = mesh.adjust_batch_size(len(train_ds), cfg.batch_size, world)
    val_bs = mesh.adjust_batch_size(len(val_ds), cfg.batch_size, world)
    train_eval_indices = list(range(0, len(train_ds), max(1, len(train_ds) // 10)))
    val_eval_indices = list(range(0, len(val_ds), max(1, len(val_ds) // 10)))
    loader = train_loader(cfg, train_ds, train_bs, device)
    sample_key = cfg.seed + 17

    log_buf = torch.zeros((max(cfg.log_every, 1), len(METRIC_KEYS)), device=device)
    buf_count = 0
    perf = {"t_last": None, "steps": 0}

    def log_throughput(gs: int):
        now = time.perf_counter()
        if perf["t_last"] is not None and perf["steps"] > 0:
            sps = perf["steps"] / (now - perf["t_last"])
            logger.add_scalar("perf", "train_steps_per_sec", sps, gs)
            logger.add_scalar("perf", "train_images_per_sec",
                              sps * cfg.batch_size * (cfg.m + cfg.n + cfg.k), gs)
        perf["t_last"] = now
        perf["steps"] = 0

    def flush_log(gs: int):
        nonlocal buf_count
        if buf_count == 0:
            return
        arr = log_buf[:buf_count].cpu().numpy()  # one transfer
        host = {k: arr[:, i] for i, k in enumerate(METRIC_KEYS)}
        buf_count = 0
        # the schedulers' LRs, those the next optimizer steps take
        im_lr, noise_lr = state.sched_im.get_last_lr()
        logger.add_scalar("lr", "au", state.sched_au.get_last_lr()[0], gs)
        logger.add_scalar("lr", "im", im_lr, gs)
        logger.add_scalar("lr", "im_lm", noise_lr, gs)

        def mean(k):
            return float(np.mean(host[k]))

        logger.add_scalar("train_losses", "dis_loss", mean("au_loss"), gs)
        logger.add_scalar("train_losses", "dis_loss_on_real", mean("au_loss_on_real"), gs)
        logger.add_scalar("train_losses", "dis_loss_on_fake", mean("au_loss_on_fake"), gs)
        logger.add_scalar("train_losses", "dis_reg", mean("au_reg"), gs)
        logger.add_scalar("train_au_out", "au_out_on_real", mean("au_out_on_real"), gs)
        logger.add_scalar("train_au_out", "au_out_on_fake", mean("au_out_on_fake"), gs)
        logger.add_scalar("train_accuracy", "dis_acc", mean("au_acc"), gs)
        logger.add_scalar("train_accuracy", "dis_acc_on_real", mean("au_acc_on_real"), gs)
        logger.add_scalar("train_accuracy", "dis_acc_on_fake", mean("au_acc_on_fake"), gs)
        # the gen loss only over steps where the impersonator trained
        trained = host["im_trained"] > 0
        if trained.any():
            logger.add_scalar("train_losses", "gen_loss", float(host["im_loss"][trained].mean()), gs)

    def save(gs: int, ep: int):
        checkpoint_io.save(state, gs, last_epoch=ep)
        mesh.barrier()

    def log_diag(batch, fake, gs: int):
        d = diag(state, batch, fake)
        vals = dict(zip(DIAG_KEYS, torch.stack([d[k] for k in DIAG_KEYS]).cpu().tolist()))
        for enc in ("src", "env"):
            logger.add_scalar(f"train-au_{enc}_mean", "abs[real-si]",
                              vals[f"au_{enc}_mean_abs_real_minus_si"], gs)
            logger.add_scalar(f"train-au_{enc}_mean", "abs[fake-si]",
                              vals[f"au_{enc}_mean_abs_fake_minus_si"], gs)
        for enc in ("src", "env"):
            for name in ("real", "si", "fake"):
                logger.add_scalar(f"train-au_{enc}_std", name, vals[f"au_{enc}_std_{name}"], gs)

    def run_epoch(ep):
        nonlocal buf_count
        loader.set_epoch(ep)
        num_iters = 50 if cfg.dbg else len(loader)
        if isinstance(loader, DeviceEpisodicLoader):
            batches = iter(loader)  # already on the device
        else:
            batches = device_prefetch(iter(loader), device, depth=cfg.prefetch_depth)
        # closing stops the prefetch thread when the epoch ends early (dbg, an error)
        with contextlib.closing(batches):
            for batch in itertools.islice(batches, num_iters):
                metrics, fake = train_step(state, batch)
                # rows [0:buf_count] are the steps since the last flush; a buffer
                # full before its cadence (a resume off the cadence) flushes now
                if buf_count >= cfg.log_every:
                    flush_log(state.step)
                log_buf[buf_count] = torch.stack([metrics[k].float() for k in METRIC_KEYS])
                buf_count += 1
                perf["steps"] += 1
                gs = state.step
                if gs % cfg.log_every == 0:
                    flush_log(gs)
                    log_throughput(gs)
                if gs % cfg.log_enc_every == 0:
                    log_diag(batch, fake, gs)
                if gs % cfg.save_every == 0:
                    save(gs, ep)
                if gs % cfg.save_imgs_every == 0 and mesh.is_main():
                    sample_and_save_imgs(logger, state, train_ds, "train", train_eval_indices,
                                         sample_key, cfg.dbg)
                    sample_and_save_imgs(logger, state, val_ds, "val", val_eval_indices,
                                         sample_key, cfg.dbg)
                if gs % cfg.eval_every == 0:
                    run_eval(state, val_ds, logger, val_bs, sample_key)

    epoch_iter = range(last_epoch, cfg.n_epochs)
    if progress and mesh.is_main():
        try:
            from tqdm import tqdm

            epoch_iter = tqdm(epoch_iter, desc="Epochs")
        except ImportError:
            pass

    # every save records the epoch in progress, so a resume replays the
    # data schedule from that epoch (the reference's train_gim_imgs:432-447)
    cur_epoch = last_epoch
    try:
        for ep in epoch_iter:
            cur_epoch = ep
            try:
                run_epoch(ep)
            except PermissionError as pe:
                print(f"\nPermissionError\n{pe}\nSaving checkpoint...\n")
                checkpoint_io.save(state, state.step, last_epoch=ep)
                if world > 1:
                    raise
                continue
        cur_epoch = cfg.n_epochs
    except KeyboardInterrupt:
        print("\nKeyboardInterrupt\nSaving checkpoint...\n")
        checkpoint_io.save(state, state.step, last_epoch=cur_epoch)
        return state
    save(state.step, cur_epoch)
    return state
