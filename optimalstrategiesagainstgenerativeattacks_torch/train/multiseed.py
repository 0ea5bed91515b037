"""Multi-seed image-game training: S independent games stepped together.

Counterpart of ``optimalstrategiesagainstgenerativeattacks_tpu/train/multiseed.py``
and of its CLI's loop (``train_multiseed_gim_on_imgs.py``).  Adversarial
training is seed-noisy, so variance studies train several seeds at once.

A seed is one ``GameState``: its own players, Adams, schedulers and noise
generator, built exactly as a single-seed run at that seed builds them
(``create_state(cfg, au, im, seed, device)``).  ``multiseed_train_step``
steps the S states one after another, so seed s stays bit-identical to a
single-seed run at seed s.  The JAX package vmaps its step instead, which
runs the S games as one XLA program; here the hand-written kernels sit
behind ``torch.autograd.Function``s with no vmap rule, and the step holds
in-place Adam and spectral updates and R1's double backward, so the seeds
run in a loop: S times one step's cost.

Checkpoints stay those of single-seed training: ``slice_seed`` is an
ordinary ``GameState``, saved under ``<outdir>/seed_<s>/`` with its own
``args.json``, which the eval CLI reads as it reads a single-seed run.
"""

from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

from optimalstrategiesagainstgenerativeattacks_torch.data.device_sampler import DeviceEpisodicLoader
from optimalstrategiesagainstgenerativeattacks_torch.train.checkpoints import CheckpointIO
from optimalstrategiesagainstgenerativeattacks_torch.train.image import (
    build_models,
    create_state,
    train_step,
)
from optimalstrategiesagainstgenerativeattacks_torch.train.state import GameState
from optimalstrategiesagainstgenerativeattacks_torch.utils.config import ImageGameConfig, save_args


@dataclass
class MultiSeedState:
    """S games, one ``GameState`` a seed, in the order of ``seeds``."""

    states: List[GameState]
    seeds: List[int]


def stack_states(states: Sequence[GameState]) -> MultiSeedState:
    """Gather S per-seed states (each built or restored alone) into one."""
    return MultiSeedState(list(states), [st.cfg.seed for st in states])


def slice_seed(ms: MultiSeedState, s: int) -> GameState:
    """Seed ``s`` (an index) as an ordinary single-game ``GameState``."""
    return ms.states[s]


def n_seeds(ms: MultiSeedState) -> int:
    return len(ms.states)


def create_multiseed_state(cfg: ImageGameConfig, seeds: Sequence[int], device) -> MultiSeedState:
    """One game a seed, each built as a single-seed run at that seed builds it."""
    states = []
    for s in seeds:
        seed_cfg = dataclasses.replace(cfg, seed=int(s))
        au, im = build_models(seed_cfg)
        states.append(create_state(seed_cfg, au, im, int(s), device))
    return stack_states(states)


def stack_batches(batches: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """S per-seed batches -> one batch with a leading seed axis ``[S, B, ...]``."""
    return {k: torch.stack([torch.as_tensor(b[k]) for b in batches]) for k in batches[0]}


def multiseed_train_step(ms: MultiSeedState, batches: Dict[str, torch.Tensor],
                         z: Optional[torch.Tensor] = None):
    """One train step of every seed, seed s on ``batches[k][s]``; updates ``ms`` in place.

    ``z`` ``[S, B, n, style]`` replaces each seed's noise draw (tests inject
    it).  Returns (metrics ``{name: [S]}`` f32 on the device, no host sync;
    the fakes ``[S, B, n, H, W, C]``).
    """
    metrics, fakes = [], []
    for s, state in enumerate(ms.states):
        m, fake = train_step(state, {k: v[s] for k, v in batches.items()},
                             z=None if z is None else z[s])
        metrics.append(m)
        fakes.append(fake)
    return {k: torch.stack([m[k].float() for m in metrics]) for k in metrics[0]}, torch.stack(fakes)


def set_seed_lr(ms: MultiSeedState, player: str, lrs: Sequence[float]) -> None:
    """Give each seed its own constant learning rate (the JAX ``set_injected_lr``).

    ``player`` "au" sets the authenticator's; "im" sets the impersonator's
    main group, and the env-noise mapper's group keeps its LR.  The LR goes
    into the optimizer and the scheduler's ``base_lrs``.  Like the JAX
    package, which injects LRs only without a schedule, it refuses a config
    with milestones.
    """
    if player not in ("au", "im"):
        raise ValueError(f"player must be 'au' or 'im', got {player!r}")
    if len(lrs) != n_seeds(ms):
        raise ValueError(f"{len(lrs)} learning rates for {n_seeds(ms)} seeds")
    for state, lr in zip(ms.states, lrs):
        if state.cfg.milestones:
            raise ValueError("per-seed LRs need constant LRs (no milestones)")
        opt, sched = getattr(state, f"opt_{player}"), getattr(state, f"sched_{player}")
        group = opt.param_groups[0]  # the authenticator's only group; the im's main one
        group["lr"] = group["initial_lr"] = float(lr)
        sched.base_lrs[0] = float(lr)
        sched._last_lr = [g["lr"] for g in opt.param_groups]


def seed_args(args: dict, seed: int, seed_dir: str) -> dict:
    """A seed's ``args.json``: the run's arguments with its own seed and outdir,
    without the multi-seed lists (as the JAX CLI writes it)."""
    d = dict(args, seed=seed, outdir=seed_dir)
    for key in ("seeds", "au_lrs", "im_lrs"):
        d.pop(key, None)
    return d


def train_multiseed_gim_imgs(cfg: ImageGameConfig, seeds: Sequence[int], train_ds, outdir: str,
                             n_steps: int, save_every: int = 400, log_every: int = 50,
                             au_lrs: Optional[Sequence[float]] = None,
                             im_lrs: Optional[Sequence[float]] = None,
                             args: Optional[dict] = None, device="cuda"):
    """Train one game a seed for ``n_steps`` steps (the JAX CLI's loop).

    Each seed draws from its own ``DeviceEpisodicLoader`` (seed s), all of
    them over one resident copy of the dataset.  Epochs count from 1, as in
    the JAX loop.  Every ``log_every`` steps the seeds' ``au_acc`` reach the
    host in one transfer; every ``save_every`` steps and at the end each seed
    saves ``<outdir>/seed_<s>/ckpts/model_{step:08d}``, beside the
    ``args.json`` written at the start (``args``: the CLI's arguments, else
    the config's fields).  Returns (state, [(step, au_acc [S] numpy)]).
    """
    seeds = [int(s) for s in seeds]
    args = dataclasses.asdict(cfg) if args is None else args
    ios = []
    for s in seeds:
        seed_dir = os.path.join(outdir, f"seed_{s}")
        save_args(seed_args(args, s, seed_dir), seed_dir)
        ios.append(CheckpointIO(os.path.join(seed_dir, cfg.ckpt_dir_name)))

    first = DeviceEpisodicLoader(train_ds, cfg.batch_size, seed=seeds[0], device=device)
    loaders = [first] + [DeviceEpisodicLoader(train_ds, cfg.batch_size, seed=s, device=device,
                                              data=first.data) for s in seeds[1:]]
    ms = create_multiseed_state(cfg, seeds, device)
    if au_lrs:
        set_seed_lr(ms, "au", au_lrs)
    if im_lrs:
        set_seed_lr(ms, "im", im_lrs)
    print(f"training {len(seeds)} seeds {seeds}, {n_steps} steps", flush=True)

    readings = []
    t0 = time.time()
    step = epoch = 0
    while step < n_steps:
        epoch += 1
        for loader in loaders:
            loader.set_epoch(epoch)
        for per_seed in zip(*loaders):
            metrics, _ = multiseed_train_step(ms, stack_batches(per_seed))
            step += 1
            if step % log_every == 0:
                acc = metrics["au_acc"].cpu().numpy()  # one transfer
                readings.append((step, acc))
                dt = time.time() - t0
                print(f"step {step}: au_acc mean {acc.mean():.3f} [{acc.min():.3f}.."
                      f"{acc.max():.3f}] ({step / dt:.2f} multi-steps/s = "
                      f"{len(seeds) * step / dt:.2f} seed-steps/s)", flush=True)
            if step % save_every == 0 or step >= n_steps:
                for i, io in enumerate(ios):
                    io.save(slice_seed(ms, i), step, last_epoch=epoch)
                if step >= n_steps:
                    break
    print(f"done: {step} steps x {len(seeds)} seeds in {time.time() - t0:.1f}s", flush=True)
    return ms, readings
