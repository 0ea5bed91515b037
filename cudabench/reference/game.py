"""Plain PyTorch reference of the GIM image game's train step, in f32.

One step, as the game defines it:

  1. impersonator phase, when (step + 1) % n_au_steps == 0: one power
     iteration of every SN conv of the impersonator; the fakes of the leaked
     images and the noise z; BCE toward 1 of the authenticator's logits on
     them (the authenticator at its weights and spectral state before this
     step); one Adam step of the impersonator;
  2. authenticator phase: one power iteration of its SN convs; BCE of its
     logits on the real sets toward 1 and on the detached fakes toward 0, each
     beside the registration set si; with reg_param > 0 the R1 penalty
     reg_param * (|d sum(out_real) / d real|^2 + |d sum(out_real) / d si|^2)
     per episode, differentiated again for the parameters; one Adam step.

Images are uint8 [B, S, H, W, C], taken to [-1, 1] as x / 127.5 - 1.  Every
loss is a mean over episodes of per-episode terms, so a step runs in blocks
of ``chunk`` episodes and sums their gradients: the memory of a block, the
result of the whole batch.  Adam is written out (bias-corrected, eps 1e-8)
with a MultiStepLR schedule per parameter group.  TF32 is turned off.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from cudabench.reference.models import players


def exact_f32() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def prepare(x: torch.Tensor) -> torch.Tensor:
    return x.float() / 127.5 - 1.0


def bce(logits: torch.Tensor, target: float) -> torch.Tensor:
    l = logits
    return (l.clamp_min(0.0) - l * target + torch.log1p(torch.exp(-l.abs()))).squeeze(-1)


def power_iterate(module: torch.nn.Module) -> None:
    for m in module.modules():
        if hasattr(m, "power_iterate_"):
            m.power_iterate_()


class Adam:
    """Adam over named parameters, each with its group's learning rate."""

    def __init__(self, params: Dict[str, torch.Tensor], lrs: Dict[str, float], betas,
                 milestones=(), gamma: float = 1.0, eps: float = 1e-8):
        self.params, self.lrs = params, lrs
        self.b1, self.b2 = betas
        self.milestones, self.gamma, self.eps = tuple(milestones), gamma, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        decay = self.gamma ** sum(1 for m in self.milestones if m <= self.t)
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = self.v[k].sqrt() / math.sqrt(bc2) + self.eps
            p.sub_(self.lrs[k] * decay / bc1 * self.m[k] / denom)


class Game:
    """Both players of a configuration's ``game`` fields, their Adams and the step count."""

    def __init__(self, game: dict, weights: Optional[Dict[str, Dict[str, torch.Tensor]]],
                 device, quant: Optional[str] = None):
        self.cfg = game
        self.au, self.im = players(game, quant)
        for name, module in (("au", self.au), ("im", self.im)):
            module.to(device)
            if weights is not None:  # None: left unset (the FLOP count on the meta device)
                module.load_state_dict(weights[name], strict=True)
        betas = (game["beta1"], game["beta2"])
        sched = dict(milestones=game["milestones"], gamma=game["lr_gamma"])
        au_p = dict(self.au.named_parameters())
        im_p = dict(self.im.named_parameters())
        im_lr = {k: (game["env_noise_mapping_lr"] if k.startswith("env_noise_mapper.")
                     else game["im_lr"]) for k in im_p}
        self.opt_au = Adam(au_p, {k: game["au_lr"] for k in au_p}, betas, **sched)
        self.opt_im = Adam(im_p, im_lr, betas, **sched)
        self.step_count = -1


def _blocks(b: int, chunk: Optional[int]) -> List[slice]:
    chunk = chunk or b
    return [slice(i, min(i + chunk, b)) for i in range(0, b, chunk)]


def _accumulate(total: Optional[dict], names, grads) -> dict:
    if total is None:
        return dict(zip(names, grads))
    for k, g in zip(names, grads):
        total[k].add_(g)
    return total


def au_outputs(au, real, fake, si):
    """One encoder pass over [si; real; fake], two head calls -> (out_real, out_fake)."""
    b, n, k = real.shape[0], real.shape[1], si.shape[1]
    img = real.shape[2:]
    src, env = au.encode(torch.cat([si.reshape(b * k, *img), real.reshape(b * n, *img),
                                    fake.reshape(b * n, *img)]))

    def split(x):
        return (x[:b * k].reshape(b, k, -1), x[b * k:b * (k + n)].reshape(b, n, -1),
                x[b * (k + n):].reshape(b, n, -1))

    si_src, real_src, fake_src = split(src)
    si_env, real_env, fake_env = split(env)
    return (au.dis(real_src, real_env, si_src, si_env),
            au.dis(fake_src, fake_env, si_src, si_env))


def train_step(game: Game, batch: Dict[str, torch.Tensor], z: torch.Tensor,
               chunk: Optional[int] = None) -> dict:
    """One game step in place.  Returns {"im_loss", "au_loss"} as 0-dim tensors, the
    gradients each Adam took, {"au": {name: grad}, "im": {name: grad}}, and the fakes."""
    cfg = game.cfg
    au, im = game.au, game.im
    step = game.step_count + 1
    b = batch["real_sample"].shape[0]
    blocks = _blocks(b, chunk)
    im_names = [k for k, _ in im.named_parameters()]
    au_names = [k for k, _ in au.named_parameters()]
    im_params = [p for _, p in im.named_parameters()]
    au_params = [p for _, p in au.named_parameters()]
    grads = {}

    fakes, im_loss = [], torch.zeros((), device=z.device)
    train_im = (step + 1) % cfg["n_au_steps"] == 0
    if train_im:
        power_iterate(im)
    total = None
    for rows in blocks:
        leaked, si = prepare(batch["leaked_sample"][rows]), prepare(batch["si_sample"][rows])
        with torch.set_grad_enabled(train_im):
            fake = im(leaked, z[rows], cfg["remove_noise_mean"])
            loss = bce(au(fake, si), 1.0).sum() / b
        if train_im:
            total = _accumulate(total, im_names, torch.autograd.grad(loss, im_params))
        im_loss = im_loss + loss.detach()
        fakes.append(fake.detach())
    if train_im:
        game.opt_im.step(total)
        grads["im"] = total

    power_iterate(au)
    r1 = cfg["reg_param"] > 0
    total, au_loss = None, torch.zeros((), device=z.device)
    for rows, fake in zip(blocks, fakes):
        real, si = prepare(batch["real_sample"][rows]), prepare(batch["si_sample"][rows])
        if r1:
            real.requires_grad_(True)
            si.requires_grad_(True)
        out_real, out_fake = au_outputs(au, real, fake, si)
        per = bce(out_real, 1.0) + bce(out_fake, 0.0)
        if r1:
            g_real, g_si = torch.autograd.grad(out_real.sum(), (real, si), create_graph=True)
            n = real.shape[0]
            per = per + cfg["reg_param"] * (g_real.square().reshape(n, -1).sum(1)
                                            + g_si.square().reshape(n, -1).sum(1))
        loss = per.sum() / b
        total = _accumulate(total, au_names, torch.autograd.grad(loss, au_params))
        au_loss = au_loss + loss.detach()
    game.opt_au.step(total)
    grads["au"] = total
    game.step_count = step
    return {"im_loss": im_loss, "au_loss": au_loss}, grads, torch.cat(fakes)
