"""Training of the port across cards: the checks of ``chip_smoke.py``'s phases 16
(data parallel) and 17 (the model axis), and the scaling measurement.

    python scripts/torch_data_parallel.py check [--seed 0] [--model_parallel 2]
    python scripts/torch_data_parallel.py scale [--configs flagship vox] [--worlds 1 2 4]
        [--layouts 1x1 2x1 2x2 4x1] [--steps 20] [--json <path>]

``check``: with k >= 2 visible cards, k ranks over NCCL, one a card; with one
card, two ranks on it over gloo (NCCL refuses two ranks on one card).  Every
rank, at the flagship config (32x32x1, style 512) and a global B of 128 from
``--seed``:
  1. f32 (TF32 off, cuDNN deterministic): 2 train steps on its slice of each
     batch and of the global noise draw;
  2. every parameter, spectral u/v and Adam moment against rank 0's, bit for
     bit;
  3. bf16: 4 train steps with finite metrics and one step's kernel launches a
     step on every rank (AdaIN forward 16, backward 16, attention 9); the last
     3 timed (steps/s);
then rank 0 leaves the group and takes the f32 steps in one process on the
whole batches with the same noise, and holds the ranks' run to it within the
JAX suite's own mesh tolerances (``tests/test_image_training.py:159-174``:
each step's metrics that do not pass through the fake rtol = atol = 1e-5,
the others 0.1; the parameters after the last step, the authenticator's rtol
1e-4 / atol 1e-5, the impersonator's rtol 1e-3 / atol 5e-4; the spectral u/v
after the first step, as the JAX suite's one step, rtol 1e-5 / atol 1e-6);
each player's last gradient (the Adam first moment, beta1 = 0) is printed
beside them as |g - g_one| / |g_one| over all its tensors.  Prints one line
``DP_CHECK {json}``.

``check --model_parallel 2``: the ranks laid out (data, model) by
``parallel/mesh.py:create_mesh``, the state sharded by
``parallel/tensor.py:shard_state_`` at the default ``min_size`` 1024 (at both
configs the authenticator head's six matrices).  With one card two ranks on
it over gloo (data 1 x model 2), with 2-3 cards two over NCCL, with 4 or more
four over NCCL (data 2 x model 2).  Every rank:
  (a) the flagship in f32 (TF32 off, cuDNN deterministic) at a global B of
      128: 2 steps, held to one process on the same batches and noise within
      the JAX suite's mesh tolerances as above (the state gathered whole);
  (b) the VoxCeleb config (R1) in bf16 at a global B of 32 when the ranks
      share a card (each rank holds its data shard whole: two ranks at 128
      would need ~84 GiB), else 128: a warm-up step and 2 timed steps,
      metrics finite, the kernels' launches a timed step on every rank equal
      one card's step (18 + 18 + 9), steps/s a rank, and the model-axis
      collectives' ms a step on each rank (CUDA events around each
      all-reduce and gather, the wait for the other ranks included);
  after each, every replicated parameter, u/v and Adam moment bit-equal on
  every rank and every sharded slice bit-equal on the ranks of its data
  group.  Prints one line ``TP_CHECK {json}``.

``scale``: for each config (the flagship, and the VoxCeleb2 config: 64x64x3,
R1 with reg_param 10; both bf16 at a global B of 128) and each world size
(one process without a group for 1): warm-up steps, then ``--steps`` timed
steps on batches staged on the cards: steps/s on the host clock ending in a
synchronize, each rank's peak memory, and the all-reduce phases' ms a step
(CUDA events around the gradient and metric reductions on the step's stream:
the flatten, NCCL's all_reduce with the wait for the slowest rank, and the
division), and the two gradient all_reduces alone (buffers of the players'
sizes, all ranks released together by a barrier, median of 10).  Prints one line ``DP_SCALE {json}`` (and writes it to ``--json``).
``--layouts DxM ...`` (instead of ``--worlds``): D*M ranks laid out data D x
model M, the head's six matrices sharded when M > 1; each row adds the
model-axis collectives' ms a step.  Every number names the card and its
power limit.

Internally ``worker <job.json>`` is one rank (``parallel/mesh.py:run_workers``
sets its variables).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from optimalstrategiesagainstgenerativeattacks_torch.parallel import mesh  # noqa: E402

GLOBAL_B = 128
CHECK_F32_STEPS, CHECK_BF16_STEPS = 2, 4
# launches a flagship step, on every rank (chip_smoke.py's ADAIN_SITES and ATTENTION_SITES)
STEP_LAUNCHES = {"adain_fwd": 16, "adain_bwd": 16, "attention_core_fwd": 9}
VOX_STEP_LAUNCHES = {"adain_fwd": 18, "adain_bwd": 18, "attention_core_fwd": 9}  # VOX_LAUNCHES
TP_STEPS = 2
MIN_SIZE = 1024  # param_shardings' default
# tests/test_image_training.py:159-174, the JAX suite's mesh tolerances
TIGHT_METRICS = ("au_loss_on_real", "au_out_on_real", "au_acc_on_real", "au_reg", "im_trained")
PARAM_TOL = {"au": (1e-4, 1e-5), "im": (1e-3, 5e-4), "spectral": (1e-5, 1e-6)}
VOX = dict(img_size=64, img_channels=3, au_lr=1e-4, im_lr=1e-4, env_noise_mapping_lr=1e-6,
           reg_param=10.0)
BUILD = REPO / "build" / "data_parallel"


def smi_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().replace("\n", "; ")


def config(name: str, seed: int, dtype: str = "bfloat16"):
    from optimalstrategiesagainstgenerativeattacks_torch.utils.config import ImageGameConfig

    return ImageGameConfig(seed=seed, compute_dtype=dtype, **(VOX if name == "vox" else {}))


def global_batches(cfg, seed: int, n: int) -> list:
    """``n`` global uint8 batches of random episodes (the same on every rank)."""
    rng = np.random.default_rng(seed)
    return [{key: torch.from_numpy(rng.integers(
        0, 256, (cfg.batch_size, s, cfg.img_size, cfg.img_size, cfg.img_channels),
        dtype=np.uint8)) for key, s in (("real_sample", cfg.n), ("leaked_sample", cfg.m),
                                        ("si_sample", cfg.k))} for _ in range(n)]


def on_card(batch: dict, device) -> dict:
    """This rank's shard of a global batch, on its card."""
    return {k: v.to(device) for k, v in mesh.shard_batch(batch).items()}


def new_state(cfg, device):
    from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg

    return timg.create_state(cfg, *timg.build_models(cfg), cfg.seed, device)


def flat(state) -> torch.Tensor:
    """Every parameter, buffer (spectral u/v) and Adam moment of both players, in one
    f32 vector."""
    parts = []
    for player in ("au", "im"):
        module, opt = getattr(state, player), getattr(state, f"opt_{player}")
        parts += [v.float().reshape(-1) for v in module.state_dict().values()]
        parts += [opt.state[p][k].reshape(-1) for p in module.parameters()
                  for k in ("exp_avg", "exp_avg_sq")]
    return torch.cat(parts)


def tensors(state) -> dict:
    """name -> (group of PARAM_TOL, value, gradient or None) of both players; the
    spectral u/v are copies."""
    out = {}
    for player in ("au", "im"):
        module, opt = getattr(state, player), getattr(state, f"opt_{player}")
        params = dict(module.named_parameters())
        for k, v in module.state_dict().items():
            p = params.get(k)
            out[f"{player}.{k}"] = (player, v.detach(), opt.state[p]["exp_avg"]) if p is not None \
                else ("spectral", v.detach().clone(), None)
    return out


def f32_steps(state, batches, device) -> tuple:
    """The f32 steps on this rank's shards -> (metrics a step, the spectral u/v after
    the first step: those of later steps follow weights that Adam's first step may
    already have moved 2 lr apart where a gradient is rounding noise)."""
    from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg

    metrics, spectral = [], None
    for b in batches:
        metrics.append({k: float(v) for k, v in timg.train_step(state, on_card(b, device))[0]
                        .items()})
        if spectral is None:
            spectral = {k: t for k, t in tensors(state).items() if t[0] == "spectral"}
    return metrics, spectral


def strict_cudnn() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def check_worker(job: dict) -> dict:
    import torch.distributed as dist

    from optimalstrategiesagainstgenerativeattacks_torch.kernels import adain as k1
    from optimalstrategiesagainstgenerativeattacks_torch.kernels import attention as k2
    from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg

    device = mesh.init_process("cuda:0" if job["share"] else "cuda", backend=job["backend"])
    rank, world = mesh.rank(), mesh.world_size()
    strict_cudnn()
    seed = job["seed"]
    cfg32 = config("flagship", seed, "float32")
    batches32 = global_batches(cfg32, seed, CHECK_F32_STEPS)
    state = new_state(cfg32, device)
    f32, spectral = f32_steps(state, batches32, device)
    vec = flat(state)
    ref = vec.clone()
    dist.broadcast(ref, 0)
    differ = torch.tensor([float((vec != ref).sum())], device=device)
    dist.all_reduce(differ)
    del vec, ref

    cfg16 = config("flagship", seed)
    state16 = new_state(cfg16, device)
    batches16 = [on_card(b, device) for b in global_batches(cfg16, seed + 1, CHECK_BF16_STEPS)]
    counters = (k1.FWD_LAUNCHES, k1.BWD_LAUNCHES, k2.FWD_LAUNCHES)
    for c in counters:
        c.reset()
    bf16 = [timg.train_step(state16, batches16[0])[0]]
    torch.cuda.synchronize()
    mesh.barrier()
    t0 = time.perf_counter()
    bf16 += [timg.train_step(state16, b)[0] for b in batches16[1:]]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / (CHECK_BF16_STEPS - 1)
    out = {"rank": rank, "world": world, "backend": dist.get_backend(), "device": str(device),
           "f32": f32, "bits_differing_from_rank0": float(differ.item()),
           "bf16_finite": all(math.isfinite(float(v)) for m in bf16 for v in m.values()),
           "bf16_au_acc": [float(m["au_acc"]) for m in bf16],
           "launches": {c.name: c.count for c in counters}, "bf16_step_s": step_s,
           "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30}
    mesh.barrier()
    mesh.shutdown()
    if rank == 0:
        out["single"] = compare_single(cfg32, batches32, state, f32, spectral, device)
    return out


def compare_single(cfg, batches, dp_state, dp_metrics, dp_spectral, device) -> dict:
    """The f32 steps in one process on the whole batches (no group: ``on_card`` keeps
    each whole), against the ranks' run: the metrics of each step, the parameters
    after the last and the spectral u/v after the first."""
    state = new_state(cfg, device)
    metrics, spectral = f32_steps(state, batches, device)
    worst_metric, bad = 0.0, []
    for step, (got, want) in enumerate(zip(dp_metrics, metrics)):
        for k, w in want.items():
            tol = 1e-5 if k in TIGHT_METRICS else 0.1
            ratio = abs(got[k] - w) / (tol + tol * abs(w))
            worst_metric = max(worst_metric, ratio)
            if ratio > 1.0:
                bad.append(f"step {step} {k}: {got[k]} vs {w}")
    worst = {g: (0.0, "") for g in PARAM_TOL}
    grad_sq = {"au": [0.0, 0.0], "im": [0.0, 0.0]}  # |g - g_ref|^2, |g_ref|^2
    want_t = {**tensors(state), **spectral}
    for name, (group, got, g) in {**tensors(dp_state), **dp_spectral}.items():
        _, want, wg = want_t[name]
        rtol, atol = PARAM_TOL[group]
        ratio = ((got - want).abs() / (atol + rtol * want.abs())).max().item()
        worst[group] = max(worst[group], (ratio, name))
        if ratio > 1.0:
            bad.append(f"{name}: {ratio:.3g} of its tolerance")
        if g is not None:
            acc = grad_sq[name.split(".")[0]]
            acc[0] += (g - wg).square().sum().item()
            acc[1] += wg.square().sum().item()
    return {"metrics": metrics, "worst_metric_ratio": worst_metric,
            "worst_tensor_ratio": {g: list(v) for g, v in worst.items()},
            "grad_rel_err": {p: math.sqrt(d / r) for p, (d, r) in grad_sq.items()}, "bad": bad}


def sharded_names(state) -> set:
    from optimalstrategiesagainstgenerativeattacks_torch.parallel import tensor

    return {f"{p}.{n}" for p in ("au", "im") for n in tensor.sharded_weights(getattr(state, p))}


def split_flat(state) -> tuple:
    """(every replicated parameter, buffer and Adam moment, every sharded slice and its
    moments), each in one f32 vector."""
    sharded = sharded_names(state)
    parts = ([], [])
    for player in ("au", "im"):
        module, opt = getattr(state, player), getattr(state, f"opt_{player}")
        params = dict(module.named_parameters())
        for k, v in module.state_dict().items():
            i = f"{player}.{k}" in sharded
            parts[i].append(v.float().reshape(-1))
            if k in params:
                parts[i].extend(opt.state[params[k]][m].reshape(-1)
                                for m in ("exp_avg", "exp_avg_sq"))
    return tuple(torch.cat(p) if p else torch.zeros(0) for p in parts)


def differing(layout, state, device) -> dict:
    """Entries that differ from rank 0's (replicated) and from the data group's first
    rank's (sharded slices), summed over the ranks."""
    import torch.distributed as dist

    rep, sh = (v.to(device) for v in split_flat(state))
    ref = rep.clone()
    dist.broadcast(ref, 0)
    counts = torch.tensor([float((rep != ref).sum()), 0.0], device=device)
    if layout.data.size > 1 and sh.numel():
        ref = sh.clone()
        dist.broadcast(ref, layout.model.rank, group=layout.data.group)
        counts[1] = float((sh != ref).sum())
    dist.all_reduce(counts)
    return {"replicated": counts[0].item(), "sharded": counts[1].item()}


class CollectiveTimer:
    """CUDA events around every model-axis collective (``parallel/tensor.py``'s
    ``all_reduce_sum`` and ``all_gather``) while on."""

    def __init__(self):
        from optimalstrategiesagainstgenerativeattacks_torch.parallel import tensor

        self.events, self.on = [], False
        for name in ("all_reduce_sum", "all_gather"):
            setattr(tensor, name, self.wrap(getattr(tensor, name)))

    def wrap(self, fn):
        def timed(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.events.append((start, end))
            return out
        return timed

    def ms(self) -> tuple:
        """(calls, ms) recorded so far."""
        torch.cuda.synchronize()
        return len(self.events), sum(s.elapsed_time(e) for s, e in self.events)


def tp_check_worker(job: dict) -> dict:
    from optimalstrategiesagainstgenerativeattacks_torch.kernels import adain as k1
    from optimalstrategiesagainstgenerativeattacks_torch.kernels import attention as k2
    from optimalstrategiesagainstgenerativeattacks_torch.parallel import tensor
    from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg

    device = mesh.init_process("cuda:0" if job["share"] else "cuda", backend=job["backend"])
    layout = mesh.create_mesh(job["model_parallel"])
    rank = mesh.rank()
    timer = CollectiveTimer()
    strict_cudnn()
    seed = job["seed"]
    cfg32 = config("flagship", seed, "float32")
    batches32 = global_batches(cfg32, seed, CHECK_F32_STEPS)
    state = new_state(cfg32, device)
    names = tensor.shard_state_(state, layout, MIN_SIZE)
    f32, spectral = f32_steps(state, batches32, device)
    f32_bits = differing(layout, state, device)
    whole = tensor.gather_state(state)
    del state

    cfgv = dataclasses.replace(config("vox", seed), batch_size=job["vox_b"])
    statev = new_state(cfgv, device)
    tensor.shard_state_(statev, layout, MIN_SIZE)
    batchesv = [on_card(b, device) for b in global_batches(cfgv, seed + 1, TP_STEPS + 1)]
    vox = [timg.train_step(statev, batchesv[0])[0]]  # warm-up: the kernels' first launches
    counters = (k1.FWD_LAUNCHES, k1.BWD_LAUNCHES, k2.FWD_LAUNCHES, k1.NHWC_COPIES)
    for c in counters:
        c.reset()
    torch.cuda.synchronize()
    mesh.barrier()
    timer.on = True
    t0 = time.perf_counter()
    vox += [timg.train_step(statev, b)[0] for b in batchesv[1:]]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TP_STEPS
    timer.on = False
    calls, coll_ms = timer.ms()
    out = {"rank": rank, "world": mesh.world_size(),
           "layout": [layout.data.rank, layout.model.rank],
           "shape": layout.shape, "backend": job["backend"], "device": str(device),
           "sharded": {p: names[p] for p in names}, "f32": f32, "f32_bits": f32_bits,
           "vox_bits": differing(layout, statev, device),
           "vox_finite": all(math.isfinite(float(v)) for m in vox for v in m.values()),
           "vox_au_loss": [float(m["au_loss"]) for m in vox],
           "launches": {c.name: c.count for c in counters}, "vox_step_s": step_s,
           "collectives_a_step": calls / TP_STEPS, "collective_ms_a_step": coll_ms / TP_STEPS,
           "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30}
    mesh.barrier()
    mesh.shutdown()
    if rank == 0:
        one = new_state(cfg32, device)
        for p in ("au", "im"):
            getattr(one, p).load_state_dict(whole[p])
            getattr(one, f"opt_{p}").load_state_dict(whole[f"opt_{p}"])
        one.step = CHECK_F32_STEPS - 1
        out["single"] = compare_single(cfg32, batches32, one, f32, spectral, device)
    return out


def scale_worker(job: dict) -> dict:
    import optimalstrategiesagainstgenerativeattacks_torch.train.state as tstate
    from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg

    from optimalstrategiesagainstgenerativeattacks_torch.parallel import tensor

    world = int(os.environ["WORLD_SIZE"])
    device = mesh.init_process("cuda") if world > 1 else torch.device("cuda", 0)
    mp = job.get("model_parallel", 1)
    layout = mesh.create_mesh(mp) if world > 1 else None
    cfg = config(job["config"], job["seed"])
    state = new_state(cfg, device)
    if mp > 1:
        tensor.shard_state_(state, layout, MIN_SIZE)
    timer = CollectiveTimer()
    batches = [on_card(b, device) for b in global_batches(cfg, job["seed"], 2)]
    events = []

    def timed(fn):
        def wrapper(*args):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            events.append((start, end))
            return out
        return wrapper

    tstate.all_reduce_grads_ = timed(tstate.all_reduce_grads_)
    mesh.all_reduce_mean_dict = timed(mesh.all_reduce_mean_dict)
    for i in range(job["warm"]):
        timg.train_step(state, batches[i % 2])
    torch.cuda.synchronize()
    mesh.barrier()
    torch.cuda.reset_peak_memory_stats(device)
    events.clear()
    timer.on = True
    t0 = time.perf_counter()
    for i in range(job["steps"]):
        metrics, _ = timg.train_step(state, batches[i % 2])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    timer.on = False
    finite = all(math.isfinite(float(v)) for v in metrics.values())
    out = {"rank": mesh.rank(), "world": world, "steps_per_s": job["steps"] / seconds,
           "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30,
           "allreduce_ms_per_step": sum(s.elapsed_time(e) for s, e in events) / job["steps"],
           "params": dict(zip(("au", "im"), out_params(state))), "finite": finite,
           "model_axis_ms_per_step": timer.ms()[1] / job["steps"],
           "nccl_ms_per_step": nccl_ms(list(out_params(state)), device) if world > 1 else 0.0}
    mesh.shutdown()
    return out


def out_params(state):
    """Each player's parameters held on this rank (its slices of sharded weights)."""
    return (sum(x.numel() for x in getattr(state, p).parameters()) for p in ("au", "im"))


def nccl_ms(sizes, device, reps: int = 10) -> float:
    """A step's two gradient all_reduces alone (f32 buffers of the players' sizes),
    all ranks released together by a barrier: the median of ``reps`` after two."""
    import statistics

    import torch.distributed as dist

    bufs = [torch.zeros(n, device=device) for n in sizes]
    times = []
    for i in range(reps + 2):
        mesh.barrier()
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for b in bufs:
            dist.all_reduce(b)
        end.record()
        torch.cuda.synchronize(device)
        if i >= 2:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def worker(path: str) -> None:
    job = json.loads(Path(path).read_text())
    out = {"check": check_worker, "tp_check": tp_check_worker,
           "scale": scale_worker}[job["kind"]](job)
    Path(f"{job['out']}.rank{out['rank']}.json").write_text(json.dumps(out))


def run(job: dict, world: int, timeout: float) -> list:
    """Run ``job`` on ``world`` ranks; returns each rank's result."""
    BUILD.mkdir(parents=True, exist_ok=True)
    path = BUILD / (f"{job['kind']}_{job.get('config', 'flagship')}_{world}"
                    f"x{job.get('model_parallel', 1)}.json")
    job = dict(job, out=str(path))
    for r in range(world):
        Path(f"{path}.rank{r}.json").unlink(missing_ok=True)
    path.write_text(json.dumps(job))
    mesh.run_workers([sys.executable, str(Path(__file__).resolve()), "worker", str(path)],
                     world, timeout=timeout)
    return [json.loads(Path(f"{path}.rank{r}.json").read_text()) for r in range(world)]


def check(seed: int = 0, timeout: float = 400.0) -> dict:
    """Phase 16's check; returns a summary with ``ok`` and the reasons it is not."""
    cards = torch.cuda.device_count()
    share = cards < 2
    world, backend = (2, "gloo") if share else (cards, "nccl")
    why = ("only one card is visible and NCCL refuses two ranks on one card" if share
           else f"one rank a card over {cards} cards")
    print(f"  {world} ranks over {backend}: {why}; global B={GLOBAL_B}, "
          f"{GLOBAL_B // world} a rank", flush=True)
    t0 = time.perf_counter()
    ranks = run({"kind": "check", "seed": seed, "share": share, "backend": backend}, world,
                timeout)
    single = ranks[0]["single"]
    problems = list(single["bad"])
    for r in ranks:
        if r["bits_differing_from_rank0"]:
            problems.append(f"rank {r['rank']}: {r['bits_differing_from_rank0']:.0f} entries "
                            f"differ from rank 0")
        want = {k: n * CHECK_BF16_STEPS for k, n in STEP_LAUNCHES.items()}
        if r["launches"] != want:
            problems.append(f"rank {r['rank']}: launches {r['launches']}, expected {want}")
        if not r["bf16_finite"]:
            problems.append(f"rank {r['rank']}: non-finite bf16 metrics")
    summary = {"ok": not problems, "problems": problems, "world": world, "backend": backend,
               "why": why, "seconds": time.perf_counter() - t0, "card": smi_line(),
               "bf16_steps_per_s": [1.0 / r["bf16_step_s"] for r in ranks],
               "peak_gib": [r["peak_gib"] for r in ranks],
               "launches": [r["launches"] for r in ranks],
               "worst_metric_ratio": single["worst_metric_ratio"],
               "worst_tensor_ratio": single["worst_tensor_ratio"],
               "grad_rel_err": single["grad_rel_err"],
               "f32_au_loss": [[m["au_loss"] for m in r["f32"]] for r in ranks[:1]]
               + [[m["au_loss"] for m in single["metrics"]]]}
    return summary


def print_check(summary: dict) -> None:
    print(f"  f32, {CHECK_F32_STEPS} steps, ranks against one process: worst metric "
          f"{summary['worst_metric_ratio']:.3g} of its tolerance; worst tensor of each group "
          f"(share of tolerance, name) {summary['worst_tensor_ratio']}; each player's last "
          f"gradient, |g - g_one| / |g_one| {summary['grad_rel_err']}; au_loss ranks / one process "
          f"{summary['f32_au_loss']}")
    print(f"  bf16, {CHECK_BF16_STEPS} steps: launches a rank {summary['launches']}; steps/s "
          f"a rank {[round(x, 3) for x in summary['bf16_steps_per_s']]}; peak GiB a rank "
          f"{[round(x, 2) for x in summary['peak_gib']]}  [{summary['card']}]")
    print(f"  {summary['seconds']:.1f} s; "
          + ("every rank bit-equal to rank 0" if summary["ok"] else
             "PROBLEMS: " + "; ".join(summary["problems"])))
    print("DP_CHECK " + json.dumps(summary), flush=True)


def tp_check(seed: int = 0, model_parallel: int = 2, timeout: float = 600.0) -> dict:
    """Phase 17's check (``check --model_parallel``); returns a summary with ``ok`` and
    the reasons it is not."""
    cards = torch.cuda.device_count()
    share = cards < 2
    if share:
        world, backend, why = model_parallel, "gloo", ("only one card is visible and NCCL "
                                                       "refuses two ranks on one card")
    else:
        world = 2 * model_parallel if cards >= 2 * model_parallel else model_parallel
        backend, why = "nccl", f"one rank a card over {world} of {cards} cards"
    vox_b = 32 if share else GLOBAL_B
    print(f"  {world} ranks over {backend} (data {world // model_parallel} x model "
          f"{model_parallel}): {why}; flagship f32 at a global B={GLOBAL_B}, VoxCeleb bf16 "
          f"at {vox_b}", flush=True)
    t0 = time.perf_counter()
    ranks = run({"kind": "tp_check", "seed": seed, "share": share, "backend": backend,
                 "model_parallel": model_parallel, "vox_b": vox_b}, world, timeout)
    single = ranks[0]["single"]
    problems = list(single["bad"])
    want = {k: n * TP_STEPS for k, n in VOX_STEP_LAUNCHES.items()}
    for r in ranks:
        for what in ("f32_bits", "vox_bits"):
            if any(r[what].values()):
                problems.append(f"rank {r['rank']}: {what} {r[what]} entries differ")
        got = {k: v for k, v in r["launches"].items() if k != "adain_nhwc_copy"}
        if got != want:
            problems.append(f"rank {r['rank']}: launches {got}, expected {want}")
        if r["launches"].get("adain_nhwc_copy"):
            problems.append(f"rank {r['rank']}: layout copies in front of the AdaIN kernels")
        if not r["vox_finite"]:
            problems.append(f"rank {r['rank']}: non-finite VoxCeleb metrics")
    au_sharded = sorted(ranks[0]["sharded"]["au"])
    if len(au_sharded) != 6 or ranks[0]["sharded"]["im"]:
        problems.append(f"sharded {len(au_sharded)} au and {len(ranks[0]['sharded']['im'])} im "
                        f"weights, expected the head's six matrices")
    return {"ok": not problems, "problems": problems, "world": world, "backend": backend,
            "shape": ranks[0]["shape"], "why": why, "vox_b": vox_b,
            "seconds": time.perf_counter() - t0, "card": smi_line(), "sharded": au_sharded,
            "vox_steps_per_s": [1.0 / r["vox_step_s"] for r in ranks],
            "collectives_a_step": [r["collectives_a_step"] for r in ranks],
            "collective_ms_a_step": [r["collective_ms_a_step"] for r in ranks],
            "peak_gib": [r["peak_gib"] for r in ranks],
            "launches": [r["launches"] for r in ranks],
            "worst_metric_ratio": single["worst_metric_ratio"],
            "worst_tensor_ratio": single["worst_tensor_ratio"],
            "grad_rel_err": single["grad_rel_err"],
            "f32_au_loss": [[m["au_loss"] for m in ranks[0]["f32"]],
                            [m["au_loss"] for m in single["metrics"]]],
            "vox_au_loss": [r["vox_au_loss"] for r in ranks]}


def print_tp_check(summary: dict) -> None:
    print(f"  sharded (au): {summary['sharded']}")
    print(f"  (a) flagship f32, {CHECK_F32_STEPS} steps, ranks against one process: worst "
          f"metric {summary['worst_metric_ratio']:.3g} of its tolerance; worst tensor of each "
          f"group {summary['worst_tensor_ratio']}; each player's last gradient, |g - g_one| / "
          f"|g_one| {summary['grad_rel_err']}; au_loss ranks / one process "
          f"{summary['f32_au_loss']}")
    print(f"  (b) VoxCeleb bf16 R1, B={summary['vox_b']}, {TP_STEPS} steps after one: launches a "
          f"rank "
          f"{summary['launches']}; au_loss a rank {summary['vox_au_loss']}; steps/s a rank "
          f"{[round(x, 4) for x in summary['vox_steps_per_s']]}; model-axis collectives a "
          f"step a rank {summary['collectives_a_step']}, their ms a step a rank "
          f"{[round(x, 3) for x in summary['collective_ms_a_step']]}; peak GiB a rank "
          f"{[round(x, 2) for x in summary['peak_gib']]}  [{summary['card']}]")
    print(f"  {summary['seconds']:.1f} s; "
          + ("replicated tensors bit-equal on every rank, slices on their data ranks"
             if summary["ok"] else "PROBLEMS: " + "; ".join(summary["problems"])))
    print("TP_CHECK " + json.dumps(summary), flush=True)


def parse_layout(text: str) -> tuple:
    d, m = (int(x) for x in text.lower().split("x"))
    return d, m


def scale(configs, worlds, steps: int, seed: int, out_json: str, layouts=None) -> dict:
    cards = torch.cuda.device_count()
    rows = []
    shapes = [parse_layout(x) for x in layouts] if layouts else [(w, 1) for w in worlds]
    for name in configs:
        for d, m in shapes:
            world = d * m
            if world > cards:
                print(f"  {name} on {world} cards: skipped, {cards} visible")
                continue
            warm = 3 if name == "flagship" else 2
            ranks = run({"kind": "scale", "config": name, "seed": seed, "steps": steps,
                         "warm": warm, "model_parallel": m}, world, 900.0)
            row = {"config": name, "world": world, "layout": f"{d}x{m}", "global_b": GLOBAL_B,
                   "steps_per_s": min(r["steps_per_s"] for r in ranks),
                   "peak_gib": [r["peak_gib"] for r in ranks],
                   "allreduce_ms_per_step": [r["allreduce_ms_per_step"] for r in ranks],
                   "nccl_ms_per_step": [r["nccl_ms_per_step"] for r in ranks],
                   "model_axis_ms_per_step": [r["model_axis_ms_per_step"] for r in ranks],
                   "params": ranks[0]["params"], "finite": all(r["finite"] for r in ranks)}
            rows.append(row)
            head = (f"  {name}, data {d} x model {m} on {world} cards, B={GLOBAL_B // d} a data "
                    f"rank: model-axis collectives ms a step "
                    f"{[round(x, 3) for x in row['model_axis_ms_per_step']]};" if m > 1 else
                    f"  {name} on {world} card(s), B={GLOBAL_B // world} a card:")
            print(f"{head} {row['steps_per_s']:.4f} steps/s; peak GiB a card "
                  f"{[round(x, 3) for x in row['peak_gib']]}; all-reduce ms a step "
                  f"{[round(x, 3) for x in row['allreduce_ms_per_step']]} (NCCL alone "
                  f"{[round(x, 3) for x in row['nccl_ms_per_step']]}); finite "
                  f"{row['finite']}", flush=True)
    summary = {"card": smi_line(), "torch": torch.__version__, "steps": steps, "rows": rows}
    print("DP_SCALE " + json.dumps(summary), flush=True)
    if out_json:
        Path(out_json).parent.mkdir(parents=True, exist_ok=True)
        Path(out_json).write_text(json.dumps(summary, indent=1))
    return summary


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=["check", "scale", "worker"])
    ap.add_argument("job", nargs="?", help="worker: the job's JSON")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--configs", nargs="+", default=["flagship", "vox"])
    ap.add_argument("--worlds", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--layouts", nargs="+", default=None,
                    help="data x model layouts, e.g. 1x1 2x1 2x2 4x1 (instead of --worlds)")
    ap.add_argument("--model_parallel", type=int, default=1,
                    help="check: the model axis's size (1: phase 16's data-parallel check)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--json", default="")
    args = ap.parse_args()
    if args.mode == "worker":
        worker(args.job)
        return
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    print(smi_line(), flush=True)
    if args.mode == "check":
        if args.model_parallel > 1:
            summary = tp_check(args.seed, args.model_parallel)
            print_tp_check(summary)
        else:
            summary = check(args.seed)
            print_check(summary)
        if not summary["ok"]:
            raise SystemExit(1)
    else:
        scale(args.configs, args.worlds, args.steps, args.seed, args.json, args.layouts)


if __name__ == "__main__":
    main()
