"""The benchmark's harness: one run of one cell of ``BENCHMARK.json``.

Everything of a cell is found by name:

  workloads/<cell>.json     the cell: its configuration, traffic, chips, the
                            steps its trace holds, the reference's block of
                            episodes and the limits of its check;
  configs/<config>.json     the game's fields as the program's
                            ``ImageGameConfig`` takes them, the synthetic data
                            set, the kernels' launch sites;
  traffic/<traffic>.json    the loop and its step counts;
  loops/<loop>.py           the loop: ``run(spec, seed, seconds, trace, device,
                            t_process)`` drives set-up, window, trace and check
                            and returns what the metrics are read from;
  end_to_end/<metric>.py    and
  metrics/<metric>.py       a reader each: ``UNIT`` and ``read(ctx)``, the number
                            or None.  A metric ``<quantity>.<suffix>`` without a
                            file of its own is read by ``<quantity>.py``: the
                            same quantity in cells that report another
                            end-to-end metric.

A new cell, configuration, traffic mix, loop or metric is a new file; no file
that is there changes.  This module also holds what loops share: the seed's
sub-seeds, the synthetic data, the weights' and noise's draws, the program's
game state and the plain reference's steps.

The last line of standard output is the result; the numbers compared, with
their limits, are the last lines of standard error and the result's last key.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from cudabench.reference import game as ref_game

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PORT = "optimalstrategiesagainstgenerativeattacks_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "optimalstrategiesagainstgenerativeattacks_tpu")
SMI = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
# sub-seeds of a run's seed, one a use
DATA, WEIGHTS, NOISE, LOADER, PROGRAM_NOISE = range(5)


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def load_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str):
    """The module ``<kind>/<name>.py``; for a metric ``<quantity>.<suffix>`` without a file
    of its own, ``<kind>/<quantity>.py``."""
    path = HERE / kind / f"{name}.py"
    if not path.exists() and "." in name:
        path = HERE / kind / f"{name.rsplit('.', 1)[0]}.py"
    key = f"cudabench_{kind}_{path.stem}".replace(".", "_")
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_spec(name: str, bench: Optional[dict] = None) -> dict:
    """The cell's files and the metrics ``BENCHMARK.json`` asks of it."""
    bench = bench or json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = load_json("workloads", name)
    end_to_end = [m["name"] for m in bench["end_to_end"]
                  if name in m.get("workloads", [name])]
    per_layer = [m["name"] for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in end_to_end)]
    return {"name": name, "chips": entry["chips"], "cell": cell,
            "config_name": entry["config"], "config": load_json("configs", entry["config"]),
            "traffic": load_json("traffic", entry["traffic"]),
            "end_to_end": end_to_end, "per_layer": per_layer}


def sub_seed(seed: int, *key: int) -> int:
    """A 63-bit seed for one use of the run's seed (any whole number)."""
    words = [seed % (1 << 64), *key]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]) >> 1


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class SyntheticEpisodes:
    """The data set's shape as the program's ``DeviceEpisodicLoader`` reads it: ``m``, ``n``,
    ``si``, ``example_cnt_per_class`` and ``mirror``; the images themselves go to the loader
    as its ``data``, already on the device."""

    def __init__(self, game: dict, dataset: dict):
        self.m, self.n, self.si = game["m"], game["n"], game["k"]
        self.example_cnt_per_class = game["ds_n_examples_per_cls"]
        self.mirror = dataset["mirror"]


def make_data(game: dict, dataset: dict, seed: int, device) -> torch.Tensor:
    """uint8 images [classes, per_class, H, W, C], drawn on the device in blocks of classes.

    A class has a level and a contrast of its own and a noise template; each of its images
    is the template plus noise of +-``spread`` grey levels, clamped to [0, 255]: a class's
    images resemble one another and classes differ, as characters' and faces' do, so that
    episodes, and the players' outputs on them, differ from one another."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, DATA))
    n, t, size, ch = dataset["classes"], dataset["per_class"], game["img_size"], \
        game["img_channels"]
    spread = dataset["spread"]
    out = torch.empty((n, t, size, size, ch), dtype=torch.uint8, device=device)
    block = max(1, (1 << 26) // (t * size * size * ch))

    def draw(low, high, shape):
        return torch.randint(low, high, shape, generator=gen, device=device, dtype=torch.int16)

    for c0 in range(0, n, block):
        c = min(block, n - c0)
        level, contrast = draw(32, 224, (c, 1, 1, 1, 1)), draw(16, 129, (c, 1, 1, 1, 1))
        template = level + draw(-128, 128, (c, 1, size, size, ch)) * contrast // 128
        images = template + draw(-spread, spread + 1, (c, t, size, size, ch))
        out[c0:c0 + c] = images.clamp_(0, 255).to(torch.uint8)
    return out


def make_noise(game: dict, seed: int, steps: int, device) -> List[torch.Tensor]:
    """The impersonator's noise z [B, n, style] of each checked step, f32."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, NOISE))
    return [torch.randn((game["batch_size"], game["n"], game["style_dim"]), generator=gen,
                        device=device) for _ in range(steps)]


def program_config(game: dict, seed: int):
    from optimalstrategiesagainstgenerativeattacks_torch.utils.config import ImageGameConfig

    return ImageGameConfig(**game, seed=sub_seed(seed, LOADER))


def build_program(game: dict, weights: dict, seed: int, device):
    """The program's game state: its players, built on ``device`` and given ``weights``,
    its optimizers and schedules, and its noise generator."""
    from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg
    from optimalstrategiesagainstgenerativeattacks_torch.train.state import GameState

    cfg = program_config(game, seed)
    with torch.device(device):
        au, im = timg.build_models(cfg)
    au.load_state_dict(weights["au"], strict=True)
    im.load_state_dict(weights["im"], strict=True)
    opts = timg.make_optimizers(cfg, au, im)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, PROGRAM_NOISE))
    return GameState(cfg, au, im, *opts, gen)


def make_loader(game: dict, dataset: dict, data: torch.Tensor, seed: int, device):
    from optimalstrategiesagainstgenerativeattacks_torch.data.device_sampler import (
        DeviceEpisodicLoader,
    )

    return DeviceEpisodicLoader(SyntheticEpisodes(game, dataset), game["batch_size"],
                                seed=sub_seed(seed, LOADER), device=device, data=data)


def feed(loader):
    """The loader's batches, epoch after epoch."""
    while True:
        yield from loader


def params_of(state_or_game) -> Dict[str, Dict[str, torch.Tensor]]:
    return {p: {k: v.detach().clone() for k, v in getattr(state_or_game, p).named_parameters()}
            for p in ("au", "im")}


def adam_first_grads(state) -> Dict[str, Dict[str, torch.Tensor]]:
    """Each player's first gradient as its Adam got it: exp_avg / (1 - beta1) after one step."""
    out = {}
    for player, opt in (("au", state.opt_au), ("im", state.opt_im)):
        b1 = opt.param_groups[0]["betas"][0]
        out[player] = {k: opt.state[p]["exp_avg"] / (1.0 - b1)
                       for k, p in getattr(state, player).named_parameters()
                       if "exp_avg" in opt.state.get(p, {})}
    return out


def program_steps(state, batches_in, zs, train_step: Callable) -> tuple:
    """The program's checked steps.  ``batches_in`` yields each step's batch; returns
    (the batches, {"losses", "grads", "params"})."""
    batches, losses, grads, fake = [], [], None, None
    for i, z in enumerate(zs):
        batch = next(batches_in)
        metrics, out = train_step(state, batch, z=z)
        batches.append(batch)
        losses.append({k: metrics[k].detach().clone() for k in ("im_loss", "au_loss")})
        if i == 0:
            grads, fake = adam_first_grads(state), out.detach().clone()
    return batches, {"losses": losses, "grads": grads, "params": params_of(state),
                     "fake": fake}


def reference_steps(game: dict, weights: dict, batches, zs, device, chunk: Optional[int],
                    quant: Optional[str] = None) -> dict:
    """The plain reference's steps from ``weights`` over the same batches and noise."""
    ref_game.exact_f32()
    g = ref_game.Game(game, weights, device, quant)
    losses, grads, fake = [], None, None
    for i, (batch, z) in enumerate(zip(batches, zs)):
        loss, step_grads, fakes = ref_game.train_step(g, batch, z, chunk)
        losses.append(loss)
        if i == 0:
            grads, fake = step_grads, fakes
    return {"losses": losses, "grads": grads, "params": params_of(g), "fake": fake,
            "buffers": {p: {k: v.clone() for k, v in getattr(g, p).named_buffers()}
                        for p in ("au", "im")}}


def power_limit() -> str:
    out = subprocess.run(SMI, capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def run_cell(spec: dict, seed: int, seconds: float, trace_on: bool, device="cuda",
             t_process: Optional[float] = None) -> tuple:
    """One run of a cell by its traffic's loop; returns (the result, the last line's
    object; what the line before it reports; the check's lines for standard error)."""
    t_process = time.perf_counter() if t_process is None else t_process
    run = load_module("loops", spec["traffic"]["loop"]).run(spec, seed, seconds, trace_on,
                                                            device, t_process)
    ctx = run["ctx"]
    kind, names = ("metrics", spec["per_layer"]) if trace_on else ("end_to_end",
                                                                   spec["end_to_end"])
    metrics = {}
    for name in names:
        reader = load_module(kind, name)
        value = reader.read(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": reader.UNIT}
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": spec["chips"], "memory_peak_bytes": run["memory_peak_bytes"]}
    result = {"correct": run["correct"], "attempted": run["attempted"],
              "failed": run["failed"], "metrics": metrics, "device": dev}
    profile = ctx.get("profile")
    if trace_on and profile:
        dev["busy_s"], dev["window_s"] = profile["busy_s"], profile["window_s"]
        result["breakdown"] = {"device_ops": profile["device_ops"],
                               "idle_gaps": profile["idle_gaps"]}
    result["checks"] = run["checks"]
    info = {"cell": spec["name"], "seed": seed, **run["info"]}
    return result, info, run["lines"]


def main(argv: Optional[List[str]] = None, t_process: Optional[float] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="One run of one cell of BENCHMARK.json.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = cell_spec(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        log(f"needs {spec['chips']} CUDA device(s): torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}")
        return 2
    result, info, lines = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda",
                                   t_process)
    info["card"] = power_limit()  # name and power limit, beside every number
    print(json.dumps({"info": info}), flush=True)
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package are loaded: {found}")
        return 3
    for line in lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0
