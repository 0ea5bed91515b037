"""The training loop: a traffic mix whose ``loop`` is ``train``.

  set-up   the port's modules are imported; the data set is drawn as uint8
           on the device from the seed and handed to the program's
           ``DeviceEpisodicLoader``; the players are built on the device and
           given the weights of ``weights.py``; the optimizers and the game
           state are the program's.  The first ``checked_steps`` steps run
           through the window's own call, ``train_step(state, next(loader))``,
           with noise z drawn by the harness, and what the check needs is
           copied out: each step's losses, the first gradient from each Adam's
           state, the weights after the last.  ``warm_steps`` more steps draw
           their noise inside the program, as the window does.  ``setup_s``
           runs from the process's start to the window's.
  window   steps back to back, no synchronize inside, until ``--seconds`` have
           passed on the host clock; then one synchronize.
  trace    (``--trace 1``) the same loop unprofiled for ``--seconds``
           (``loader_ms``, ``enqueue_ms``, ``mfu``), then ``trace_steps``
           steps under ``torch.profiler`` after one profiled warm step (the
           device metrics and the breakdown).
  check    the device's peak memory is read, the program's state freed, and
           the plain reference runs the checked steps from the same weights,
           batches and noise in blocks of episodes (``check.py``).

``run`` returns what the harness reads its metrics from (``ctx``): ``window``
(steps, seconds, the host spans, the batch), ``setup_s``, with ``--trace 1``
``unprofiled`` (the window), ``profile`` and ``flops_per_step``.
"""

from __future__ import annotations

import gc
import time

import torch

from cudabench import check, harness, trace
from cudabench import weights as wmod
from cudabench.counts.model_flops import model_flops


def run(spec: dict, seed: int, seconds: float, trace_on: bool, device, t_process: float) -> dict:
    from optimalstrategiesagainstgenerativeattacks_torch.ops.precision import exact_f32
    from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg

    cell, config, traffic = spec["cell"], spec["config"], spec["traffic"]
    game, dataset = config["game"], config["dataset"]
    parts = {"imports": time.perf_counter() - t_process}
    exact_f32()  # as the CLIs' loops: f32 products exact, no TF32
    torch.backends.cudnn.benchmark = False  # the CLI's default
    cuda = torch.device(device).type == "cuda"

    def part(name, t):
        parts[name] = time.perf_counter() - t

    t = time.perf_counter()
    data = harness.make_data(game, dataset, seed, device)
    loader = harness.make_loader(game, dataset, data, seed, device)
    batches_in = harness.feed(loader)
    part("data", t)
    t = time.perf_counter()
    init = wmod.make_weights(game, harness.sub_seed(seed, harness.WEIGHTS), device)
    zs = harness.make_noise(game, seed, traffic["checked_steps"], device)
    part("weights", t)
    t = time.perf_counter()
    state = harness.build_program(game, init, seed, device)
    part("models", t)
    t = time.perf_counter()
    batches, prog = harness.program_steps(state, batches_in, zs, timg.train_step)
    harness.sync(device)
    part("checked_steps", t)
    t = time.perf_counter()
    for _ in range(traffic["warm_steps"]):
        timg.train_step(state, next(batches_in))
    harness.sync(device)
    part("warm_up", t)
    flops = None
    if trace_on:
        t = time.perf_counter()
        flops = model_flops(spec["config_name"], game)
        part("flop_count", t)

    def steps_for(duration: float) -> dict:
        """Steps back to back for ``duration`` seconds of the host clock, then a sync."""
        steps, load_s, enqueue_s, au_losses = 0, 0.0, 0.0, []
        harness.sync(device)
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            batch = next(batches_in)
            b = time.perf_counter()
            metrics, _ = timg.train_step(state, batch)
            c = time.perf_counter()
            load_s, enqueue_s, steps = load_s + b - a, enqueue_s + c - b, steps + 1
            au_losses.append(metrics["au_loss"])
            if c - t0 >= duration:
                break
        harness.sync(device)
        return {"steps": steps, "seconds": time.perf_counter() - t0, "loader_s": load_s,
                "enqueue_s": enqueue_s, "batch_size": game["batch_size"],
                "au_losses": au_losses}

    setup_s = time.perf_counter() - t_process
    window = steps_for(seconds)
    ctx = {"config": config, "window": window, "setup_s": setup_s}
    if trace_on:
        from torch.profiler import ProfilerActivity, profile as profiler, record_function

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profiler(activities=activities) as prof:
            timg.train_step(state, next(batches_in))
            harness.sync(device)
            with record_function(trace.WINDOW):
                for _ in range(cell["trace_steps"]):
                    timg.train_step(state, next(batches_in))
                harness.sync(device)
        profile = trace.read_profile(prof, cell["trace_steps"]) if cuda else {}
        del prof
        ctx.update(unprofiled=window, profile=profile, flops_per_step=flops)
    failed = torch.isfinite(torch.stack(window.pop("au_losses"))).tolist().count(False)
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    del state, loader, batches_in, data
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = harness.reference_steps(game, init, batches, zs, device, cell.get("reference_chunk"))
    read = check.readings(prog, ref, init)
    reference_s = time.perf_counter() - t

    info = {"setup_parts_s": parts, "setup_s": setup_s, "window_steps": window["steps"],
            "window_s": window["seconds"], "reference_s": reference_s,
            "leaves_left_out_of_change": read["left_out"],
            "readings": {k: v for k, v in read.items() if isinstance(v, float)}}
    profile = ctx.get("profile")
    if profile:
        info["device_ms_per_step_by_category"] = {
            k: 1e3 * v / profile["steps"] for k, v in profile["categories"].items()}
        info["device_activities_per_step"] = profile["activities"] / profile["steps"]
    if trace_on:
        info["model_flops_per_step"] = flops
    limits = cell["limits"]
    return {"ctx": ctx, "correct": check.verdict(read, limits) and failed == 0,
            "attempted": window["steps"], "failed": failed, "memory_peak_bytes": memory_peak,
            "info": info, "checks": check.check_record(read, limits),
            "lines": check.check_lines(read, limits)}
