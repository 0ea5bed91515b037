"""Readings that a cell's limits are set from, on the chip at the cell's own size.

    python3 cudabench/calibrate.py --workload <cell> --seeds <first> <count>
                                   [--control N] [--fault N] [--faults a,b] [--f32 N]
                                   [--out PATH]

In one process, for each seed: the program's checked steps as a run makes them
(set-up alone, no window), the plain reference's, and the readings of
``check.py`` between them (a number's lower reading is its largest over the
seeds).  On the first ``--control`` seeds the control: the reference computed
with float8 operands (``quant="fp8"``), one precision below the
configurations' bf16, held against the f32 reference.  On the first
``--fault`` seeds each fault of ``--faults`` (``faults.py``) planted in the
program.  On the first ``--f32`` seeds the program's own f32 path, a second
witness for the reference.  A step that leaves the state unchanged reads 1 in
the change's numbers without a run.
Prints one JSON line a seed and a summary; the benchmark's own runs do not
run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cudabench import check, harness  # noqa: E402
from cudabench import weights as wmod  # noqa: E402
from cudabench.faults import FAULTS  # noqa: E402


def program_readings(spec: dict, seed: int, device, faults, f32: bool) -> tuple:
    """(init weights, batches, noise, the program's steps, {fault: its steps}, the program's
    in f32 or None)."""
    from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg

    config, traffic = spec["config"], spec["traffic"]
    game, dataset = config["game"], config["dataset"]
    data = harness.make_data(game, dataset, seed, device)
    loader = harness.make_loader(game, dataset, data, seed, device)
    init = wmod.make_weights(game, harness.sub_seed(seed, harness.WEIGHTS), device)
    zs = harness.make_noise(game, seed, traffic["checked_steps"], device)
    state = harness.build_program(game, init, seed, device)
    batches, prog = harness.program_steps(state, harness.feed(loader), zs, timg.train_step)
    del state, loader, data
    planted = {}
    for name in faults:
        state = harness.build_program(game, init, seed, device)
        with FAULTS[name]():
            _, planted[name] = harness.program_steps(state, iter(batches), zs,
                                                     timg.train_step)
        del state
    full = None
    if f32:  # the program's own f32 path: a second witness for the reference
        state = harness.build_program(dict(game, compute_dtype="float32"), init, seed, device)
        _, full = harness.program_steps(state, iter(batches), zs, timg.train_step)
        del state
    return init, batches, zs, prog, planted, full


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs=2, required=True, metavar=("FIRST", "COUNT"))
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--fault", type=int, default=3)
    ap.add_argument("--faults", default="half_loss,sign",
                    help="comma-separated names of faults.py's FAULTS")
    ap.add_argument("--f32", type=int, default=0, help="seeds on which the program runs in f32")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    spec = harness.cell_spec(args.workload)
    device = args.device
    from optimalstrategiesagainstgenerativeattacks_torch.ops.precision import exact_f32

    exact_f32()
    torch.backends.cudnn.benchmark = False
    chunk = spec["cell"].get("reference_chunk")
    game = spec["config"]["game"]
    rows = []
    first, count = args.seeds
    for i, seed in enumerate(range(first, first + count)):
        t0 = time.perf_counter()
        faults = [f for f in args.faults.split(",") if f] if i < args.fault else []
        init, batches, zs, prog, planted, full = program_readings(spec, seed, device, faults,
                                                                  i < args.f32)
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        ref = harness.reference_steps(game, init, batches, zs, device, chunk)
        t2 = time.perf_counter()
        row = {"seed": seed, "program": check.readings(prog, ref, init),
               "program_s": t1 - t0, "reference_s": t2 - t1,
               "losses": {"reference": [{k: float(v) for k, v in s.items()} for s in ref["losses"]],
                          "program": [{k: float(v) for k, v in s.items()}
                                      for s in prog["losses"]]}}
        for name, steps in planted.items():
            row[name] = check.readings(steps, ref, init)
        if full is not None:
            row["program_f32"] = check.readings(full, ref, init)
        if i < args.control:
            ctrl = harness.reference_steps(game, init, batches, zs, device, chunk, quant="fp8")
            row["control_fp8"] = check.readings(ctrl, ref, init)
            del ctrl
        row["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else 0
        print(json.dumps(row), flush=True)
        rows.append(row)
        del init, batches, zs, prog, planted, full, ref
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    summary = {"workload": args.workload, "seeds": [first, count]}
    sides = sorted({k for r in rows for k in r if isinstance(r[k], dict) and "loss" in r[k]})

    def numbers(read):
        return {k: v for k, v in read.items() if isinstance(v, float)}

    for side in sides:
        got = [numbers(r[side]) for r in rows if side in r]
        summary[side] = {k: {"max": max(g[k] for g in got), "min": min(g[k] for g in got)}
                         for k in got[0]}
    if device == "cuda":
        summary["card"] = harness.power_limit()
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"rows": rows, "summary": summary}, indent=1))


if __name__ == "__main__":
    main()
