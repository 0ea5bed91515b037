#!/usr/bin/env python
"""Sweep the AdaIN forward kernel's tiles at the flagship sites, on the GPU.

For each AdaIN site of the flagship train step, in bf16, launches the
forward kernel (``kernels/adain.py``) with each tile that ``tile_config``
gives for 32, 64 and 128 elements of x a thread on 1, 2, 4 and 8 warps, and
with the loop over H*W of the tiles that predate the resident tile (4 warps,
``_blocks``).  Each tile is checked against ``ada_in_ref`` at
``chip_smoke.py``'s bf16 bar, then timed as ``chip_smoke.py`` phase 3 times
a kernel: device time from torch.profiler's CUDA records, each call after a
128 MB write that evicts L2, median of 20 calls.  Prints, per site and tile,
the mode, tile, warps, elements a thread, programs, time and share of the
bound, and marks the planner's own tile and the fastest.

    python scripts/torch_adain_tiles.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from optimalstrategiesagainstgenerativeattacks_torch.kernels import adain as k1  # noqa: E402

PER_THREAD = (32, 64, 128)
WARPS = (1, 2, 4, 8)


def candidates(b: int, hw: int, c: int) -> dict:
    """{description: plan}: the planner's tile, the swept tiles and the loop."""
    plans = [k1.tile_config(b, hw, c, k1.PER_THREAD["fwd"])]
    plans += [k1.tile_config(b, hw, c, (p, p), warps=w) for p in PER_THREAD for w in WARPS]
    block_hw, block_c = k1._blocks(hw, c)
    plans.append(dict(MODE=2, grid=(b, -(-c // block_c)), BLOCK_B=1, BLOCK_HW=block_hw,
                      BLOCK_C=block_c, num_warps=4))
    return {cs.tile_text(p): p for p in plans}  # equal plans collapse to one


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    print(cs.smi_line())
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = cs.DeviceTimer()
    atol, rtol = cs.TOL[torch.bfloat16]
    sites = []
    for (b, c, h, w), per_step in cs.ADAIN_SITES.items():
        x = torch.randn(b, c, h, w, generator=gen, device="cuda").to(torch.bfloat16)
        x = x.contiguous(memory_format=torch.channels_last)
        ms = torch.randn(b, c, generator=gen, device="cuda").to(torch.bfloat16)
        ss = torch.randn(b, c, generator=gen, device="cuda").to(torch.bfloat16)
        ref = k1.ada_in_ref(x, ms, ss)
        plans = candidates(b, h * w, c)
        for name, plan in plans.items():
            cs.compare(f"[{b},{h},{w},{c}] {name}", k1.ada_in_fwd_cuda(x, ms, ss, tile=plan), ref,
                       atol, rtol)
            timer.add(f"{(b, h, w, c)} {name}",
                      lambda x=x, ms=ms, ss=ss, plan=plan: k1.ada_in_fwd_cuda(x, ms, ss, tile=plan))
        sites.append(((b, h, w, c), per_step, plans))
    print("timing (device time, L2 evicted before each call)", flush=True)
    t = timer.run()
    for site, per_step, plans in sites:
        bound_ms, _ = cs.bound(k1.ada_in_fwd_bytes(*site, torch.bfloat16),
                               k1.ada_in_fwd_flops(*site), "f32")
        chosen = next(iter(plans))
        times = {name: t[f"{site} {name}"][0] for name in plans}
        best = min(times, key=times.get)
        print(f"site [B',H,W,C] {list(site)} (x{per_step} per step), bound {bound_ms * 1e3:.2f} us")
        for name, ms_ in times.items():
            mark = ("  <- planner" if name == chosen else "") + ("  <- fastest" if name == best else "")
            print(f"  {name}: {ms_ * 1e3:8.2f} us, share {bound_ms / ms_:.3f}{mark}")


if __name__ == "__main__":
    main()
