"""The players' weights, made on the device from a seed in a few large draws.

The frozen reference (``cudabench/reference/models.py``) names every leaf and
says how it is drawn; the same dict loads into the program's players and into
the reference's.

  * a conv or linear with torch's default init: weight and bias
    U(-1/sqrt(fan_in), 1/sqrt(fan_in));
  * the head's linears (kaiming, a = 0.2): weight N(0, 2 / ((1 + a^2) fan_in)),
    zero bias;
  * an instance norm's affine N(1, 0.5^2) and N(0, 0.5^2), an attention's gamma
    N(0, 0.5^2): at init they are (1, 0) and 0, and the attention would add
    nothing to its output nor reach its parameters' gradient;
  * an SN conv's u a unit normal vector, v = l2n(W^T u), as the game inits them.

One uniform draw of every uniform leaf and one normal draw of every normal leaf,
each a flat tensor from one ``torch.Generator`` on the device, then a scale per
leaf.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from cudabench.reference import models as ref


def _plan(module: torch.nn.Module):
    """[(name, kind, scale, shift)] of every parameter and buffer; kind "u" (uniform),
    "n" (normal), "zero" or "uv" (an SN conv's vectors, made after its weight)."""
    plan = []
    for prefix, m in module.named_modules():
        dot = f"{prefix}." if prefix else ""
        if isinstance(m, (ref.SNConv, ref.Dense)):
            fan_in = m.weight[0].numel()
            if getattr(m, "init", "uniform") == "kaiming":
                plan += [(dot + "weight", "n", math.sqrt(2.0 / (1.04 * fan_in)), 0.0),
                         (dot + "bias", "zero", 0.0, 0.0)]
            else:
                bound = 1.0 / math.sqrt(fan_in)
                plan += [(dot + "weight", "u", bound, 0.0), (dot + "bias", "u", bound, 0.0)]
            if isinstance(m, ref.SNConv):
                plan.append((dot + "u", "uv", 1.0, 0.0))
        elif isinstance(m, ref.InstanceNorm):
            plan += [(dot + "weight", "n", 0.5, 1.0), (dot + "bias", "n", 0.5, 0.0)]
        elif isinstance(m, ref.SelfAttention):
            plan.append((dot + "gamma", "n", 0.5, 0.0))
    return plan


@torch.no_grad()
def make_weights(game: dict, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"au": state dict, "im": state dict} of a configuration's players, f32 on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device("meta"):
        au, im = ref.players(game)
    out = {}
    for player, module in (("au", au), ("im", im)):
        shapes = {k: v.shape for k, v in module.state_dict().items()}
        plan = _plan(module)
        counts = {kind: sum(shapes[name].numel() for name, k, _, _ in plan if k == kind)
                  for kind in ("u", "n")}
        counts["n"] += sum(shapes[name].numel() for name, k, _, _ in plan if k == "uv")
        flat = {"u": torch.empty(counts["u"], device=device).uniform_(-1.0, 1.0, generator=gen),
                "n": torch.randn(counts["n"], device=device, generator=gen)}
        offset = {"u": 0, "n": 0}
        sd = {}
        for name, kind, scale, shift in plan:
            shape = shapes[name]
            if kind == "zero":
                sd[name] = torch.zeros(shape, device=device)
                continue
            src = "u" if kind == "u" else "n"
            t = flat[src][offset[src]:offset[src] + shape.numel()].view(shape)
            offset[src] += shape.numel()
            if kind == "uv":
                prefix = name[:-1]
                w = sd[prefix + "weight"]
                u = ref.l2n(t)
                sd[name] = u
                sd[prefix + "v"] = ref.l2n(w.reshape(w.shape[0], -1).t() @ u)
            else:
                sd[name] = t * scale + shift if (scale, shift) != (1.0, 0.0) else t
        missing = set(shapes) - set(sd)
        if missing:
            raise ValueError(f"no init for {sorted(missing)[:5]}")
        out[player] = {k: sd[k].contiguous() for k in shapes}
    return out
