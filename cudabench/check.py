"""The comparison that decides ``correct`` for a training cell.

The program's first three steps (set-up drives them through the window's own
call and feed) are held against the plain reference's three steps from the
same weights, batches and noise.  The numbers (``readings``):

  * ``loss``: the largest relative gap of a step's loss, the impersonator's and
    the authenticator's, over the three steps, |prog - ref| / |ref|;
    ``loss_first`` the same of the first step alone;
  * the first gradient as each Adam got it (the program's from its state after
    one step, exp_avg / (1 - beta1)), leaf by leaf: the gap between the
    program's norm of the leaf and the reference's, over the larger of the
    reference's norm of that leaf and of the player's median leaf.  ``grad``
    is the worst leaf's gap, ``grad_median`` the median leaf's;
    ``grad_diff_median`` the median leaf's norm of the difference over the
    same floor;
  * the change of each leaf over the three steps, the same way: ``change`` the
    worst leaf's gap, ``change_median`` the median leaf's.  Leaves whose
    reference first gradient is under a thousandth of the player's median
    leaf's (nought to rounding, as the key bias under the attention's softmax)
    move by round-off alone and are left out;
  * ``fake_first``: the first step's fakes, the impersonator's forward that the
    step returns, |prog - ref| / |ref| over the whole batch.

Each number also comes per player (``.au``, ``.im``) or per loss (``.au_loss``,
``.im_loss``).

A cell compares the numbers its file gives a limit, and is correct when each
is finite and at or under its limit.  A missing Adam state (the step never
reached the optimizer) reads as a zero gradient.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

LIVE_SHARE = 1e-3


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def _median(values: List[float]) -> float:
    s = sorted(values)
    mid = len(s) // 2
    return s[mid] if len(s) % 2 else 0.5 * (s[mid - 1] + s[mid])


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def _leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> tuple:
    """({leaf: gap of norms}, {leaf: norm of the difference}), each over the larger of
    the leaf's reference norm and the median leaf's; a leaf the program lacks reads 0."""
    r = {k: _norm(v) for k, v in ref.items()}
    floor = _median(list(r.values()))
    gaps, diffs = {}, {}
    for k, v in ref.items():
        scale = max(r[k], floor, 1e-300)
        p = prog.get(k)
        gaps[k] = _finite(abs((_norm(p) if p is not None else 0.0) - r[k]) / scale)
        diffs[k] = _finite((_norm(p - v) if p is not None else r[k]) / scale)
    return gaps, diffs


def readings(prog: dict, ref: dict, init: Dict[str, Dict[str, torch.Tensor]]) -> dict:
    """The numbers of ``prog`` against ``ref``.

    Each side: {"losses": [{"im_loss": 0-dim, "au_loss": 0-dim}, ...],
    "grads": {player: {leaf: first gradient}}, "params": {player: {leaf: after the
    steps}}}; ``init`` the players' weights before the first step."""
    steps = [{k: _finite(abs(float(p[k]) - float(r[k])) / max(abs(float(r[k])), 1e-300))
              for k in r} for p, r in zip(prog["losses"], ref["losses"])]
    out = {"loss": max(g for s in steps for g in s.values()),
           "loss_first": max(steps[0].values()), "loss_steps": steps,
           "where": {}, "left_out": 0}
    for key in ref["losses"][0]:
        out[f"loss_first.{key}"] = steps[0][key]
        out[f"loss.{key}"] = max(s[key] for s in steps)
    grads, diffs, changes, change_diffs = {}, {}, {}, {}
    for player, ref_grads in ref["grads"].items():
        gaps, diff = _leaf_gaps(prog["grads"].get(player, {}), ref_grads)
        grads.update({f"{player}.{k}": g for k, g in gaps.items()})
        diffs.update({f"{player}.{k}": d for k, d in diff.items()})
        floor = LIVE_SHARE * _median([_norm(v) for v in ref_grads.values()])
        live = [k for k, v in ref_grads.items() if _norm(v) >= floor]
        out["left_out"] += len(ref_grads) - len(live)
        moved, moved_diff = _leaf_gaps(
            {k: prog["params"][player][k] - init[player][k] for k in live},
            {k: ref["params"][player][k] - init[player][k] for k in live})
        changes.update({f"{player}.{k}": g for k, g in moved.items()})
        change_diffs.update({f"{player}.{k}": d for k, d in moved_diff.items()})
        out[f"grad_median.{player}"] = _median(list(gaps.values()))
        out[f"grad_diff_median.{player}"] = _median(list(diff.values()))
        out[f"change_median.{player}"] = _median(list(moved.values()))
        out[f"change_diff_median.{player}"] = _median(list(moved_diff.values()))
    for name, gaps in (("grad", grads), ("change", changes)):
        worst = max(gaps, key=gaps.get)
        out[name], out["where"][name] = gaps[worst], worst
        out[f"{name}_median"] = _median(list(gaps.values()))
    out["grad_diff_median"] = _median(list(diffs.values()))
    out["change_diff_median"] = _median(list(change_diffs.values()))
    out["fake_first"] = fake_gap(prog["fake"], ref["fake"])
    return out


def fake_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """|prog - ref| / |ref| of the first step's fakes [B, n, H, W, C]; episodes the program
    did not produce count with their whole norm."""
    rows = min(prog.shape[0], ref.shape[0])
    diff = _norm(prog[:rows].double() - ref[:rows].double()) ** 2 + _norm(ref[rows:]) ** 2
    return _finite(math.sqrt(diff) / max(_norm(ref), 1e-300))


def verdict(read: dict, limits: dict) -> bool:
    return all(math.isfinite(read[k]) and read[k] <= limit for k, limit in limits.items())


def check_lines(read: dict, limits: dict) -> List[str]:
    return [f"check {k}: {read[k]!r} limit {limit!r}"
            + (f" (worst leaf {read['where'][k]})" if k in read["where"] else "")
            for k, limit in limits.items()]


def check_record(read: dict, limits: dict) -> dict:
    return {k: {"value": read[k], "limit": limit} for k, limit in limits.items()}
