"""Checkpoints with the reference's file-name and latest-pick contract.

Counterpart of ``optimalstrategiesagainstgenerativeattacks_tpu/train/checkpoints.py``
(contract parity with the reference's ``training/checkpoints.py:9-44`` and
``training/utils.py:160-164``): one snapshot per step named
``model_{step:08d}`` under ``<outdir>/<ckpt_dir_name>/``, and
``get_latest_ckpt`` picks the largest step from the names.  A snapshot is
one ``torch.save`` file holding global_step, last_epoch, both players'
``state_dict``s (the spectral u/v buffers included), both Adams, both
MultiStepLR schedulers where the state has them (the image game's; the
Gaussian game's has none) and the state of its generator: everything a
resumed run needs to take the same steps as one never interrupted.  In a
data-parallel run (``parallel/mesh.py``) only rank 0 writes; every rank loads.
From a state sharded over the model axis (``parallel/tensor.py``) every rank
gathers the whole arrays first and rank 0 writes them, so the file is the
one a single process writes; it loads into a whole state.
"""

from __future__ import annotations

import os
import re
from typing import Tuple

import torch

from optimalstrategiesagainstgenerativeattacks_torch.parallel.mesh import is_main
from optimalstrategiesagainstgenerativeattacks_torch.parallel.tensor import (
    gather_state,
    sharded_weights,
)

CKPT_PREFIX = "model_"
_PARTS = ("au", "im", "opt_au", "opt_im", "sched_au", "sched_im")


def _parts(state):
    return tuple(name for name in _PARTS if hasattr(state, name))


def resolve_ckpt_path(path: str, outdir: str) -> str:
    """A relative path that does not exist from the cwd is tried against the
    experiment outdir, so ``-r ckpts/model_00085000`` works from anywhere."""
    if not os.path.isabs(path) and not os.path.exists(path):
        candidate = os.path.join(outdir, path)
        if os.path.exists(candidate):
            return candidate
    return path


class CheckpointIO:
    """Save and restore the full state of either game (``train.state.GameState`` or
    ``train.state.GaussianState``)."""

    def __init__(self, checkpoint_dir: str):
        self.checkpoint_dir = os.path.abspath(checkpoint_dir)
        if is_main():
            os.makedirs(self.checkpoint_dir, exist_ok=True)

    def path_for_step(self, step: int) -> str:
        return os.path.join(self.checkpoint_dir, f"{CKPT_PREFIX}{step:08d}")

    def save(self, state, step: int, last_epoch: int = 1) -> str:
        """Write the snapshot of ``step`` (on rank 0 only; every rank calls it); returns
        its path."""
        path = self.path_for_step(step)
        sharded = sharded_weights(state.au) or sharded_weights(state.im)
        whole = gather_state(state) if sharded else {}  # a collective
        if not is_main():
            return path
        payload = {name: getattr(state, name).state_dict() for name in _parts(state)}
        payload.update(whole)
        payload.update(global_step=int(step), last_epoch=int(last_epoch),
                       generator=state.generator.get_state())
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)  # a reader sees a whole snapshot or none
        return path

    def load(self, path: str, state, players_only: bool = False) -> Tuple[int, int]:
        """Restore a snapshot into ``state`` in place; returns (global_step, last_epoch).

        ``players_only`` restores the two players (parameters and spectral
        state) and nothing else, as ``--pretrained`` does.
        """
        payload = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
        for name in ("au", "im") if players_only else _parts(state):
            getattr(state, name).load_state_dict(payload[name])
        if not players_only:
            state.generator.set_state(payload["generator"])
            state.step = payload["global_step"]
        return payload["global_step"], payload["last_epoch"]


def get_latest_ckpt(ckpt_dir_path: str) -> str:
    """Latest checkpoint path by the largest step in the name."""
    pat = re.compile(re.escape(CKPT_PREFIX) + r"(\d+)$")
    entries = []
    for name in os.listdir(ckpt_dir_path):
        m = pat.match(name)
        if m:
            entries.append((int(m.group(1)), name))
    if not entries:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir_path}")
    _, name = max(entries)
    return os.path.join(ckpt_dir_path, name)
