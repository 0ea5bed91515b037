"""Weight transplant between the JAX reference's trees and this package.

The reference keeps a model as two Flax trees, ``params`` and a state
collection: ``spectral`` (u/v power-iteration vectors) for the game's
players, ``batch_stats`` (BatchNorm's running mean/var) for the baseline
authenticators; given here as nested dicts of numpy arrays.  The port keeps
the same tensors in one ``state_dict`` whose keys follow the Flax names.
The rules:

  * conv ``kernel`` HWIO [kh, kw, in, out]  <->  ``weight`` OIHW [out, in, kh, kw];
  * ``Dense`` ``kernel`` [in, out]           <->  ``weight`` [out, in] (the ArcFace
    head's [emb, classes] kernel included);
  * ``Dense_<i>`` inside an MLP              <->  ``layers.<i>``;
  * InstanceNorm and BatchNorm ``scale``     <->  ``weight``;
  * BatchNorm ``mean`` / ``var``             <->  ``running_mean`` / ``running_var``;
  * ``bias``, ``gamma``, the PReLU ``alpha`` and the spectral ``u`` / ``v`` keep
    their names (u, v are buffers on the port's side);
  * ``encoders/enc/*`` stacked on axis 0     <->  ``encoders.src.*`` (index 0)
    and ``encoders.env.*`` (index 1);
  * ``.../res_scan/block/*`` stacked on axis 0 <-> ``.../res_0.*`` .. ``res_<n-1>.*``.

Both stacked layouts are the reference's defaults (``unroll_encoder_pair``
and ``scan_adain_blocks`` keep the stacked parameters), so checkpoints of the
default config map through these rules.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_PAIR = ("src", "env")
_DENSE = re.compile(r"Dense_(\d+)$")
_RES = re.compile(r"res_(\d+)$")
_BN_STATS = ("mean", "var")
_STATE_LEAVES = ("u", "v") + _BN_STATS  # leaves of the state collection


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _emit(path: Tuple[str, ...], arr: np.ndarray, out: Dict[str, np.ndarray]) -> None:
    if path[:2] == ("encoders", "enc"):
        for i, name in enumerate(_PAIR):
            _emit(("encoders", name) + path[2:], arr[i], out)
        return
    if "res_scan" in path:
        j = path.index("res_scan")
        if path[j + 1] != "block":
            raise KeyError(f"unexpected scan layout at {'/'.join(path)}")
        for i in range(arr.shape[0]):
            _emit(path[:j] + (f"res_{i}",) + path[j + 2:], arr[i], out)
        return
    mods = []
    for p in path[:-1]:
        m = _DENSE.match(p)
        mods += ["layers", m.group(1)] if m else [p]
    leaf = path[-1]
    if leaf == "kernel":
        leaf = "weight"
        arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
    elif leaf == "scale":
        leaf = "weight"
    elif leaf in _BN_STATS:
        leaf = "running_" + leaf
    out[".".join(mods + [leaf])] = np.ascontiguousarray(arr, dtype=np.float32)


def flax_to_state_dict(params: Mapping, state: Mapping) -> Dict[str, np.ndarray]:
    """Flax ``params`` + state (``spectral`` or ``batch_stats``) trees -> the port's
    state_dict (numpy values)."""
    out: Dict[str, np.ndarray] = {}
    for tree in (params, state):
        for path, arr in _flatten(tree):
            _emit(path, arr, out)
    return out


def load_flax(module: torch.nn.Module, params: Mapping, state: Mapping) -> None:
    """Copy the reference's trees into ``module`` (strict: every key must match)."""
    sd = {k: torch.tensor(v) for k, v in flax_to_state_dict(params, state).items()}
    module.load_state_dict(sd, strict=True)


def _set(tree: dict, path: Tuple[str, ...], value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def state_dict_to_flax(state_dict: Mapping) -> Tuple[dict, dict]:
    """The port's state_dict -> (params, state) nested dicts of numpy arrays, in the
    reference's default (stacked) layout; state is ``spectral`` or ``batch_stats``."""
    stacks: Dict[Tuple[str, ...], Dict[int, np.ndarray]] = {}
    plain: Dict[Tuple[str, ...], np.ndarray] = {}
    for key, value in state_dict.items():
        arr = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
        parts = key.split(".")
        leaf = parts[-1]
        if leaf == "weight":
            if arr.ndim == 4:
                leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)
            elif arr.ndim == 2:
                leaf, arr = "kernel", arr.T
            else:
                leaf = "scale"
        elif leaf in ("running_mean", "running_var"):
            leaf = leaf[len("running_"):]
        path, index, i = [], None, 0
        mods = parts[:-1]
        while i < len(mods):
            p = mods[i]
            if p == "layers" and i + 1 < len(mods) and mods[i + 1].isdigit():
                path.append(f"Dense_{mods[i + 1]}")
                i += 2
                continue
            if path == ["encoders"] and p in _PAIR:
                path.append("enc")
                index = _PAIR.index(p)
            elif _RES.match(p) and path and path[-1] == "adain_res_block":
                path += ["res_scan", "block"]
                index = int(_RES.match(p).group(1))
            else:
                path.append(p)
            i += 1
        full = tuple(path) + (leaf,)
        arr = np.ascontiguousarray(arr, dtype=np.float32)
        if index is None:
            plain[full] = arr
        else:
            stacks.setdefault(full, {})[index] = arr
    params: dict = {}
    state: dict = {}
    items = list(plain.items()) + [
        (p, np.stack([d[i] for i in sorted(d)])) for p, d in stacks.items()
    ]
    for path, arr in items:
        _set(state if path[-1] in _STATE_LEAVES else params, path, arr)
    return params, state
