"""Training across cards: one process a card, a ``(data, model)`` layout of the ranks.

Counterpart of ``optimalstrategiesagainstgenerativeattacks_tpu/parallel/mesh.py``.
The JAX package shards each batch over a ``('data', 'model')`` mesh of every
visible device and lets XLA's SPMD partitioner insert the gradient and metric
means and, for matrices ``param_shardings`` splits over the model axis, the
gathers.  The port runs one process a card under ``torch.distributed`` (NCCL
on the card, gloo on the CPU) and takes the same steps itself.

``create_mesh(model_parallel)`` lays the ranks out as the JAX package's
``np.array(devices).reshape(n // mp, mp)``: rank r has data index r // mp and
model index r % mp; the ranks of one model group are a run of consecutive
ranks, those of one data group a stride.  Without a call the layout is the
data axis over the whole world.  Everything below works on the data axis:

  * every rank holds the whole global batch's schedule and assembles, or
    draws, only its data index's contiguous slice (``shard_bounds``,
    ``shard_batch``, ``randn_slice``), so the slices concatenate to what one
    process gets at the global batch, and the ranks of a model group take the
    same rows and the same noise;
  * each player's gradients are flattened into one buffer, all-reduced and
    divided by the data axis's size before its Adam step
    (``all_reduce_grads_``): local means over equal shards average to the
    global mean, and every rank takes the same step from the same reduced
    gradient, so the parameters and the spectral u/v stay equal across ranks;
  * metrics are means of equal shards' means (``all_reduce_mean``).

The model axis itself (the sharded layers, their collectives, the state
across the layout) is ``parallel/tensor.py``; ``param_shardings`` here is the
JAX package's rule over the port's parameters.

The layout is process state, as the process group it is built on is: the
steps read it where they shard a batch or draw noise, so no caller threads a
mesh through them (the JAX package passes one to ``make_train_step``).

The players are not wrapped in ``DistributedDataParallel``: the steps take
their gradients with ``torch.autograd.grad``, R1 differentiates twice, and
the frozen opponent sits in the same graph, none of which DDP's reducer sees.

Launch: under ``torchrun`` (or any launcher that sets ``RANK`` and
``WORLD_SIZE``) each process joins the group the environment describes
(``process_group``).  Run plainly with k > 1 visible cards, a CLI starts k
workers of itself (``spawn_workers``) with the variables torchrun would set.
With one card, or on the CPU without a launcher, no group exists and every
function here is the identity.

``adjust_batch_size`` keeps the reference's divisibility contract
(``training/utils.py:167-171``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import socket
import subprocess
import sys
import time
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def adjust_batch_size(ds_length: int, curr_batch_size: int, n_devices: int) -> int:
    """Largest batch <= min(batch, ds_length) divisible by n_devices
    (``training/utils.py:167-171``)."""
    batch_size = min(curr_batch_size, ds_length)
    batch_size = int(n_devices * math.floor(batch_size / n_devices))
    if batch_size <= 0:
        raise ValueError(f"no batch of at most {min(curr_batch_size, ds_length)} divides "
                         f"over {n_devices} ranks")
    return batch_size


def world_size() -> int:
    """Ranks in the process group; 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_main() -> bool:
    """Rank 0: the one that writes logs, images, checkpoints and args.json."""
    return rank() == 0


def launched() -> bool:
    """True when a launcher (torchrun, ``spawn_workers``) set this process's rank."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_process(device, backend: Optional[str] = None,
                 init_method: str = "env://") -> torch.device:
    """Join the group that ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` describe;
    returns this rank's device.

    ``device`` "cuda" is the card ``LOCAL_RANK``, made current before anything
    else touches a card (Triton launches on the current card); "cuda:i" pins
    one (ranks sharing a card); "cpu".  The backend is NCCL on a card and gloo
    on the CPU unless ``backend`` names one.
    """
    local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]),
                            **({"device_id": device} if backend == "nccl" else {}))
    return device


def shutdown() -> None:
    global _MESH
    _MESH = None
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of the layout: this rank's index along it, the axis's size, and
    the process group of the ranks that differ only in this index (None: the
    default group, the whole world)."""

    rank: int = 0
    size: int = 1
    group: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ``(data, model)`` layout of the ranks (``create_mesh``)."""

    data: Axis
    model: Axis

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data.size, "model": self.model.size}


_MESH: Optional[Mesh] = None


def create_mesh(model_parallel: int = 1) -> Mesh:
    """Lay the ranks of the process group out as ``(world // model_parallel,
    model_parallel)``, the JAX package's ``create_mesh`` order, and make it the
    layout every function here and in ``parallel/tensor.py`` reads.

    With ``model_parallel`` > 1 every rank builds every group with
    ``dist.new_group``, in the same order: the model groups (runs of
    consecutive ranks), then the data groups (strides).  With 1 the data axis
    is the default group, so every collective is the one data parallel alone
    makes."""
    global _MESH
    world, r = world_size(), rank()
    mp = int(model_parallel)
    if mp < 1 or world % mp:
        raise ValueError(f"{world} ranks not divisible by model_parallel={mp}")
    if mp == 1:
        mesh = Mesh(Axis(r, world, None), Axis())
    else:
        groups = {}
        for d in range(world // mp):
            ranks = list(range(d * mp, (d + 1) * mp))
            group = dist.new_group(ranks)
            if r in ranks:
                groups["model"] = group
        for m in range(mp):
            ranks = list(range(m, world, mp))
            group = dist.new_group(ranks)
            if r in ranks:
                groups["data"] = group
        mesh = Mesh(Axis(r // mp, world // mp, groups["data"]),
                    Axis(r % mp, mp, groups["model"]))
    _MESH = mesh
    return mesh


def current_mesh() -> Mesh:
    """The layout of ``create_mesh``; without one, the data axis over the world."""
    return _MESH if _MESH is not None else Mesh(Axis(rank(), world_size(), None), Axis())


def data_axis() -> Axis:
    return current_mesh().data


def model_axis() -> Axis:
    return current_mesh().model


def param_shardings(module: nn.Module, mesh: Mesh,
                    min_size: int = 1024) -> Dict[str, Optional[int]]:
    """Each parameter's name -> the dim split over ``mesh``'s model axis, or None
    (replicated): the JAX package's ``param_shardings`` over the port's names.

    JAX splits the trailing axis of a parameter of ndim >= 2 when it is at
    least ``min_size`` and divides by the model axis's size.  That axis is a
    Dense or conv kernel's output features or channels, dim 0 of the port's
    [out, in] and [out, in, kh, kw] weights, and the layers with a sharded
    forward (those with a ``model_axis`` attribute: ``nn/blocks.py`` Dense,
    Conv, SNConv) are every such kernel of the image game.  Biases are 1-D
    here and stay whole (the JAX tree stacks the encoder pair's and the
    AdaIN res blocks' into 2-D leaves, which its rule may split).
    """
    mp = mesh.model.size
    out: Dict[str, Optional[int]] = {name: None for name, _ in module.named_parameters()}
    if mp == 1:
        return out
    for prefix, m in module.named_modules():
        if not hasattr(m, "model_axis"):
            continue
        w = m.weight
        if w.ndim >= 2 and w.shape[0] >= min_size and w.shape[0] % mp == 0:
            out[f"{prefix}.weight" if prefix else "weight"] = 0
    return out


@contextlib.contextmanager
def process_group(device) -> Iterator[torch.device]:
    """Inside a launcher: join its group on this rank's device, print the world
    once, and leave the group at exit.  Otherwise: the device as given, no group."""
    if not launched():
        yield torch.device(device)
        return
    device = init_process(device)
    try:
        if is_main():
            print(f"data parallel: {world_size()} ranks, backend {dist.get_backend()}, "
                  f"rank 0 on {device}", flush=True)
        yield device
    finally:
        shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_workers(module: str, argv: Optional[Sequence[str]], device: str) -> bool:
    """With ``device`` "cuda", no launcher and k > 1 visible cards: run k workers
    ``python -m module argv``, one a card (``run_workers``), and return True;
    else return False at once."""
    if device != "cuda" or launched() or torch.cuda.device_count() < 2:
        return False
    world = torch.cuda.device_count()
    print(f"data parallel: starting {world} workers, one a card", flush=True)
    run_workers([sys.executable, "-m", module,
                 *(sys.argv[1:] if argv is None else argv)], world)
    return True


def run_workers(cmd: Sequence[str], world: int, timeout: Optional[float] = None) -> None:
    """Run ``world`` copies of ``cmd`` on this host with the variables torchrun
    sets (``RANK`` = ``LOCAL_RANK`` = 0 .. world - 1, ``WORLD_SIZE``, a free
    ``MASTER_PORT`` on 127.0.0.1) and wait for them, at most ``timeout``
    seconds when given.  A worker that fails, or the timeout, stops the others
    and raises ``SystemExit``; on an interrupt the workers, which received it
    too, get a minute to save."""
    deadline = None if timeout is None else time.monotonic() + timeout
    base = dict(os.environ, WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                PYTHONPATH=os.pathsep.join(filter(None, [_PKG_PARENT,
                                                         os.environ.get("PYTHONPATH")])))
    procs = []
    try:
        for r in range(world):
            procs.append(subprocess.Popen(list(cmd), env=dict(base, RANK=str(r),
                                                              LOCAL_RANK=str(r))))
        while True:
            codes = [p.poll() for p in procs]
            failed = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                raise SystemExit(f"data parallel: rank {failed[0][0]} exited {failed[0][1]}")
            if all(c == 0 for c in codes):
                return
            if deadline is not None and time.monotonic() > deadline:
                raise SystemExit(f"data parallel: the workers ran past {timeout} s")
            time.sleep(0.2)
    except KeyboardInterrupt:
        _wait(procs, 60.0)
        raise
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        _wait(procs, 30.0)


def _wait(procs, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def shard_bounds(n: int, r: Optional[int] = None, world: Optional[int] = None) -> Tuple[int, int]:
    """[lo, hi) of data index ``r``'s contiguous slice of a global batch of ``n``
    over ``world`` shards (this rank's data index and the data axis's size by
    default); ``n`` must divide evenly."""
    data = data_axis()
    r = data.rank if r is None else r
    world = data.size if world is None else world
    if n % world:
        raise ValueError(f"a batch of {n} does not divide over {world} ranks")
    b = n // world
    return r * b, (r + 1) * b


def shard_batch(batch):
    """This rank's slice of a global batch (its data index's): a tensor or array,
    or a dict of them, sliced on the leading axis."""
    if data_axis().size == 1:
        return batch
    if isinstance(batch, dict):
        lo, hi = shard_bounds(len(next(iter(batch.values()))))
        return {k: v[lo:hi] for k, v in batch.items()}
    lo, hi = shard_bounds(len(batch))
    return batch[lo:hi]


def randn_slice(shape: Sequence[int], generator: Optional[torch.Generator], device,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """This rank's slice [shape[0], ...] of one draw of the global
    [data size * shape[0], ...] from ``generator``, at its data index: every
    rank draws the whole, so the generators stay in step, the slices
    concatenate to one process's draw, and a model group's ranks hold the
    same rows.  Without a group, the plain ``torch.randn(shape)``."""
    world = data_axis().size
    if world == 1:
        return torch.randn(tuple(shape), generator=generator, device=device, dtype=dtype)
    full = torch.randn((world * shape[0], *shape[1:]), generator=generator, device=device,
                       dtype=dtype)
    lo, hi = shard_bounds(len(full), world=world)
    return full[lo:hi]


def all_reduce_grads_(params: Sequence[torch.Tensor], sharded: Sequence[torch.Tensor] = ()) -> None:
    """Replace each parameter's ``.grad`` by its mean over the data axis: the
    gradients of a dtype flattened into one buffer, one ``all_reduce``, divided
    by the axis's size; the new ``.grad``s are views of the buffer.  Every rank
    gets the same bits (the reduction is computed once and broadcast).

    With a model axis, ``sharded`` are the parameters that hold this rank's
    slice (``parallel/tensor.py``): they are reduced over the data group.  The
    replicated ones are reduced over the whole world and divided by its size.
    Their copies on a model group's ranks are equal up to the card's
    nondeterministic kernels (cuDNN's backward algorithms), so this is the
    data axis's mean, rounded in another order, and it keeps the copies equal
    bit for bit whatever the kernels did."""
    world = world_size()
    if world == 1:
        return
    model = model_axis()
    if model.size == 1:
        _reduce_mean_(params, None, world)
        return
    data = data_axis()
    ids = {id(p) for p in sharded}
    if data.size > 1:
        _reduce_mean_([p for p in params if id(p) in ids], data.group, data.size)
    _reduce_mean_([p for p in params if id(p) not in ids], None, world)


def _reduce_mean_(params: Sequence[torch.Tensor], process_group, size: int) -> None:
    by_dtype: Dict[torch.dtype, list] = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p)
    for group in by_dtype.values():
        flat = torch.cat([p.grad.reshape(-1) for p in group])
        dist.all_reduce(flat, group=process_group)
        flat.div_(size)
        for p, g in zip(group, flat.split([p.numel() for p in group])):
            p.grad = g.view_as(p)


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the data axis (``x`` itself without one)."""
    data = data_axis()
    if data.size == 1:
        return x
    x = x.clone()
    dist.all_reduce(x, group=data.group)
    return x / data.size


def all_reduce_mean_dict(values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Means over the data axis of a dict of 0-dim tensors, in one ``all_reduce``."""
    if data_axis().size == 1:
        return values
    stacked = all_reduce_mean(torch.stack([v.float() for v in values.values()]))
    return dict(zip(values, stacked.unbind()))
