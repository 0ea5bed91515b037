"""Tensor parallel over the mesh's model axis: collectives, sharded layers, state.

Counterpart of the model axis of
``optimalstrategiesagainstgenerativeattacks_tpu/parallel/mesh.py``: where the
JAX package puts a kernel on ``param_shardings``' ``P(..., 'model')`` and lets
XLA insert the collectives, the port holds that kernel's rows on each rank of
a model group and runs them itself (Megatron's column-parallel layer):

  * a sharded ``Dense``, ``Conv`` or ``SNConv`` (``nn/blocks.py``) reads its
    whole input through ``copy_to_model`` (identity; the backward sums the
    ranks' partial input gradients; each channel part of an ``SNConv``'s tuple
    input on its own), computes its slice of the output features or channels
    with its slice of the whole bias, in the unsharded layer's order of
    roundings (an ``SNConv``'s folds act on this rank's rows), and gathers the
    slices (``gather_from_model``; ``SNConv(f32_out)`` gathers its f32 sum).
    Everything after the gather runs whole on every rank of the model group,
    the three kernels included;
  * the whole bias enters through ``split_to_model``, whose backward gathers:
    its gradient is made complete on every model rank inside the backward,
    where the slices' gradients are, and needs no step of its own;
  * a spectral norm over a row-sharded W keeps u and v whole
    (``ops/spectral.py``): sigma = sum over the model group of u_m^T W_m v,
    read back into every rank's rows through ``copy_to_model``, because each
    rank's use of sigma sees only its own slice of the output.

Each collective is a ``torch.autograd.Function`` whose backward applies its
conjugate Function (copy <-> reduce, gather <-> split), so R1's gradient of a
gradient runs the collectives again.  A gather's backward takes this rank's
slice and does not sum: everything after the gather is replicated, so every
rank already holds the whole cotangent, and a sum would scale the gradients
by the model axis's size.

``shard_state_`` takes a whole game state to this rank's slices (weights and
both Adam moments; u, v and biases stay whole); ``gather_state`` gives the
whole state dicts back, the ones a single process holds, for a checkpoint.

``pmean`` is the data axis's differentiable mean, Flax's ``lax.pmean`` for
``baselines/layers.py:BatchNorm(axis_name="data")``.

Gloo gathers only CPU tensors, so on gloo a gather is an all-reduce of
zero-padded slices, which is exact; NCCL gathers.  bf16 sums are reduced in
f32 and rounded once.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from optimalstrategiesagainstgenerativeattacks_torch.parallel.mesh import (
    Axis,
    Mesh,
    data_axis,
    param_shardings,
)


def local_rows(n: int, axis: Axis) -> slice:
    """This rank's rows of a dim of ``n`` split over ``axis``."""
    if n % axis.size:
        raise ValueError(f"{n} rows do not divide over {axis.size} ranks")
    c = n // axis.size
    return slice(axis.rank * c, (axis.rank + 1) * c)


def all_reduce_sum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of ``x`` over ``axis``'s ranks, in a new tensor (bf16 summed in f32)."""
    reduce_dtype = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    y = x.to(reduce_dtype, memory_format=torch.contiguous_format, copy=True)
    dist.all_reduce(y, group=axis.group)
    return y.to(x.dtype)


def all_gather(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim``, in rank order."""
    x = x.contiguous()
    if dist.get_backend(axis.group) == "nccl":
        stack = x.new_empty((axis.size, *x.shape))
        dist.all_gather_into_tensor(stack, x, group=axis.group)
    else:  # gloo: a sum of zero-padded slices
        stack = x.new_zeros((axis.size, *x.shape))
        stack[axis.rank] = x
        dist.all_reduce(stack, group=axis.group)
    return torch.cat(stack.unbind(0), dim)


class _CopyToModel(torch.autograd.Function):
    """Identity; the backward sums the cotangent over the model group."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x

    @staticmethod
    def backward(ctx, g):
        return _ReduceFromModel.apply(g, ctx.axis), None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the model group; the backward is the identity."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_reduce_sum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _CopyToModel.apply(g, ctx.axis), None


class _GatherFromModel(torch.autograd.Function):
    """The ranks' slices concatenated along ``dim``; the backward takes this rank's."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _SplitToModel.apply(g, ctx.axis, ctx.dim), None, None


class _SplitToModel(torch.autograd.Function):
    """This rank's slice along ``dim``; the backward gathers the slices."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        rows = local_rows(x.shape[dim], axis)
        return x.narrow(dim, rows.start, rows.stop - rows.start)

    @staticmethod
    def backward(ctx, g):
        return _GatherFromModel.apply(g, ctx.axis, ctx.dim), None, None


class _PMean(torch.autograd.Function):
    """Mean over an axis; the backward is the mean of the cotangents (``lax.pmean``'s
    transpose)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_reduce_sum(x, axis) / axis.size

    @staticmethod
    def backward(ctx, g):
        return _PMean.apply(g, ctx.axis), None


def copy_to_model(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return _ReduceFromModel.apply(x, axis)


def gather_from_model(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    return _GatherFromModel.apply(x, axis, dim)


def split_to_model(x: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    return _SplitToModel.apply(x, axis, dim)


def pmean(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """The differentiable mean of ``x`` over the named axis; only "data" exists here
    (the identity when the data axis has one rank)."""
    if axis_name != "data":
        raise ValueError(f"axis {axis_name!r}: only 'data' is mapped")
    axis = data_axis()
    return x if axis.size == 1 else _PMean.apply(x, axis)


def sharded_weights(module: nn.Module) -> Dict[str, nn.Module]:
    """Name of each weight of ``module`` that holds this rank's rows -> its layer."""
    return {(f"{p}.weight" if p else "weight"): m for p, m in module.named_modules()
            if getattr(m, "model_axis", None) is not None}


def sharded_params(module: nn.Module) -> list:
    """The parameters of ``module`` that hold this rank's rows."""
    return [layer.weight for layer in sharded_weights(module).values()]


def shard_module_(module: nn.Module, mesh: Mesh, min_size: int = 1024,
                  opt: Optional[torch.optim.Optimizer] = None) -> list:
    """Split every weight ``param_shardings`` picks over ``mesh``'s model axis, in
    place: the weight (and its Adam moments in ``opt``, where a step made them)
    keeps this rank's rows, and its layer runs sharded.  Returns the names."""
    layers = dict(module.named_modules())
    names = [k for k, d in param_shardings(module, mesh, min_size).items() if d is not None]
    for name in names:
        layer = layers[name.rpartition(".")[0]]
        rows = local_rows(layer.weight.shape[0], mesh.model)
        layer.weight.data = layer.weight.data[rows].clone()
        if opt is not None and layer.weight in opt.state:
            state = opt.state[layer.weight]
            for k in ("exp_avg", "exp_avg_sq"):
                if k in state:
                    state[k] = state[k][rows].clone()
        layer.model_axis = mesh.model
    return names


def shard_state_(state, mesh: Mesh, min_size: int = 1024) -> Dict[str, list]:
    """Take a whole game state (``train/state.py:GameState``) to this rank's slices
    over ``mesh``'s model axis: both players' weights that ``param_shardings``
    picks and their Adam moments.  u, v, biases and every other parameter stay
    whole.  Returns each player's sharded names."""
    return {player: shard_module_(getattr(state, player), mesh, min_size,
                                  getattr(state, f"opt_{player}"))
            for player in ("au", "im")}


def _gather_module_state(module: nn.Module) -> dict:
    """``module``'s state dict with every sharded weight gathered whole (a
    collective: every rank of the model group calls it)."""
    sd = module.state_dict()
    for name, layer in sharded_weights(module).items():
        sd[name] = all_gather(layer.weight.detach(), layer.model_axis, 0)
    return sd


def _gather_optimizer_state(module: nn.Module, opt: torch.optim.Optimizer) -> dict:
    """``opt``'s state dict with the Adam moments of ``module``'s sharded weights
    gathered whole (a collective)."""
    sd = opt.state_dict()
    axes = {id(layer.weight): layer.model_axis for layer in sharded_weights(module).values()}
    params = [p for g in opt.param_groups for p in g["params"]]
    state = dict(sd["state"])
    for i, p in enumerate(params):
        if id(p) in axes and i in state:
            state[i] = {k: (all_gather(v, axes[id(p)], 0) if k in ("exp_avg", "exp_avg_sq") else v)
                        for k, v in state[i].items()}
    return {**sd, "state": state}


def gather_state(state) -> dict:
    """The whole state a single process holds, from a sharded one: ``{"au", "im"}``
    state dicts and ``{"opt_au", "opt_im"}`` optimizer state dicts (a collective:
    every rank calls it, in the same order)."""
    out = {}
    for player in ("au", "im"):
        module = getattr(state, player)
        out[player] = _gather_module_state(module)
        out[f"opt_{player}"] = _gather_optimizer_state(module, getattr(state, f"opt_{player}"))
    return out


def local_state_dict(module: nn.Module, state_dict: dict) -> dict:
    """A whole state dict cut to ``module``'s layout: each sharded weight's rows
    of this rank."""
    out = dict(state_dict)
    for name, layer in sharded_weights(module).items():
        out[name] = state_dict[name][local_rows(state_dict[name].shape[0], layer.model_axis)]
    return out
