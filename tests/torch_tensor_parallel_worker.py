"""One rank of ``tests/test_torch_tensor_parallel.py``'s process group (gloo, on the CPU).

    RANK=r WORLD_SIZE=w python tests/torch_tensor_parallel_worker.py <job_dir> <model_parallel>

Reads ``<job_dir>/inputs.pt``, joins the group through ``<job_dir>/rendezvous``,
lays the ranks out as (w / model_parallel, model_parallel), runs every job
and writes ``<job_dir>/rank<r>.pt``.  Imports torch and the port only.
"""

import os
import sys

import torch

from optimalstrategiesagainstgenerativeattacks_torch.baselines.arcface import (
    Backbone,
    BottleneckIR,
)
from optimalstrategiesagainstgenerativeattacks_torch.baselines.layers import BatchNorm
from optimalstrategiesagainstgenerativeattacks_torch.nn.blocks import Conv, Dense, SNConv
from optimalstrategiesagainstgenerativeattacks_torch.ops.spectral import sigma
from optimalstrategiesagainstgenerativeattacks_torch.parallel import mesh
from optimalstrategiesagainstgenerativeattacks_torch.parallel import tensor
from optimalstrategiesagainstgenerativeattacks_torch.port.transplant import load_flax
from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg
from optimalstrategiesagainstgenerativeattacks_torch.train.checkpoints import CheckpointIO
from optimalstrategiesagainstgenerativeattacks_torch.utils.config import ImageGameConfig


def local_snapshot(state) -> dict:
    """This rank's tensors: both players' parameters and buffers, and each
    parameter's Adam moments (``exp_avg.<name>``, ``exp_avg_sq.<name>``)."""
    out = {}
    for player in ("au", "im"):
        module, opt = getattr(state, player), getattr(state, f"opt_{player}")
        for k, v in module.state_dict().items():
            out[f"{player}.{k}"] = v.detach().clone()
        for k, p in module.named_parameters():
            for m in ("exp_avg", "exp_avg_sq"):
                out[f"{player}.{m}.{k}"] = opt.state[p][m].clone()
    return out


def whole_snapshot(state, whole: dict) -> dict:
    """``tensor.gather_state``'s dicts in ``local_snapshot``'s layout."""
    out = {}
    for player in ("au", "im"):
        module, opt = getattr(state, player), getattr(state, f"opt_{player}")
        out.update({f"{player}.{k}": v.detach().clone() for k, v in whole[player].items()})
        names = {id(p): k for k, p in module.named_parameters()}
        moments = whole[f"opt_{player}"]["state"]
        for i, p in enumerate(p for g in opt.param_groups for p in g["params"]):
            for m in ("exp_avg", "exp_avg_sq"):
                out[f"{player}.{m}.{names[id(p)]}"] = moments[i][m].clone()
    return out


def floats(metrics) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def image_steps(job: dict, layout: mesh.Mesh) -> dict:
    """The sharded state from the JAX players' trees, ``job["steps"]`` steps on this
    rank's shards with its rows of each step's z (the gathered state after each),
    ``eval_step`` on the eval batch (its metrics averaged over the data axis) and a
    checkpoint."""
    cfg = ImageGameConfig(**job["cfg"])
    state = timg.create_state(cfg, *timg.build_models(cfg), cfg.seed, "cpu")
    names = tensor.shard_state_(state, layout, job["min_size"])
    load_flax(state.au, job["au"]["params"], job["au"]["spectral"])
    load_flax(state.im, job["im"]["params"], job["im"]["spectral"])
    metrics, whole = [], []
    for b, z in job["steps"]:
        metrics.append(floats(timg.train_step(state, mesh.shard_batch(b),
                                              z=mesh.shard_batch(z))[0]))
        whole.append(whole_snapshot(state, tensor.gather_state(state)))
    b, z = job["eval"]
    ev = floats(mesh.all_reduce_mean_dict(timg.eval_step(state, mesh.shard_batch(b),
                                                         z=mesh.shard_batch(z))))
    ckpt = CheckpointIO(job["ckpt_dir"]).save(state, state.step)
    return {"metrics": metrics, "eval": ev, "local": local_snapshot(state), "whole": whole,
            "sharded": names, "ckpt": ckpt}


def _grads(module, x, c):
    """Forward of tanh(module(x)), and the gradients of <., c> and of the squared
    norm of its input gradient (a gradient of a gradient) with respect to every
    parameter and x."""
    x = x.clone().requires_grad_(True)
    y = module(x)
    loss = (torch.tanh(y) * c).sum()
    params = [p for _, p in module.named_parameters()]
    g1 = torch.autograd.grad(loss, params + [x], create_graph=True)
    pen = g1[-1].square().sum()
    g2 = torch.autograd.grad(pen, params + [x])
    names = [k for k, _ in module.named_parameters()] + ["x"]
    return {"y": y.detach(), **{f"g1.{k}": g.detach() for k, g in zip(names, g1)},
            **{f"g2.{k}": g for k, g in zip(names, g2)}}


def collectives(job: dict, layout: mesh.Mesh) -> dict:
    """A Dense, a Conv and an SNConv sharded over the model axis, from whole weights:
    forward, gradients, gradients of gradients; the SNConv's power iteration and
    sigma.  And this rank's rows of a noise draw and of a batch."""
    out = {"noise": mesh.randn_slice((4, 3), torch.Generator().manual_seed(0), "cpu"),
           "batch": mesh.shard_batch(torch.arange(8))}
    for name, make in (("dense", lambda: Dense(*job["dense_shape"])),
                       ("conv", lambda: Conv(*job["conv_shape"], padding=1)),
                       ("snconv", lambda: SNConv(*job["conv_shape"], padding=1))):
        module = make()
        module.load_state_dict(job[name]["weights"])
        tensor.shard_module_(module, layout, min_size=1)
        if name == "snconv":
            module.power_iterate_()
            out[f"{name}.u"], out[f"{name}.v"] = module.u.clone(), module.v.clone()
            out[f"{name}.sigma"] = sigma(module.weight, module.u, module.v,
                                         module.model_axis).detach()
        out.update({f"{name}.{k}": v for k, v in
                    _grads(module, job[name]["x"], job[name]["c"]).items()})
    return out


def _bn_grads(module, x, c) -> dict:
    x = x.clone().requires_grad_(True)
    y = module(x)
    grads = torch.autograd.grad((y * c).sum(), [p for _, p in module.named_parameters()] + [x])
    names = [k for k, _ in module.named_parameters()] + ["x"]
    stats = {k: v.clone() for k, v in module.state_dict().items() if k.startswith("running")
             or ".running" in k}
    return {"y": y.detach(), "grads": dict(zip(names, grads)), "stats": stats}


def synced_bn(job: dict, layout: mesh.Mesh) -> dict:
    """``BottleneckIR(use_se=True)`` and ``BatchNorm(axis_name="data")`` (the
    Backbone's ``out_bn1d``), and the whole ``Backbone`` without dropout, each on
    this rank's data shard."""
    out = {}
    unit = BottleneckIR(*job["unit_shape"], use_se=True, bn_axis_name="data")
    unit.load_state_dict(job["unit"]["weights"])
    out["unit"] = _bn_grads(unit, mesh.shard_batch(job["unit"]["x"]),
                            mesh.shard_batch(job["unit"]["c"]))
    bn = BatchNorm(job["bn1d"]["x"].shape[1], axis_name="data")
    bn.load_state_dict(job["bn1d"]["weights"])
    out["bn1d"] = _bn_grads(bn, mesh.shard_batch(job["bn1d"]["x"]),
                            mesh.shard_batch(job["bn1d"]["c"]))
    backbone = Backbone(**job["backbone"]["kwargs"], bn_axis_name="data")
    backbone.load_state_dict(job["backbone"]["weights"])
    out["backbone"] = _bn_grads(backbone, mesh.shard_batch(job["backbone"]["x"]),
                                mesh.shard_batch(job["backbone"]["c"]))
    return out


JOBS = {"image": image_steps, "collectives": collectives, "synced_bn": synced_bn}


def main(job_dir: str, model_parallel: int) -> None:
    torch.set_num_threads(1)
    inputs = torch.load(os.path.join(job_dir, "inputs.pt"), weights_only=False)
    mesh.init_process("cpu", init_method="file://" + os.path.join(job_dir, "rendezvous"))
    try:
        layout = mesh.create_mesh(model_parallel)
        out = {name: JOBS[job["kind"]](job, layout) for name, job in inputs.items()}
        out["layout"] = (mesh.rank(), layout.data.rank, layout.model.rank)
        torch.save(out, os.path.join(job_dir, f"rank{mesh.rank()}.pt"))
        mesh.barrier()
    finally:
        mesh.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
