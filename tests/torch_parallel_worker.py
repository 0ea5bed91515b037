"""One rank of ``tests/test_torch_parallel.py``'s process group (gloo, on the CPU).

    RANK=r WORLD_SIZE=w python tests/torch_parallel_worker.py <job_dir>

Reads ``<job_dir>/inputs.pt`` (global batches, noise and weights that the
test wrote), joins the group through the file ``<job_dir>/rendezvous``, runs
every job on its shard and writes ``<job_dir>/rank<r>.pt``.  Imports torch and
the port only.
"""

import os
import sys

import torch

from optimalstrategiesagainstgenerativeattacks_torch.parallel import mesh
from optimalstrategiesagainstgenerativeattacks_torch.train import gaussian as tg
from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg
from optimalstrategiesagainstgenerativeattacks_torch.train.checkpoints import CheckpointIO
from optimalstrategiesagainstgenerativeattacks_torch.utils.config import (
    GaussianGameConfig,
    ImageGameConfig,
)


def snapshot(state) -> dict:
    """Both players' parameters and buffers (the spectral u/v), and each
    parameter's Adam first moment (``grad.<name>``)."""
    out = {}
    for player in ("au", "im"):
        module, opt = getattr(state, player), getattr(state, f"opt_{player}")
        for k, v in module.state_dict().items():
            out[f"{player}.{k}"] = v.detach().clone()
        for k, p in module.named_parameters():
            out[f"{player}.grad.{k}"] = opt.state[p]["exp_avg"].clone()
    return out


def floats(metrics) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def image_state(cfg: ImageGameConfig, weights=None):
    au, im = timg.build_models(cfg)
    state = timg.create_state(cfg, au, im, cfg.seed, "cpu")
    if weights is not None:
        state.au.load_state_dict(weights["au"])
        state.im.load_state_dict(weights["im"])
    return state


def image_step(job: dict) -> dict:
    """One step on this rank's shard of ``job["batch"]``, with this rank's rows
    of ``job["z"]`` when given, else the state's generator's."""
    state = image_state(ImageGameConfig(**job["cfg"]), job.get("weights"))
    z = job.get("z")
    metrics, _ = timg.train_step(state, mesh.shard_batch(job["batch"]),
                                 z=None if z is None else mesh.shard_batch(z))
    return {"metrics": floats(metrics), "state": snapshot(state)}


def gaussian_steps(job: dict) -> dict:
    """The steps of ``job["draws"]`` (global batch and noise each) on this rank's
    slices, from ``job["weights"]``; or, without draws, ``train_chunk`` of
    ``job["n_steps"]`` from the state's generator."""
    cfg = GaussianGameConfig(**job["cfg"])
    state = tg.create_state(cfg, "cpu")
    if "weights" in job:
        state.au.load_state_dict(job["weights"]["au"])
        state.im.load_state_dict(job["weights"]["im"])
    if "draws" in job:
        rows = [floats(tg.train_step(state, mesh.shard_batch(batch), mesh.shard_batch(z)))
                for batch, z in job["draws"]]
        metrics = torch.tensor([[r[k] for k in tg.METRIC_KEYS] for r in rows])
    else:
        metrics = tg.train_chunk(state, job["n_steps"])
    return {"metrics": metrics, "state": snapshot(state)}


def loaders(job: dict) -> dict:
    """``train_loader``'s choice in a group: "on" refused, "auto" the host loader."""
    from optimalstrategiesagainstgenerativeattacks_torch.data.episodic import OmniglotGIMDataSet

    cfg = ImageGameConfig(**job["cfg"])
    ds = OmniglotGIMDataSet(root=job["root"], split="train", img_channels=1,
                            img_size=cfg.img_size, m=cfg.m, n=cfg.n, si=cfg.k,
                            example_cnt_per_class=2)
    out = {}
    for device_data in ("on", "auto"):
        c = ImageGameConfig(**dict(job["cfg"], device_data=device_data))
        try:
            loader = timg.train_loader(c, ds, cfg.batch_size, "cpu")
            out[device_data] = (type(loader).__name__, loader.shard)
        except ValueError as e:
            out[device_data] = str(e)
    return out


def gaussian_loop(job: dict) -> dict:
    """``train_gim_gaussian`` into ``job["outdir"]``: rank 0 writes, every rank steps."""
    cfg = GaussianGameConfig(**job["cfg"])
    state = tg.train_gim_gaussian(cfg, progress=False, device="cpu")
    CheckpointIO(os.path.join(cfg.outdir, "ckpts")).load(
        os.path.join(cfg.outdir, "ckpts", f"model_{state.step:08d}"), tg.create_state(cfg, "cpu"))
    return {"step": state.step, "state": snapshot(state)}


JOBS = {"image": image_step, "gaussian": gaussian_steps, "loaders": loaders,
        "gaussian_loop": gaussian_loop}


def main(job_dir: str) -> None:
    torch.set_num_threads(1)
    inputs = torch.load(os.path.join(job_dir, "inputs.pt"), weights_only=True)
    mesh.init_process("cpu", init_method="file://" + os.path.join(job_dir, "rendezvous"))
    try:
        out = {name: JOBS[job["kind"]](job) for name, job in inputs.items()}
        out["world"] = (mesh.rank(), mesh.world_size())
        torch.save(out, os.path.join(job_dir, f"rank{mesh.rank()}.pt"))
        mesh.barrier()
    finally:
        mesh.shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
