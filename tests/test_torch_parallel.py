"""The port's data-parallel training (``parallel/mesh.py``) against the JAX package's mesh.

Two ranks on the CPU over gloo (``tests/torch_parallel_worker.py``, each a
process joined through a rendezvous file), held to:

  * one image step with R1 from transplanted weights, the JAX step's noise
    injected, against the JAX ``make_train_step`` on
    ``create_mesh(jax.devices()[:2])``, on ``tests/test_torch_train_step.py``'s
    R1 inputs (img 16, style 32, three channels, B=2: one episode a rank, f32,
    ``reg_param`` 10, batch seed 3) and with its tolerances.  Those tolerances
    hold the impersonator's gradients, which pass through the frozen
    authenticator's set std, to 2e-3 of each tensor's largest entry, a floor
    set by that std's conditioning and not by the port: at B=4 (batch seeds
    3-6) the JAX package's own 2-device mesh and single-device steps differ by
    up to 0.96 of it, and the port's single process and the JAX single device
    by up to 1.02, so it is held where it was set.  The tolerances: metrics rtol 1e-4 / atol 1e-6; gradients (the Adam first
    moments, beta1 = 0) rtol 1e-3 above each tensor's floor; spectral u/v atol
    1e-6.  Parameters: where |g| exceeds twice its tensor's floor (and 1e-6),
    so that the gradient test fixes its sign, to f32 rounding (atol 1e-7, rtol
    1e-6) plus what Adam's first step, lr g / (|g| + eps), can differ by between
    two gradients of one sign, lr eps / min |g|; elsewhere within 2 lr and f32
    rounding.  That is
    ``test_torch_train_step.py``'s rule with its sign flips (there: under R1, at
    most 4 a tensor) allowed wherever the floor admits them: the impersonator's
    gradients past the set std are rounding noise near the floor, and two ranks
    reduce in another order than one process (23 of the 32 entries of
    ``im.encoders.env.down_0.conv_l1.weight`` take the other sign at reg 0);
  * one flagship-like step at ``reg_param`` 0 with the noise drawn from the
    state's generator (each rank its slice of the global draw) against one
    process of the port on the global batch, with the same tolerances;
  * three Gaussian steps (B=64, d=2, m1 n4 k4) from the JAX players' weights,
    each step's batch and noise injected, against the JAX ``make_train_fn``
    on the 2-device mesh, and ``train_chunk`` of three steps against one
    process of the port, with ``tests/test_parallel.py``'s tolerances:
    metrics rtol 5e-4 / atol 1e-5, parameters rtol 1e-4 / atol 1e-6;
  * both ranks' parameters, u/v and Adam moments equal bit for bit after
    every run, and ``train_gim_gaussian`` writing from rank 0 only;
  * ``train_loader`` refusing the device loader in a group and sharding the
    host loader.

Without a group: ``adjust_batch_size`` against the JAX package's, and the
host loader's shards concatenated against the single-process batch bit for
bit on the vectorised path (uniform Omniglot) and the per-episode one (a
VoxCeleb tree, with and without a thread pool).

The image CLI under ``torch.distributed.run --nproc_per_node 2 --device
cpu`` writes one ``args.json`` and one ``ckpts/`` tree from rank 0,
resumes from a mid-run checkpoint and refuses ``--device_data on``.

Every process is started at the module's setup, the CLI runs first, and the
JAX references are computed while they run; each wait is bounded.
"""

import concurrent.futures
import dataclasses
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimalstrategiesagainstgenerativeattacks_torch.data.episodic import (
    EpisodicBatchLoader,
    ImgGIMDataSet,
    OmniglotGIMDataSet,
)
from optimalstrategiesagainstgenerativeattacks_torch.parallel import mesh as tmesh
from optimalstrategiesagainstgenerativeattacks_torch.port.transplant import (
    flax_to_state_dict,
    load_flax,
)
from optimalstrategiesagainstgenerativeattacks_torch.train import gaussian as tg
from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg
from optimalstrategiesagainstgenerativeattacks_torch.utils.config import GaussianGameConfig
from optimalstrategiesagainstgenerativeattacks_tpu.models import gaussian as jmodels
from optimalstrategiesagainstgenerativeattacks_tpu.parallel import mesh as jmesh
from optimalstrategiesagainstgenerativeattacks_tpu.train import gaussian as jg
from optimalstrategiesagainstgenerativeattacks_tpu.train import image as jimg
from optimalstrategiesagainstgenerativeattacks_tpu.train.state import GameState
from optimalstrategiesagainstgenerativeattacks_tpu.utils import config as jconfig
from test_torch_loop import _write_tree
from test_torch_support import (
    REPO,
    init_jax_players,
    jax_build,
    jax_cfg,
    small_cfg,
    torch_state_from,
    uint8_batch,
)
from test_torch_train_step import _adam_mu, _grad_floors
from torch_parallel_worker import snapshot

torch.set_num_threads(1)

WORLD = 2
WORKER = REPO / "tests" / "torch_parallel_worker.py"
CLI = "optimalstrategiesagainstgenerativeattacks_torch.train_gim_on_imgs"
TIMEOUT = 240  # seconds for any one process; a hang fails the module's setup
R1_CFG = dict(reg_param=10.0, img_channels=3)  # test_torch_train_step.py's R1 case, B=2
REG0_CFG = dict(batch_size=4, seed=5)
GAUSS_CFG = dict(batch_size=64, src_dim=2, m=1, n=4, k=4, seed=0)
GAUSS_STEPS = 3


def _env(**extra):
    return dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", **extra)


def _start(cmd, log_path, **env):
    """A process in its own session (a hang is killed with all it started)."""
    with open(log_path, "w") as log:
        return subprocess.Popen(cmd, cwd=REPO, env=_env(**env), stdout=log,
                                stderr=subprocess.STDOUT, start_new_session=True)


def _join(procs, logs, timeout=TIMEOUT):
    """Wait for every process within ``timeout`` seconds; a hang kills them all and
    fails.  Returns the exit codes."""
    try:
        for p in procs:
            p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        pytest.fail(f"hung past {timeout} s: " + "\n".join(open(f).read()[-2000:] for f in logs))
    return [p.returncode for p in procs]


def _torchrun(argv, log_path):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(WORLD), "-m", CLI, *argv]
    rc = _join([_start(cmd, log_path)], [log_path])[0]
    return rc, open(log_path).read()


def _cli_runs(tree, out, logs):
    """The CLI under torchrun: a run, a resume from its mid-run checkpoint, and
    (at once, beside them) a refused ``--device_data on``."""
    argv = ["--dataset_root", tree, "-o", str(out), "--device", "cpu", "-dbg",
            "--img_size", "16", "--style_dim", "32", "--batch_size", "4", "--n", "2",
            "--k", "2", "--ds_n_examples_per_cls", "2", "--num_workers", "0",
            "--compute_dtype", "float32", "--save_every", "1", "--eval_every", "2",
            "--save_imgs_every", "2", "--log_every", "1"]
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        refused = ex.submit(_torchrun, argv + ["--n_epochs", "1", "--device_data", "on",
                                               "-o", str(out) + "_refused"], logs / "refused.log")
        run = _torchrun(argv + ["--n_epochs", "2"], logs / "run.log")
        listing = sorted(os.listdir(out)), sorted(os.listdir(out / "ckpts"))
        resumed = _torchrun(argv + ["--n_epochs", "2", "-r", "ckpts/model_00000001"],
                            logs / "resumed.log")
        return {"run": run, "listing": listing, "resumed": resumed,
                "refused": refused.result(), "after": sorted(os.listdir(out / "ckpts"))}


def _jax_snapshot(jstate) -> dict:
    """The worker's ``snapshot`` layout of a JAX image or Gaussian state."""
    out = {}
    for player in ("au", "im"):
        params = jax.tree.map(np.asarray, getattr(jstate, f"params_{player}"))
        spectral = jax.tree.map(np.asarray, getattr(jstate, f"spectral_{player}", {}))
        named = {**flax_to_state_dict(params, {}), **flax_to_state_dict({}, spectral)}
        out.update({f"{player}.{k}": v for k, v in named.items()})
        mu = flax_to_state_dict(_adam_mu(getattr(jstate, f"opt_{player}")), {})
        out.update({f"{player}.grad.{k}": v for k, v in mu.items()})
    return out


def _torch_snapshot(state) -> dict:
    return {k: v.numpy() for k, v in snapshot(state).items()}


def _image_inputs(cfg, av, iv, batch, z):
    state = torch_state_from(cfg, av, iv)
    return {"kind": "image", "cfg": dataclasses.asdict(cfg),
            "weights": {"au": state.au.state_dict(), "im": state.im.state_dict()},
            "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
            "z": torch.from_numpy(z)}


def _jax_r1_step(cfg, av, iv, batch):
    """The JAX step's noise draw as f32 numpy, and a function running the step on a
    2-device mesh from the transplanted state -> (snapshot, metrics)."""
    jau, jim = jax_build(cfg)
    jcfg = jax_cfg(cfg)
    opt_au, opt_im, _ = jimg.make_optimizers(jcfg)
    jstate = GameState(
        step=jnp.asarray(-1, jnp.int32), params_au=av["params"], params_im=iv["params"],
        spectral_au=av["spectral"], spectral_im=iv["spectral"],
        opt_au=opt_au.init(av["params"]), opt_im=opt_im.init(iv["params"]),
        rng=jax.random.PRNGKey(7))
    _, k_noise = jax.random.split(jax.random.fold_in(jstate.rng, 0))
    shape = (cfg.batch_size, cfg.n, cfg.style_dim)
    z = np.array(jim.apply(iv, method=lambda m: jax.random.normal(m.make_rng("noise"), shape),
                           rngs={"noise": k_noise}), np.float32)

    def run():
        mesh = jmesh.create_mesh(jax.devices()[:WORLD])
        step = jimg.make_train_step(jcfg, jau, jim, opt_au, opt_im, mesh)
        jbatch = jmesh.shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
        new_state, metrics, _ = step(jstate, jbatch)
        return _jax_snapshot(new_state), {k: float(v) for k, v in metrics.items()}

    return z, run


def _gaussian_jax(cfg):
    """The JAX players' initial weights, each of GAUSS_STEPS steps' global batch and
    noise, and a function running them on the JAX mesh -> (snapshot, metrics)."""
    jcfg = jconfig.GaussianGameConfig(**dataclasses.asdict(cfg))
    jau, jim = jmodels.get_au(cfg.src_dim), jmodels.get_im(cfg.src_dim)
    jstate, opt_au, opt_im = jg.create_state(jcfg, jau, jim, jax.random.PRNGKey(cfg.seed))
    state = tg.create_state(cfg, "cpu")
    load_flax(state.au, jax.tree.map(np.asarray, jstate.params_au), {})
    load_flax(state.im, jax.tree.map(np.asarray, jstate.params_im), {})
    draws, rng = [], jstate.rng
    shape = (cfg.batch_size, cfg.n, cfg.src_dim)
    for step in range(GAUSS_STEPS):  # the step's keys: split(fold_in(rng, step), 3)
        rng, k_batch, k_noise = jax.random.split(jax.random.fold_in(rng, step), 3)
        batch = {k: torch.from_numpy(np.array(v))
                 for k, v in jg._synth_batch(jcfg, k_batch, None).items()}
        z = np.array(jim.apply({"params": jstate.params_im},
                               method=lambda m: jax.random.normal(m.make_rng("noise"), shape),
                               rngs={"noise": k_noise}))
        draws.append((batch, torch.from_numpy(z)))
    weights = {"au": state.au.state_dict(), "im": state.im.state_dict()}

    def run():
        new_state, metrics = jg.make_train_fn(
            jcfg, jau, jim, opt_au, opt_im, mesh=jmesh.create_mesh(jax.devices()[:WORLD]),
            n_steps=GAUSS_STEPS)(jstate)
        return (_jax_snapshot(new_state),
                np.stack([np.asarray(metrics[k]) for k in tg.METRIC_KEYS], axis=1))

    return weights, draws, run


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel")
    tree = _write_tree(root / "tree", "omniglot")
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        cli = ex.submit(_cli_runs, tree, root / "out", root)

        r1_cfg = small_cfg(**R1_CFG)
        _, _, av, iv = init_jax_players(r1_cfg)
        r1_batch = uint8_batch(r1_cfg, seed=3)
        z, jax_r1_run = _jax_r1_step(r1_cfg, av, iv, r1_batch)
        gauss_cfg = GaussianGameConfig(**GAUSS_CFG)
        weights, draws, jax_gauss_run = _gaussian_jax(gauss_cfg)

        reg0_cfg = small_cfg(**REG0_CFG)
        reg0_batch = {k: torch.from_numpy(v) for k, v in uint8_batch(reg0_cfg, seed=11).items()}
        inputs = {
            "r1": _image_inputs(r1_cfg, av, iv, r1_batch, z),
            "reg0": {"kind": "image", "cfg": dataclasses.asdict(reg0_cfg), "batch": reg0_batch},
            "gauss_jax": {"kind": "gaussian", "cfg": dataclasses.asdict(gauss_cfg),
                          "weights": weights, "draws": draws},
            "gauss_chunk": {"kind": "gaussian", "cfg": dataclasses.asdict(gauss_cfg),
                            "n_steps": GAUSS_STEPS},
            "loaders": {"kind": "loaders", "cfg": dataclasses.asdict(reg0_cfg), "root": tree},
            "gauss_loop": {"kind": "gaussian_loop", "cfg": dataclasses.asdict(GaussianGameConfig(
                outdir=str(root / "gauss"), n_iters=6, log_every=2, save_stats_every=2,
                save_every=3, src_dim=2, batch_size=32))},
        }
        job = root / "group"
        job.mkdir()
        torch.save(inputs, job / "inputs.pt")
        logs = [job / f"rank{r}.log" for r in range(WORLD)]
        procs = [_start([sys.executable, str(WORKER), str(job)], logs[r], RANK=str(r),
                        LOCAL_RANK=str(r), WORLD_SIZE=str(WORLD)) for r in range(WORLD)]

        # the JAX mesh's runs and one process of the port, while the ranks run
        jax_r1, jax_r1_metrics = jax_r1_run()
        jax_gauss, jax_gauss_metrics = jax_gauss_run()
        state = timg.create_state(reg0_cfg, *timg.build_models(reg0_cfg), reg0_cfg.seed, "cpu")
        reg0_metrics, _ = timg.train_step(state, reg0_batch)
        gstate = tg.create_state(gauss_cfg, "cpu")
        gauss_chunk = tg.train_chunk(gstate, GAUSS_STEPS).numpy()

        rcs = _join(procs, logs)
        assert rcs == [0] * WORLD, "\n".join(open(f).read()[-3000:] for f in logs)
        ranks = [torch.load(job / f"rank{r}.pt", weights_only=True) for r in range(WORLD)]
        return {
            "ranks": ranks,
            "want": {
                "r1": (r1_cfg, jax_r1, jax_r1_metrics),
                "reg0": (reg0_cfg, _torch_snapshot(state),
                         {k: float(v) for k, v in reg0_metrics.items()}),
                "gauss_jax": (gauss_cfg, jax_gauss, jax_gauss_metrics),
                "gauss_chunk": (gauss_cfg, _torch_snapshot(gstate), gauss_chunk),
            },
            "cli": cli.result(timeout=3 * TIMEOUT),
            "out": root / "out",
            "gauss_dir": root / "gauss",
        }


def _np(state: dict) -> dict:
    return {k: v.numpy() for k, v in state.items()}


def _lr(cfg, key: str) -> float:
    player, name = key.split(".", 1)
    if player == "au":
        return cfg.au_lr
    return cfg.env_noise_mapping_lr if name.startswith("env_noise_mapper.") else cfg.im_lr


@pytest.mark.parametrize("name", ["r1", "reg0"])
def test_two_rank_image_step_matches_one_step_at_the_global_batch(runs, name):
    """``r1`` against the JAX step on a 2-device mesh, ``reg0`` against one process of
    the port; the tolerances of ``tests/test_torch_train_step.py``."""
    cfg, want, want_metrics = runs["want"][name]
    got = _np(runs["ranks"][0][name]["state"])
    got_metrics = runs["ranks"][0][name]["metrics"]
    assert set(got) == set(want) and set(got_metrics) == set(want_metrics)
    for k in timg.METRIC_KEYS:
        np.testing.assert_allclose(got_metrics[k], want_metrics[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    if cfg.reg_param > 0:
        assert got_metrics["au_reg"] > 0.0
    for player in ("au", "im"):
        prefix = f"{player}.grad."
        grads = {k[len(prefix):]: v for k, v in want.items() if k.startswith(prefix)}
        floors = _grad_floors(grads, player)
        for k, g in grads.items():
            np.testing.assert_allclose(got[prefix + k], g, rtol=1e-3, atol=floors[k],
                                       err_msg=prefix + k)
            key = f"{player}.{k}"
            # where the gradient test fixes the sign, Adam's first step lr g / (|g| + eps)
            # agrees to f32 rounding plus lr eps / min |g| (gradients of one sign)
            big = np.abs(g) > np.maximum(1e-6, 2 * floors[k])
            slack = _lr(cfg, key) * 1e-8 / np.minimum(np.abs(g), np.abs(got[prefix + k]))[big]
            np.testing.assert_array_less(np.abs(got[key] - want[key])[big],
                                         1e-7 + 1e-6 * np.abs(want[key])[big] + slack,
                                         err_msg=key)
            # elsewhere either sign: 2 lr apart, and f32 rounding
            assert np.all(np.abs(got[key] - want[key])[~big]
                          <= (2 * _lr(cfg, key) + 1e-7 + 1e-6 * np.abs(want[key]))[~big]), key
        buffers = [k for k in want if k.startswith(player + ".") and not k.startswith(prefix)
                   and k[len(player) + 1:] not in grads]
        assert buffers  # the spectral u/v
        for k in buffers:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", ["gauss_jax", "gauss_chunk"])
def test_two_rank_gaussian_steps_match_one_run_at_the_global_batch(runs, name):
    """``gauss_jax`` against the JAX ``make_train_fn`` on a 2-device mesh, ``gauss_chunk``
    against ``train_chunk`` in one process; ``tests/test_parallel.py``'s tolerances."""
    _, want, want_metrics = runs["want"][name]
    got = _np(runs["ranks"][0][name]["state"])
    np.testing.assert_allclose(runs["ranks"][0][name]["metrics"].numpy(), want_metrics,
                               rtol=5e-4, atol=1e-5)
    params = [k for k in want if ".grad." not in k]
    assert set(got) == set(want) and params
    for k in params:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", ["r1", "reg0", "gauss_jax", "gauss_chunk", "gauss_loop"])
def test_ranks_stay_bit_equal(runs, name):
    a, b = (r[name] for r in runs["ranks"])
    assert runs["ranks"][0]["world"] == (0, WORLD) and runs["ranks"][1]["world"] == (1, WORLD)
    assert a["state"].keys() == b["state"].keys()
    for k in a["state"]:
        assert torch.equal(a["state"][k], b["state"][k]), k
    if "metrics" in a:
        m = a["metrics"]
        assert torch.equal(m, b["metrics"]) if torch.is_tensor(m) else m == b["metrics"]


def test_gaussian_loop_writes_from_rank_zero(runs):
    assert [r["gauss_loop"]["step"] for r in runs["ranks"]] == [5, 5]
    out = runs["gauss_dir"]
    assert sorted(os.listdir(out / "ckpts")) == ["model_00000003", "model_00000005"]
    assert len(os.listdir(out / "tb")) == 1


def test_train_loader_refuses_the_device_loader_in_a_group(runs):
    for r, got in enumerate(r["loaders"] for r in runs["ranks"]):
        assert "single-card only" in got["on"]
        assert got["auto"] == ("EpisodicBatchLoader", (r, WORLD))


def test_cli_under_torchrun_writes_from_rank_zero_resumes_and_refuses_device_data(runs):
    cli = runs["cli"]
    rc, log = cli["run"]
    assert rc == 0, log[-3000:]
    assert f"data parallel: {WORLD} ranks, backend gloo" in log
    assert log.count("Authenticator has") == 1  # rank 0 prints
    assert "each of 2 ranks assembling 2 of 4" in log
    # 4 classes x 2 episodes at B=4: two steps an epoch
    assert cli["listing"] == (["args.json", "ckpts", "imgs", "logs", "tb"],
                              [f"model_{s:08d}" for s in range(4)])
    rc, log = cli["resumed"]
    assert rc == 0, log[-3000:]
    assert "Resuming training from iteration 1" in log
    assert cli["after"] == [f"model_{s:08d}" for s in range(6)]
    rc, log = cli["refused"]
    assert rc != 0 and "device_data='on' is single-card only" in log


@pytest.mark.parametrize("case", [(1000, 128, 8), (100, 128, 8), (9, 128, 8), (128, 128, 3),
                                  (5, 128, 1), (7, 4, 4), (3, 128, 4)])
def test_adjust_batch_size_matches_jax(case):
    try:
        want = jmesh.adjust_batch_size(*case)
    except AssertionError:
        with pytest.raises(ValueError):
            tmesh.adjust_batch_size(*case)
        return
    assert tmesh.adjust_batch_size(*case) == want


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    return {layout: _write_tree(tmp_path_factory.mktemp(layout), layout)
            for layout in ("omniglot", "voxceleb2")}


@pytest.mark.parametrize("layout,workers", [("omniglot", 0), ("voxceleb2", 0), ("voxceleb2", 2)])
def test_loader_shards_concatenate_to_the_global_batch(trees, layout, workers):
    if layout == "omniglot":  # uniform counts: the vectorised path
        ds = OmniglotGIMDataSet(root=trees[layout], split="train", img_channels=1, img_size=16,
                                m=1, n=2, si=2, example_cnt_per_class=3, seed=3)
    else:
        ds = ImgGIMDataSet(root=trees[layout], split="train", img_channels=3, img_size=16, m=1,
                           n=2, si=2, example_cnt_per_class=3, hierarchical=True, seed=3)

    def epochs(shard):
        loader = EpisodicBatchLoader(ds, batch_size=4, num_workers=workers, seed=9, shard=shard)
        return [list(loader) for _ in range(2)]

    whole = epochs((0, 1))
    parts = [epochs((r, WORLD)) for r in range(WORLD)]
    assert len(whole[0]) == 3
    for e, batches in enumerate(whole):
        for i, batch in enumerate(batches):
            for k, v in batch.items():
                got = np.concatenate([p[e][i][k] for p in parts])
                assert got.dtype == v.dtype and np.array_equal(got, v), (e, i, k)
    with pytest.raises(ValueError):
        EpisodicBatchLoader(ds, batch_size=3, shard=(0, WORLD))
