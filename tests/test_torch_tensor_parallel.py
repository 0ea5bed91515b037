"""The port's model axis (``parallel/mesh.py:create_mesh``, ``param_shardings``,
``parallel/tensor.py``) and ArcFace's synced BatchNorm against the JAX package.

Four ranks on the CPU over gloo (``tests/torch_tensor_parallel_worker.py``),
laid out data 2 x model 2 (ranks 0, 1 a model group; 0, 2 a data group), at
``tests/test_torch_support.py``'s size with B=8 (img 16, style 32, m1 n2 k2,
f32) and ``min_size`` 32, where nearly every conv and linear is sharded:

  * two image steps at ``reg_param`` 0 and 10 from the JAX players' weights
    (transplanted straight into the sharded state), each step's z injected,
    then ``eval_step``, against the JAX package's
    ``make_train_step(..., create_mesh(jax.devices()[:4], model_parallel=2))``
    on ``param_shardings(..., min_size=32)`` and its ``make_eval_step``, with
    the JAX suite's own mesh tolerances (``_assert_step_equivalent``,
    ``tests/test_image_training.py:159-174``), and the gathered state against
    the port's one process on the same weights, batches and z with the same
    tolerances.  The suite holds one step: after the first the whole state,
    after the second the metrics and parameters, not the spectral u/v, which
    then follow weights that Adam's first step may have moved 2 lr apart where
    a gradient is rounding noise (``scripts/torch_data_parallel.py``'s rule);
  * replicated tensors bit-equal on all four ranks, sharded slices (weights
    and both Adam moments) bit-equal on the two ranks of a data group;
  * a checkpoint written from the sharded state (rank 0, after the gather)
    loads in one process and equals ``gather_state`` bit for bit;
  * a Dense, a Conv and an SNConv sharded over the model group against one
    process on the whole weight: forward, gradients and gradients of the input
    gradient's squared norm (R1's gradient of a gradient), one power
    iteration and sigma;
  * ``BottleneckIR(use_se=True)`` and a ``BatchNorm(axis_name="data")`` (the
    Backbone's ``out_bn1d``) on each data rank's half batch against the JAX
    modules with ``bn_axis_name="data"`` under ``jax.shard_map`` over two CPU
    devices (outputs, ``batch_stats`` and each device's gradients; no
    dropout: the two packages' draws never agree), and the whole
    ``Backbone(ir_se, 50, img 32)`` synced over the two halves against the
    unsynced port on the whole batch (equal shards make them one function:
    the halves' gradients sum to the whole batch's; PReLU slopes of 1, so
    that no activation sits at a kink, where rounding picks the slope).

Without a group: ``param_shardings`` picks, through the transplant's names,
the JAX rule's leaves (at the flagship widths and ``min_size`` 1024 exactly
the authenticator head's six matrices, from ``jax.eval_shape`` with no
init), and a ``BatchNorm(axis_name="data")`` on one rank is the unsynced one
bit for bit.

The traps each check pins: the ranks of a model group must take the same
batch rows and z rows (the step against JAX; with the model index in the
draw the fakes differ and the tight metrics miss); a gather's backward must
take this rank's slice, not sum (the gradients, 2x off otherwise); the
spectral norm's sums over the model group (u, v and sigma); the whole bias's
gradient made complete on every model rank (the Dense's and SNConv's bias
gradients, and replicated biases bit-equal across a model group).

The ranks start at the module's setup; the JAX references and the port's one
process run while they work; each wait is bounded.
"""

import concurrent.futures
import dataclasses
import os
import signal
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn
from jax.sharding import PartitionSpec as P

from optimalstrategiesagainstgenerativeattacks_torch.baselines import arcface as tarc
from optimalstrategiesagainstgenerativeattacks_torch.baselines.layers import BatchNorm, PReLU
from optimalstrategiesagainstgenerativeattacks_torch.nn.blocks import Conv, Dense, SNConv
from optimalstrategiesagainstgenerativeattacks_torch.parallel import mesh as tmesh
from optimalstrategiesagainstgenerativeattacks_torch.port.transplant import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg
from optimalstrategiesagainstgenerativeattacks_torch.train.checkpoints import CheckpointIO
from optimalstrategiesagainstgenerativeattacks_torch.utils.config import ImageGameConfig
from optimalstrategiesagainstgenerativeattacks_tpu.baselines import arcface as jarc
from optimalstrategiesagainstgenerativeattacks_tpu.parallel import mesh as jmesh
from optimalstrategiesagainstgenerativeattacks_tpu.train import image as jimg
from optimalstrategiesagainstgenerativeattacks_tpu.train.state import GameState
from test_image_training import _TIGHT_METRICS, _assert_step_equivalent, _assert_trees_close
from test_torch_baselines import _randomise
from test_torch_support import (
    REPO,
    init_jax_players,
    jax_build,
    jax_cfg,
    small_cfg,
    torch_state_from,
    uint8_batch,
)
from test_torch_train_step import _grad_floors
from torch_tensor_parallel_worker import _bn_grads, _grads, local_snapshot

torch.set_num_threads(1)

WORLD, MP = 4, 2
MIN_SIZE = 32
WORKER = REPO / "tests" / "torch_tensor_parallel_worker.py"
TIMEOUT = 240  # seconds for the group; a hang fails the module's setup
CASES = {"reg0": {}, "r1": {"reg_param": 10.0}}
N_STEPS = 2
BATCH_SEEDS = (3, 4)
EVAL_SEED = 5
IM_GRAD_FLOOR = 2e-2  # of each impersonator gradient's largest entry (see below)
BN_TOL, STATS_TOL = 1e-4, 1e-5  # tests/test_torch_baselines.py's, of each tensor's largest entry
DENSE_SHAPE, CONV_SHAPE = (24, 32), (8, 32, 3)
UNIT = dict(in_channels=16, depth=32, stride=2)
BACKBONE = dict(num_layers=50, drop_ratio=0.0, mode="ir_se", img_size=32, img_channels=3,
                emb_dim=64)
BACKBONE_SEED = 0
HEAD_MATRICES = {f"dis.mlp.layers.{i}.weight" for i in (0, 1)} | {
    f"dis.stat.fc.stat.layers.{i}.weight" for i in range(4)}


def _noise(jim, iv, key, cfg):
    shape = (cfg.batch_size, cfg.n, cfg.style_dim)
    return np.array(jim.apply(iv, method=lambda m: jax.random.normal(m.make_rng("noise"), shape),
                              rngs={"noise": key}), np.float32)


def _step_keys(n: int):
    """The JAX step's noise keys of steps 0 .. n-1 from ``rng=PRNGKey(7)``:
    rng, k_noise = split(fold_in(rng, step))."""
    rng, keys = jax.random.PRNGKey(7), []
    for step in range(n):
        rng, k = jax.random.split(jax.random.fold_in(rng, step))
        keys.append(k)
    return keys


def _jax_mesh_run(cfg, av, iv, batches, eval_batch=None, eval_key=None):
    """The JAX package's data 2 x model 2 step (``make_train_step_fn(..., mesh)``
    on ``param_shardings``), ``len(batches)`` times, then its eval step -> (the
    state's trees as numpy after each step, metrics a step, eval metrics or None).

    ``make_train_step`` jits the step and lets XLA choose the state's output
    shardings, which differ from ``param_shardings``' (421 leaves at this size), so
    its second call compiles again; here the output state keeps the input's
    shardings, and the two steps share one compile."""
    jau, jim = jax_build(cfg)
    jcfg = jax_cfg(cfg)
    opt_au, opt_im, _ = jimg.make_optimizers(jcfg)
    mesh = jmesh.create_mesh(jax.devices()[:WORLD], model_parallel=MP)
    assert dict(mesh.shape) == {"data": WORLD // MP, "model": MP}
    rep = jmesh.replicated_sharding(mesh)

    def put(tree, sharding=None):
        if sharding is None:
            return jax.tree.map(lambda x: jax.device_put(x, rep), tree)
        return jax.tree.map(jax.device_put, tree, sharding)

    state = GameState(
        step=jax.device_put(jnp.asarray(-1, jnp.int32), rep),
        params_au=put(av["params"], jmesh.param_shardings(av["params"], mesh, MIN_SIZE)),
        params_im=put(iv["params"], jmesh.param_shardings(iv["params"], mesh, MIN_SIZE)),
        spectral_au=put(av["spectral"]), spectral_im=put(iv["spectral"]),
        opt_au=put(opt_au.init(av["params"])), opt_im=put(opt_im.init(iv["params"])),
        rng=jax.device_put(jax.random.PRNGKey(7), rep))
    assert any(s.spec != P() for s in jax.tree.leaves(
        jax.tree.map(lambda x: x.sharding, state.params_au)))
    step = jax.jit(jimg.make_train_step_fn(jcfg, jau, jim, opt_au, opt_im, mesh),
                   out_shardings=(jax.tree.map(lambda x: x.sharding, state), rep, rep))
    metrics, trees = [], []
    for b in batches:
        state, m, _ = step(state, jmesh.shard_batch({k: jnp.asarray(v) for k, v in b.items()},
                                                     mesh))
        metrics.append({k: float(v) for k, v in m.items()})
        trees.append(types.SimpleNamespace(**{
            f"{k}_{p}": jax.tree.map(np.asarray, getattr(state, f"{k}_{p}"))
            for k in ("params", "spectral") for p in ("au", "im")}))
    if eval_batch is None:
        return trees, metrics, None
    ev = jax.jit(jimg.make_eval_step(jcfg, jau, jim, mesh))(
        state, jmesh.shard_batch({k: jnp.asarray(v) for k, v in eval_batch.items()}, mesh),
        eval_key)
    return trees, metrics, {k: float(v) for k, v in ev.items()}


def _trees_of(snapshot: dict):
    """A port snapshot (``local_snapshot``'s layout, whole) as the JAX state's trees."""
    out = {}
    for p in ("au", "im"):
        sd = {k[len(p) + 1:]: v for k, v in snapshot.items()
              if k.startswith(p + ".") and ".exp_avg" not in k}
        params, spectral = state_dict_to_flax(sd)
        out[f"params_{p}"], out[f"spectral_{p}"] = params, spectral
    return types.SimpleNamespace(**out)


def _jax_bn(module, variables, x, c):
    """``module`` with ``bn_axis_name="data"`` under ``shard_map`` over two CPU devices:
    (outputs, batch_stats, each device's parameter gradients [2, ...], input
    gradients) of <module(x), c> on each device's half."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("data",))

    def f(params, stats, x, c):
        def loss(params, x):
            out, upd = module.apply({"params": params, "batch_stats": stats}, x,
                                    mutable=["batch_stats"])
            return (out * c).sum(), (out, upd["batch_stats"])

        (_, (out, st)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            params, x)
        return out, st, jax.tree.map(lambda g: g[None], gp), gx

    fn = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(P(), P(), P("data"), P("data")),
                               out_specs=(P("data"), P(), P("data"), P("data")),
                               check_vma=False))
    out, st, gp, gx = fn(variables["params"], variables["batch_stats"], jnp.asarray(x),
                         jnp.asarray(c))
    return tuple(jax.tree.map(np.asarray, t) for t in (out, st, gp, gx))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _bn_inputs(rng):
    """The unit's and the 1-D BatchNorm's JAX variables (random statistics and
    scales) and inputs, and the Backbone's port weights and inputs."""
    unit = jarc.BottleneckIR(depth=UNIT["depth"], stride=UNIT["stride"], use_se=True,
                             bn_axis_name="data")
    x = rng.standard_normal((8, 8, 8, UNIT["in_channels"])).astype(np.float32)
    uv = jarc.BottleneckIR(depth=UNIT["depth"], stride=UNIT["stride"], use_se=True).init(
        jax.random.PRNGKey(1), jnp.asarray(x))
    uv = {k: _randomise(jax.tree.map(np.asarray, v), rng) for k, v in uv.items()}
    uc = rng.standard_normal((8, 4, 4, UNIT["depth"])).astype(np.float32)
    bn = flax_nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                           axis_name="data")
    bx = rng.standard_normal((8, 24)).astype(np.float32) * 3 + 1
    bv = {k: _randomise(v, rng) for k, v in (
        ("params", {"scale": np.ones(24, np.float32), "bias": np.zeros(24, np.float32)}),
        ("batch_stats", {"mean": np.zeros(24, np.float32), "var": np.ones(24, np.float32)}))}
    bc = rng.standard_normal((8, 24)).astype(np.float32)
    # PReLU slopes of 1: an activation within rounding of a PReLU kink takes the
    # other slope on one side, which moves every gradient in front of it by up to
    # 3e-2 of its largest entry (tests/test_torch_baselines.py's note; the first
    # draw here had one at 1.3e-8 of its layer's largest); the slopes' own
    # gradients stay, and at 1 the kink moves nothing
    torch.manual_seed(2)
    backbone = tarc.Backbone(**BACKBONE)
    with torch.no_grad():
        for m in backbone.modules():
            if isinstance(m, PReLU):
                m.alpha.fill_(1.0)
    krng = np.random.default_rng(BACKBONE_SEED)
    kx = torch.from_numpy(krng.standard_normal((8, 32, 32, 3)).astype(np.float32))
    kc = torch.from_numpy(krng.standard_normal((8, BACKBONE["emb_dim"])).astype(np.float32))
    return (unit, uv, x, uc), (bn, bv, bx, bc), (backbone, kx, kc)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tensor_parallel")
    rng = np.random.default_rng(0)
    cfgs = {name: small_cfg(batch_size=8, **kw) for name, kw in CASES.items()}
    _, jim, av, iv = init_jax_players(cfgs["reg0"])
    batches = [uint8_batch(cfgs["reg0"], seed=s) for s in BATCH_SEEDS]
    zs = [_noise(jim, iv, k, cfgs["reg0"]) for k in _step_keys(N_STEPS)]
    eval_batch, eval_key = uint8_batch(cfgs["reg0"], seed=EVAL_SEED), jax.random.PRNGKey(11)
    z_eval = _noise(jim, iv, eval_key, cfgs["reg0"])

    def tb(b):
        return {k: torch.from_numpy(v) for k, v in b.items()}

    dense, conv = Dense(*DENSE_SHAPE), Conv(*CONV_SHAPE, padding=1)
    snconv = SNConv(*CONV_SHAPE, padding=1)
    gen = torch.Generator().manual_seed(3)
    for m in (dense, conv, snconv):
        m.reset_parameters(gen)
    with torch.no_grad():
        for m in (dense, conv, snconv):
            m.bias.normal_(generator=gen)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    coll = {"kind": "collectives", "dense_shape": DENSE_SHAPE, "conv_shape": CONV_SHAPE,
            "dense": {"weights": dense.state_dict(), "x": t(5, 24), "c": t(5, 32)},
            "conv": {"weights": conv.state_dict(), "x": t(2, 8, 6, 6), "c": t(2, 32, 6, 6)},
            "snconv": {"weights": snconv.state_dict(), "x": t(2, 8, 6, 6), "c": t(2, 32, 6, 6)}}
    (unit, uv, ux, uc), (bn, bv, bx, bc), (backbone, kx, kc) = _bn_inputs(rng)
    tunit = tarc.BottleneckIR(**UNIT, use_se=True)
    tunit.load_state_dict({k: torch.from_numpy(v) for k, v in
                           flax_to_state_dict(uv["params"], uv["batch_stats"]).items()})
    tbn = BatchNorm(24)
    tbn.load_state_dict({k: torch.from_numpy(v) for k, v in
                         flax_to_state_dict(bv["params"], bv["batch_stats"]).items()})
    inputs = {
        **{name: {"kind": "image", "cfg": dataclasses.asdict(cfg), "min_size": MIN_SIZE,
                  "au": av, "im": iv, "steps": [(tb(b), torch.from_numpy(z))
                                                for b, z in zip(batches, zs)],
                  "eval": (tb(eval_batch), torch.from_numpy(z_eval)),
                  "ckpt_dir": str(root / name / "ckpts")}
           for name, cfg in cfgs.items()},
        "collectives": coll,
        "bn": {"kind": "synced_bn", "unit_shape": tuple(UNIT.values()),
               "unit": {"weights": tunit.state_dict(), "x": _nchw(ux), "c": _nchw(uc)},
               "bn1d": {"weights": tbn.state_dict(), "x": torch.from_numpy(bx),
                        "c": torch.from_numpy(bc)},
               "backbone": {"kwargs": BACKBONE, "weights": backbone.state_dict(), "x": kx,
                            "c": kc}},
    }
    job = root / "group"
    job.mkdir()
    torch.save(inputs, job / "inputs.pt")
    logs = [job / f"rank{r}.log" for r in range(WORLD)]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", WORLD_SIZE=str(WORLD))
    procs = []
    for r in range(WORLD):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(WORKER), str(job), str(MP)], cwd=REPO,
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=log,
                stderr=subprocess.STDOUT, start_new_session=True))
    try:
        # the JAX references and one process of the port, while the ranks run
        want = {}
        with concurrent.futures.ThreadPoolExecutor(len(cfgs)) as ex:
            jax_runs = {name: ex.submit(_jax_mesh_run, cfg, av, iv, batches,
                                        *((eval_batch, eval_key) if name == "reg0" else ()))
                        for name, cfg in cfgs.items()}
            jax_runs = {name: f.result() for name, f in jax_runs.items()}
        for name, cfg in cfgs.items():
            jtrees, jmetrics, jeval = jax_runs[name]
            state = torch_state_from(cfg, av, iv)
            metrics, snaps = [], []
            for b, z in zip(batches, zs):
                metrics.append({k: float(v) for k, v in
                                timg.train_step(state, b, z=torch.from_numpy(z.copy()))[0].items()})
                snaps.append(local_snapshot(state))
            ev = {k: float(v) for k, v in
                  timg.eval_step(state, eval_batch, z=torch.from_numpy(z_eval.copy())).items()}
            want[name] = {"jax": (jtrees, jmetrics, jeval), "one": (snaps, metrics, ev)}
        want["collectives"] = {}
        for name, module in (("dense", dense), ("conv", conv), ("snconv", snconv)):
            if name == "snconv":
                module.power_iterate_()
                want["collectives"]["snconv.u"] = module.u.clone()
                want["collectives"]["snconv.v"] = module.v.clone()
                want["collectives"]["snconv.sigma"] = (module.weight.reshape(32, -1) @ module.v
                                                       ).dot(module.u).detach()
            want["collectives"].update({f"{name}.{k}": v for k, v in
                                        _grads(module, coll[name]["x"], coll[name]["c"]).items()})
        want["unit"] = _jax_bn(unit, uv, ux, uc)
        want["bn1d"] = _jax_bn(bn, bv, bx, bc)
        want["backbone"] = _bn_grads(backbone, kx, kc)
        for p in procs:
            p.wait(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        pytest.fail(f"hung past {TIMEOUT} s: " + "\n".join(open(f).read()[-2000:] for f in logs))
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    assert [p.returncode for p in procs] == [0] * WORLD, "\n".join(
        open(f).read()[-3000:] for f in logs)
    ranks = [torch.load(job / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"ranks": ranks, "want": want, "cfgs": cfgs}


def _np(d: dict) -> dict:
    return {k: v.numpy() for k, v in d.items()}


def test_layout_is_the_jax_meshs_order(runs):
    # rank r: data index r // 2, model index r % 2 (np.array(devices).reshape(2, 2))
    assert [r["layout"] for r in runs["ranks"]] == [(r, r // MP, r % MP) for r in range(WORLD)]


def _assert_steps_equivalent(want_trees, want_metrics, got_trees, got_metrics):
    """``_assert_step_equivalent`` after the first step; after the later ones its
    metric and parameter tolerances."""
    assert len(got_metrics) == len(want_metrics) == N_STEPS
    _assert_step_equivalent(want_trees[0], got_trees[0], want_metrics[0], got_metrics[0])
    for want_t, got_t, want_m, got_m in zip(want_trees[1:], got_trees[1:], want_metrics[1:],
                                            got_metrics[1:]):
        assert set(want_m) == set(got_m)
        for k, w in want_m.items():
            tol = 1e-5 if k in _TIGHT_METRICS else 0.1
            np.testing.assert_allclose(got_m[k], w, rtol=tol, atol=tol, err_msg=f"metric {k}")
        _assert_trees_close(want_t.params_au, got_t.params_au, rtol=1e-4, atol=1e-5,
                            label="params_au")
        _assert_trees_close(want_t.params_im, got_t.params_im, rtol=1e-3, atol=5e-4,
                            label="params_im")


@pytest.mark.parametrize("name", list(CASES))
def test_data_model_step_matches_the_jax_mesh_step(runs, name):
    jtrees, jmetrics, _ = runs["want"][name]["jax"]
    got = runs["ranks"][0][name]
    if name == "r1":
        assert all(m["au_reg"] > 0 for m in got["metrics"])
    _assert_steps_equivalent(jtrees, jmetrics, [_trees_of(_np(w)) for w in got["whole"]],
                             got["metrics"])


@pytest.mark.parametrize("name", list(CASES))
def test_data_model_step_matches_one_process(runs, name):
    snaps, metrics, _ = runs["want"][name]["one"]
    got = runs["ranks"][0][name]
    _assert_steps_equivalent([_trees_of(_np(s)) for s in snaps], metrics,
                             [_trees_of(_np(w)) for w in got["whole"]], got["metrics"])
    # and the first step's gradients (the Adam first moments, beta1 = 0; Adam's step
    # does not see their scale, a gather that sums would show here as 2x): the
    # authenticator's with tests/test_torch_train_step.py's floors; the
    # impersonator's, which pass through the frozen authenticator's max pools and
    # set std, within IM_GRAD_FLOOR of each tensor's largest entry: at this size a
    # 1e-7 relative change of the weights flips a pool's argmax and moves them by
    # up to 1.1e-2 of it, and the sharded step's reordered sums flip such argmaxes
    # too (1.4e-2 measured; 3.1e-2 relative at one entry of a bias)
    whole = _np(got["whole"][0])
    for player in ("au", "im"):
        prefix = f"{player}.exp_avg."
        want = {k[len(prefix):]: v for k, v in _np(snaps[0]).items() if k.startswith(prefix)}
        floors = _grad_floors(want, player)
        if player == "im":
            largest = max(np.abs(v).max() for v in want.values())
            floors = {k: max(IM_GRAD_FLOOR * np.abs(v).max(), 1e-6 * largest)
                      for k, v in want.items()}
        for k, v in want.items():
            np.testing.assert_allclose(whole[prefix + k], v, rtol=1e-3, atol=floors[k],
                                       err_msg=prefix + k)


def test_eval_step_matches_the_jax_mesh_and_one_process(runs):
    got = runs["ranks"][0]["reg0"]["eval"]
    for want in (runs["want"]["reg0"]["jax"][2], runs["want"]["reg0"]["one"][2]):
        assert set(want) == set(got)
        for k, w in want.items():
            tol = 1e-5 if k in _TIGHT_METRICS else 0.1
            np.testing.assert_allclose(got[k], w, rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_replicated_tensors_equal_on_every_rank_and_slices_on_the_data_ranks(runs, name):
    ranks = runs["ranks"]
    sharded = {f"{p}.{pre}{n}" for p, names in ranks[0][name]["sharded"].items() for n in names
               for pre in ("", "exp_avg.", "exp_avg_sq.")}
    assert sharded and all(r[name]["sharded"] == ranks[0][name]["sharded"] for r in ranks)
    for r in ranks[1:]:
        a, b = ranks[0][name]["local"], r[name]["local"]
        same_model = r["layout"][2] == ranks[0]["layout"][2]
        assert a.keys() == b.keys()
        for k in a:
            if k in sharded and not same_model:
                assert a[k].shape == b[k].shape and not torch.equal(a[k], b[k]), k
            else:
                assert torch.equal(a[k], b[k]), (r["layout"], k)
        assert r[name]["metrics"] == ranks[0][name]["metrics"]


@pytest.mark.parametrize("name", list(CASES))
def test_checkpoint_from_the_sharded_state_loads_whole(runs, name):
    got = runs["ranks"][0][name]
    assert all(r[name]["ckpt"] == got["ckpt"] for r in runs["ranks"])
    cfg = runs["cfgs"][name]
    state = timg.create_state(cfg, *timg.build_models(cfg), cfg.seed, "cpu")
    step, _ = CheckpointIO(os.path.dirname(got["ckpt"])).load(got["ckpt"], state)
    assert step == N_STEPS - 1 and state.step == N_STEPS - 1
    loaded = local_snapshot(state)
    assert loaded.keys() == got["whole"][-1].keys()
    for k, v in loaded.items():
        assert torch.equal(v, got["whole"][-1][k]), k


def test_noise_and_batch_rows_follow_the_data_index(runs):
    # a model group's ranks take the same rows: those of their data index
    whole = torch.randn((8, 3), generator=torch.Generator().manual_seed(0))
    for r in runs["ranks"]:
        d = r["layout"][1]
        assert torch.equal(r["collectives"]["noise"], whole[4 * d:4 * d + 4])
        assert torch.equal(r["collectives"]["batch"], torch.arange(4 * d, 4 * d + 4))


@pytest.mark.parametrize("layer", ["dense", "conv", "snconv"])
def test_sharded_layer_matches_the_whole_weight(runs, layer):
    want = runs["want"]["collectives"]
    keys = [k for k in want if k.startswith(layer + ".")]
    assert any(".g2." in k for k in keys)
    for r in runs["ranks"]:
        got, m = r["collectives"], r["layout"][2]
        for k in keys:
            w = want[k]
            g = got[k]
            if k.endswith(".weight"):  # this rank's rows
                c = w.shape[0] // MP
                assert g.shape[0] == c
                w = w[m * c:(m + 1) * c]
            assert g.shape == w.shape, k
            scale = max(float(want[k].abs().max()), 1e-30)
            assert float((g - w).abs().max()) <= 1e-5 * scale, (k, r["layout"])


@pytest.mark.parametrize("module", ["unit", "bn1d"])
def test_synced_batchnorm_matches_jax_under_shard_map(runs, module):
    out, stats, grads, gx = runs["want"][module]
    want_stats = flax_to_state_dict({}, stats)
    for r in runs["ranks"]:
        got, d = r["bn"][module], r["layout"][1]
        half = out.shape[0] // 2
        y = got["y"].numpy()
        want_y = out[d * half:(d + 1) * half]
        want_x = gx[d * half:(d + 1) * half]
        if y.ndim == 4:
            want_y, want_x = want_y.transpose(0, 3, 1, 2), want_x.transpose(0, 3, 1, 2)
        np.testing.assert_allclose(y, want_y, rtol=0, atol=BN_TOL * np.abs(want_y).max())
        want_g = flax_to_state_dict(jax.tree.map(lambda g: g[d], grads), {})
        got_g = {k: v.numpy() for k, v in got["grads"].items()}
        assert set(got_g) == set(want_g) | {"x"}
        for k, w in {**want_g, "x": want_x}.items():
            np.testing.assert_allclose(got_g[k], w, rtol=0, atol=BN_TOL * np.abs(w).max(),
                                       err_msg=k)
        assert set(got["stats"]) == set(want_stats)
        for k, w in want_stats.items():
            np.testing.assert_allclose(got["stats"][k].numpy(), w, rtol=0,
                                       atol=STATS_TOL * np.abs(w).max(), err_msg=k)


def test_synced_backbone_over_two_halves_is_the_unsynced_one_on_the_whole_batch(runs):
    want = runs["want"]["backbone"]
    data_ranks = [r for r in runs["ranks"] if r["layout"][2] == 0]
    y = torch.cat([r["bn"]["backbone"]["y"] for r in data_ranks])
    np.testing.assert_allclose(y.numpy(), want["y"].numpy(), rtol=0,
                               atol=BN_TOL * float(want["y"].abs().max()))
    # a gradient that is rounding noise (a BatchNorm's bias before another's) is
    # held to 1e-6 of the model's largest gradient entry, as _grad_floors does
    floor = 1e-6 * max(float(w.abs().max()) for w in want["grads"].values())
    for k, w in want["grads"].items():
        parts = [r["bn"]["backbone"]["grads"][k] for r in data_ranks]
        g = torch.cat(parts) if k == "x" else sum(parts)
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=max(BN_TOL * float(w.abs().max()), floor), err_msg=k)
    assert want["stats"]
    stats_floor = 1e-6 * max(float(w.abs().max()) for w in want["stats"].values())
    for k, w in want["stats"].items():
        for r in data_ranks:
            np.testing.assert_allclose(r["bn"]["backbone"]["stats"][k].numpy(), w.numpy(),
                                       rtol=0, atol=max(STATS_TOL * float(w.abs().max()),
                                                        stats_floor), err_msg=k)


def test_synced_batchnorm_on_one_rank_is_the_unsynced_one():
    gen = torch.Generator().manual_seed(0)
    x, c = torch.randn(6, 5, 3, 3, generator=gen), torch.randn(6, 5, 3, 3, generator=gen)
    plain, synced = BatchNorm(5), BatchNorm(5, axis_name="data")
    a, b = _bn_grads(plain, x, c), _bn_grads(synced, x, c)
    assert torch.equal(a["y"], b["y"])
    assert all(torch.equal(a["grads"][k], b["grads"][k]) for k in a["grads"])
    assert all(torch.equal(a["stats"][k], b["stats"][k]) for k in a["stats"])
    with pytest.raises(ValueError):
        BatchNorm(5, axis_name="model")(x)


def _jax_sharded_names(jparams, min_size: int) -> set:
    """The port's names of the leaves the JAX rule splits over a 2-wide model axis
    (each leaf mapped through the transplant as a stand-in of its leading dim)."""
    mesh = jmesh.create_mesh(jax.devices()[:WORLD], model_parallel=MP)
    specs = jmesh.param_shardings(jparams, mesh, min_size)
    stand_in = jax.tree.map(
        lambda leaf, s: np.full((leaf.shape[0],) + (1,) * (len(leaf.shape) - 1),
                                float(s.spec != P()), np.float32), jparams, specs)
    return {k for k, v in flax_to_state_dict(stand_in, {}).items() if v.all()}


@pytest.mark.parametrize("config", ["flagship", "small"])
def test_param_shardings_picks_the_jax_rules_leaves(config):
    if config == "flagship":
        cfg, min_size = ImageGameConfig(), 1024
    else:
        cfg, min_size = small_cfg(), MIN_SIZE
    jau, jim = jax_build(cfg)
    jstate = jax.eval_shape(lambda k: jimg.create_state(jax_cfg(cfg), jau, jim, k)[0],
                            jax.random.PRNGKey(0))
    with torch.device("meta"):
        au, im = timg.build_models(cfg)
    layout = tmesh.Mesh(tmesh.Axis(0, WORLD // MP), tmesh.Axis(0, MP))
    for player, module, jparams in (("au", au, jstate.params_au), ("im", im, jstate.params_im)):
        rule = tmesh.param_shardings(module, layout, min_size)
        assert set(rule) == {k for k, _ in module.named_parameters()}
        got = {k for k, d in rule.items() if d is not None}
        want = _jax_sharded_names(jparams, min_size)
        # the one difference: the JAX tree stacks the encoder pair's and the AdaIN res
        # blocks' biases into 2-D leaves its rule may split; the port's are 1-D, whole
        stacked_biases = {k for k in want if k.endswith(".bias")}
        assert all(k.startswith(("encoders.", "img2img.adain_res_block.res_"))
                   for k in stacked_biases), stacked_biases
        assert got == want - stacked_biases, (player, got ^ (want - stacked_biases))
        if config == "flagship":
            assert got == (HEAD_MATRICES if player == "au" else set())
            assert not stacked_biases
        else:
            assert len(got) > 10 and stacked_biases
        # without a model axis nothing is split
        assert not any(tmesh.param_shardings(module, tmesh.Mesh(tmesh.Axis(), tmesh.Axis()),
                                             min_size).values())
