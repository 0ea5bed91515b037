"""The port's baseline authenticators against the JAX package, on the CPU.

* Scores: the Siamese (img 16 and 32, where the 2x2 last map checks the
  flatten order) and ArcFace (img 32, 50 layers, ir_se) eval closures, and
  the simple embedding nets (28 px, a 4x4 map into a dense layer), give
  the JAX closures' scores within 1e-4 on transplanted weights with random
  BatchNorm statistics, scales and PReLU slopes.
* One training step of each recipe (ArcFace with dropout 0, Siamese random
  pairs and batch-hard mining): the gradients within 1e-4 of each tensor's
  largest entry (the JAX step run with an optimizer that hands the gradient
  back as its state), and the BatchNorm running mean and variance, Flax's
  update with the biased batch variance, within 1e-5 of each tensor's
  largest entry.
* ``ArcfaceDataSet`` and ``list_files_rec``: the same images and labels as the
  JAX package's from one seed.
* The baseline CLIs take the JAX CLIs' flags and defaults plus ``--device``;
  the ArcFace CLI trains and checkpoints on the CPU, and the eval loads it.
"""

import argparse
import copy
import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from optimalstrategiesagainstgenerativeattacks_torch.baselines import siamese as tsiamese
from optimalstrategiesagainstgenerativeattacks_torch.baselines import training as ttrain
from optimalstrategiesagainstgenerativeattacks_torch.data import episodic as tdata
from optimalstrategiesagainstgenerativeattacks_torch.data.utils import list_files_rec
from optimalstrategiesagainstgenerativeattacks_torch.eval import authentication as tauth
from optimalstrategiesagainstgenerativeattacks_torch.port.transplant import (
    flax_to_state_dict,
    load_flax,
    state_dict_to_flax,
)
from optimalstrategiesagainstgenerativeattacks_tpu.baselines import training as jtrain
from optimalstrategiesagainstgenerativeattacks_tpu.baselines.arcface import ArcFace, Backbone
from optimalstrategiesagainstgenerativeattacks_tpu.baselines import siamese as jsiamese
from optimalstrategiesagainstgenerativeattacks_tpu.baselines.siamese import (
    ProtonetEmbeddingNet,
    SiameseNet,
)
from optimalstrategiesagainstgenerativeattacks_tpu.data import episodic as jdata
from optimalstrategiesagainstgenerativeattacks_tpu.data.utils import (
    list_files_rec as jlist_files_rec,
)
from optimalstrategiesagainstgenerativeattacks_tpu.eval import authentication as jauth

torch.set_num_threads(1)

TOL = 1e-4
EMB = 64  # ArcFace embedding width at the test size
N_CLASSES = 5


def _randomise(tree, rng):
    """Copy of a Flax tree with BatchNorm scale/bias/mean/var and PReLU slopes random."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomise(v, rng)
        elif k in ("scale", "var"):
            out[k] = rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
        elif k == "alpha" or (k in ("bias", "mean") and ("scale" in tree or "var" in tree)):
            out[k] = (0.3 * rng.standard_normal(np.shape(v))).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _jax_init(model, x, *args, seed=0):
    key = jax.random.PRNGKey(seed)
    v = model.init({"params": key, "dropout": key}, x, *args)
    rng = np.random.default_rng(seed + 1)
    return {"params": _randomise(jax.tree.map(np.asarray, v["params"]), rng),
            "batch_stats": _randomise(jax.tree.map(np.asarray, v["batch_stats"]), rng)}


def _siamese(img: int):
    enc = ProtonetEmbeddingNet(1, img)
    jmodel = SiameseNet(embedding_net=enc, embedding_dim=enc.embedding_dim)
    x = jnp.zeros((2, img, img, 1))
    variables = _jax_init(jmodel, x, x)
    model = ttrain.build_siamese(1, img)
    load_flax(model, variables["params"], variables["batch_stats"])
    return jmodel, variables, model


def _arcface(dropout: float = 0.0):
    cfg = dict(num_layers=50, dropout=dropout, img_size=32, img_channels=1, emb_dim=EMB, th=1.5)
    backbone = Backbone(num_layers=50, drop_ratio=dropout, mode="ir_se", img_size=32,
                        img_channels=1, emb_dim=EMB)
    jmodel = ArcFace(emb_model=backbone, embedding_size=EMB, n_classes=N_CLASSES, th=1.5)
    variables = _jax_init(jmodel, jnp.zeros((2, 32, 32, 1)), jnp.zeros((2,), jnp.int32))
    model = ttrain.build_arcface(cfg, N_CLASSES)
    load_flax(model, variables["params"], variables["batch_stats"])
    return jmodel, variables, model


@pytest.fixture(scope="module")
def arcface():
    return _arcface()


def _episodes(img: int, seed: int, b: int = 2, n: int = 3, k: int = 2):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (b, n, img, img, 1)).astype(np.float32),
            rng.uniform(-1, 1, (b, k, img, img, 1)).astype(np.float32))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def test_transplant_round_trips_the_baseline_trees(arcface):
    _, variables, model = arcface
    params, stats = state_dict_to_flax(model.state_dict())
    assert jax.tree.structure(params) == jax.tree.structure(variables["params"])
    assert jax.tree.structure(stats) == jax.tree.structure(variables["batch_stats"])
    back = flax_to_state_dict(params, stats)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(back[k], v.numpy())
    assert params["head"]["kernel"].shape == (EMB, N_CLASSES)


@pytest.mark.parametrize("img", [16, 32])
def test_siamese_scores_match_jax(img):
    jmodel, variables, model = _siamese(img)
    test, si = _episodes(img, seed=img)
    want = jauth.get_siamese_au_function(jmodel, variables)(test, si)
    got = tauth.get_siamese_au_function(model, "cpu")(torch.from_numpy(test), torch.from_numpy(si))
    _close(got.reshape(-1), want)


@pytest.mark.parametrize("name", ["SimpleEmbeddingNet", "SimpleEmbeddingNetL2"])
def test_simple_embedding_nets_match_jax(name):
    x = np.random.default_rng(1).uniform(-1, 1, (3, 28, 28, 1)).astype(np.float32)
    jnet = getattr(jsiamese, name)()
    params = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    params = _randomise(params, np.random.default_rng(2))  # the PReLU slopes
    net = getattr(tsiamese, name)()
    load_flax(net, params, {})
    with torch.no_grad():
        _close(net(torch.from_numpy(x)).numpy(), jnet.apply({"params": params}, x))


def test_arcface_scores_match_jax(arcface):
    jmodel, variables, model = arcface
    test, si = _episodes(32, seed=3)
    want = jauth.get_arcface_au_function(jmodel, variables)(test, si)
    got = tauth.get_arcface_au_function(model, "cpu")(torch.from_numpy(test), torch.from_numpy(si))
    _close(got, want)


def _grads_as_state():
    """An optax transformation whose state after a step is that step's gradient."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _assert_step_matches(model, jgrads, jstats):
    """Each gradient within TOL of its tensor's largest entry, plus 1e-5 of the
    model's largest entry: a bias in front of a BatchNorm (every residual
    unit's, ``out_dense``'s) has a gradient that is zero in exact arithmetic,
    so both sides hold rounding noise there.  The running statistics within
    1e-5 of each tensor's largest entry."""
    grads = flax_to_state_dict(jax.tree.map(np.asarray, jgrads), {})
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(grads)
    floor = 1e-5 * max(np.abs(g).max() for g in grads.values())
    for k, want in grads.items():
        err = np.abs(got[k].numpy() - want).max()
        assert err <= TOL * np.abs(want).max() + floor, (k, err, np.abs(want).max())
    stats = flax_to_state_dict({}, jax.tree.map(np.asarray, jstats))
    buffers = dict(model.named_buffers())
    assert set(stats) == set(buffers)
    for k, want in stats.items():
        err = np.abs(buffers[k].numpy() - want).max()
        assert err <= 1e-5 * np.abs(want).max(), (k, err, np.abs(want).max())


def _uint8(rng, shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)


def test_arcface_train_step_matches_jax(arcface):
    jmodel, variables, model = arcface
    model = copy.deepcopy(model)  # the step changes the weights
    # an activation within rounding of a PReLU or ReLU kink may take the other
    # slope on one side in f32, which moves every gradient in front of it by
    # up to 1e-2 of its largest entry: 3 of 6 batches drawn here have one,
    # this one none (the step on either side is deterministic on one CPU)
    rng = np.random.default_rng(10)
    batch = {"image": _uint8(rng, (4, 32, 32, 1)), "label": np.array([0, 3, 1, 3], np.int32)}
    jstep = jtrain.make_arcface_train_step(jmodel, _grads_as_state())
    jvars, jgrads, _ = jstep(variables, _grads_as_state().init(variables["params"]), batch,
                             jax.random.PRNGKey(0))
    step = ttrain.make_arcface_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3))
    step(batch)
    _assert_step_matches(model, jgrads, jvars["batch_stats"])


@pytest.mark.parametrize("mining", ["random", "batch_hard"])
def test_siamese_train_step_matches_jax(mining):
    jmodel, variables, model = _siamese(16)
    rng = np.random.default_rng(6)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    jopt = _grads_as_state()
    # op by op: XLA's CPU compile of the whole JAX step gives the conv biases
    # in front of each BatchNorm gradients up to 0.12 (of 0.3 the largest
    # entry) where exact arithmetic gives 0; run op by op, the JAX step
    # gives ~1e-7 there and agrees with the port everywhere
    with jax.disable_jit():
        jvars, jgrads = _jax_siamese_step(jmodel, variables, jopt, mining, rng, model, opt)
    _assert_step_matches(model, jgrads, jvars["batch_stats"])


def _jax_siamese_step(jmodel, variables, jopt, mining, rng, model, opt):
    """One step of ``mining`` on both sides from one drawn batch; returns JAX's
    (variables, gradients)."""
    if mining == "random":
        batch = {key: _uint8(rng, (3, s, 16, 16, 1))
                 for key, s in (("real_sample", 2), ("si_sample", 2), ("leaked_sample", 1))}
        x1, x2, y = ttrain._siamese_pairs(batch, np.random.default_rng(7))
        jx1, jx2, jy = jtrain._siamese_pairs(batch, np.random.default_rng(7))
        for a, b in ((x1, jx1), (x2, jx2), (y, jy)):
            np.testing.assert_array_equal(a, b)
        jvars, jgrads, _ = jtrain.make_siamese_train_step(jmodel, jopt)(
            variables, jopt.init(variables["params"]), x1, x2, y)
        ttrain.make_siamese_train_step(model, opt)(x1, x2, y)
    else:
        pool = _uint8(rng, (3, 4, 16, 16, 1))
        jvars, jgrads, _ = jtrain.make_siamese_batchhard_step(jmodel, jopt)(
            variables, jopt.init(variables["params"]), pool)
        ttrain.make_siamese_batchhard_step(model, opt)(pool)
    return jvars, jgrads


@pytest.fixture(scope="module")
def class_tree(tmp_path_factory):
    """train/<identity>/<video>/*.jpg: three identities, two videos of two images."""
    from PIL import Image

    root = tmp_path_factory.mktemp("arcface_ds")
    rng = np.random.default_rng(0)
    for c in range(3):
        for v in range(2):
            d = root / "train" / f"id{c}" / f"v{v}"
            d.mkdir(parents=True)
            for i in range(2):
                Image.fromarray(_uint8(rng, (20, 20))).save(str(d / f"{i}.jpg"))
    return str(root)


def test_arcface_dataset_matches_jax(class_tree):
    assert list_files_rec(class_tree, ".jpg") == jlist_files_rec(class_tree, ".jpg")
    kw = dict(root=class_tree, split="train", img_channels=1, img_size=32,
              example_cnt_per_class=3, seed=4)
    ours, theirs = tdata.ArcfaceDataSet(**kw), jdata.ArcfaceDataSet(**kw)
    assert (len(ours), ours.n_classes) == (len(theirs), theirs.n_classes) == (9, 3)
    for i in range(len(ours)):
        (a, la), (b, lb) = ours[i], theirs[i]
        np.testing.assert_array_equal(a, b)
        assert la == lb == i // 3


def _jax_parser(module_name: str) -> argparse.ArgumentParser:
    """The parser a JAX package CLI's ``get_args`` builds."""
    captured = {}
    orig, saved = argparse.ArgumentParser.parse_args, sys.argv

    def spy(self, *a, **k):
        captured["parser"] = self
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = spy
    sys.argv = [module_name]
    try:
        importlib.import_module(module_name).get_args()
    except SystemExit:
        pass
    finally:
        argparse.ArgumentParser.parse_args, sys.argv = orig, saved
    return captured["parser"]


@pytest.mark.parametrize("ours, theirs, required", [
    ("eval_gim_on_authentication", "optimalstrategiesagainstgenerativeattacks_tpu.eval.authentication",
     ["--ds_root", "ds", "--gim_exp_dir", "exp"]),
    ("train_siamese_baseline", "train_siamese_baseline", ["--dataset_root", "ds"]),
    ("train_arcface_baseline", "train_arcface_baseline", ["--dataset_root", "ds"]),
])
def test_cli_flags_and_defaults_are_the_jax_clis(ours, theirs, required):
    port = importlib.import_module(
        f"optimalstrategiesagainstgenerativeattacks_torch.{ours}").build_parser()
    jax_parser = _jax_parser(theirs)
    flags = {s for a in port._actions for s in a.option_strings}
    jax_flags = {s for a in jax_parser._actions for s in a.option_strings}
    assert flags - {"--device"} == jax_flags
    got, want = vars(port.parse_args(required)), vars(jax_parser.parse_args(required))
    assert got.pop("device") == "cuda"
    # the JAX eval CLI writes into its package directory; the port's into the cwd
    if "csv_file_path" in got:
        assert got.pop("csv_file_path") == "results.csv"
        want.pop("csv_file_path")
    assert got == want


def test_arcface_cli_trains_on_the_cpu_and_the_eval_loads_it(class_tree, tmp_path):
    from optimalstrategiesagainstgenerativeattacks_torch import train_arcface_baseline
    from optimalstrategiesagainstgenerativeattacks_torch.train.checkpoints import get_latest_ckpt
    from optimalstrategiesagainstgenerativeattacks_torch.utils.config import load_args

    out = tmp_path / "arc"
    model, metrics = train_arcface_baseline.main([
        "--dataset_root", class_tree, "-o", str(out), "--device", "cpu", "--emb_dim", str(EMB),
        "--batch_size", "2", "--n_epochs", "1", "--example_cnt_per_class", "1", "--save_every",
        "1", "--dropout", "0.1"])
    assert np.isfinite(metrics["loss"])
    # 3 identities x 1 example, batch 2: one step per epoch
    assert sorted(p.name for p in (out / "ckpts").iterdir()) == ["model_00000001"]
    args = load_args(str(out))
    assert args["device"] == "cpu" and args["emb_dim"] == EMB
    au = tauth.get_arcface_authenticator(get_latest_ckpt(str(out / "ckpts")), args, "cpu")
    test = np.zeros((2, 3, 32, 32, 1), np.float32)
    out_, pred = au.act(test_sample=test, si_sample=test[:, :2])
    np.testing.assert_allclose(out_, 0.0, atol=1e-5)  # identical mean images
    assert pred.shape == (2,) and au.th == 1.5
