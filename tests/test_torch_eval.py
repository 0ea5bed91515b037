"""The port's authentication evaluation against the JAX package, on the CPU.

* Scorer: ``comp_acc``, the calibration thresholds, ``acc_at_threshold`` and
  the wrap-around padding give the JAX package's floats on seeded inputs
  with ties; ``roc_auc`` (average ranks) equals ``sklearn``'s
  ``roc_auc_score`` to 1e-12.
* Attackers: replay and random-source give the JAX package's arrays under
  the same ``numpy.random.Generator``.
* ``eval_authenticator_and_impersonator`` with an oracle authenticator: the
  same (acc, acc_on_fake, acc_on_real, auc) and the same padded call shapes.
* GIM agents at img 16, style 32 on the grid's checkpoint and its JAX twin:
  the authenticator's scores, and the impersonator's fakes with z injected,
  within 1e-4.
* The grid: a PNG tree written here, the port's training CLIs (``-dbg``) for
  a GIM and a Siamese checkpoint, their weights carried into JAX
  checkpoints, then the port's eval CLI (with ``--calibrate_q``,
  ``--dump_scores_dir`` and a ``--specific_model`` the Siamese directory
  lacks) and the JAX package's ``eval_authentication_task``: the CSVs read
  back with ``pandas.read_csv(index_col=0)`` hold the same frame, rows of
  the replay and random-source attackers with equal accuracies and AUCs
  within 1e-5.  ``scripts/torch_import_jax_ckpt.py`` turns the JAX
  directories back into the port's checkpoints.
"""

import importlib
import importlib.util
import os
import shutil

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.metrics import roc_auc_score

from optimalstrategiesagainstgenerativeattacks_torch.eval import agents as tagents
from optimalstrategiesagainstgenerativeattacks_torch.eval import authentication as tauth
from optimalstrategiesagainstgenerativeattacks_torch.eval import scorer as tscorer
from optimalstrategiesagainstgenerativeattacks_torch.port.transplant import state_dict_to_flax
from optimalstrategiesagainstgenerativeattacks_tpu.eval import agents as jagents
from optimalstrategiesagainstgenerativeattacks_tpu.eval import authentication as jauth
from optimalstrategiesagainstgenerativeattacks_tpu.eval import scorer as jscorer
from test_eval import _ArrayDS
from test_torch_support import REPO

torch.set_num_threads(1)

TOL = 1e-4


def _scores(seed: int, n: int = 40):
    """Real and fake scores with ties inside and across the two sets."""
    rng = np.random.default_rng(seed)
    real = np.round(rng.normal(0.3, 1.0, n), 1).astype(np.float32)
    fake = np.round(rng.normal(-0.3, 1.0, n), 1).astype(np.float32)
    return real, fake


@pytest.mark.parametrize("name", ["comp_acc", "real_quantile_threshold", "balanced_threshold",
                                  "acc_at_threshold", "_pad_to"])
def test_scorer_helpers_match_jax(name):
    real, fake = _scores(0)
    args = {
        "comp_acc": ((real >= 0).astype(np.int64), (fake >= 0).astype(np.int64)),
        "real_quantile_threshold": (real, 0.9),
        "balanced_threshold": (real, fake),
        "acc_at_threshold": (real, fake, 0.1),
        "_pad_to": (real.reshape(8, 5), 19),
    }[name]
    got, want = getattr(tscorer, name)(*args), getattr(jscorer, name)(*args)
    if name == "_pad_to":
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_roc_auc_matches_sklearn(seed):
    real, fake = _scores(seed, n=30 + 17 * seed)
    fake = fake[: 20 + seed]  # classes of unequal size
    labels = np.concatenate([np.ones_like(real), np.zeros_like(fake)])
    scores = np.concatenate([real, fake])
    assert len(np.unique(scores)) < len(scores)  # ties
    assert abs(tscorer.roc_auc(labels, scores) - roc_auc_score(labels, scores)) <= 1e-12
    with pytest.raises(ValueError):
        tscorer.roc_auc(np.ones_like(real), real)


@pytest.mark.parametrize("attacker", ["replay", "rnd_src"])
def test_attackers_match_jax(attacker):
    leaked = np.random.default_rng(0).uniform(-1, 1, (3, 4, 16, 16, 1)).astype(np.float32)
    if attacker == "replay":
        want = jagents.replay_impersonator(leaked, 5, np.random.default_rng(3))
        got = tagents.replay_impersonator(leaked, 5, np.random.default_rng(3))
        on_device = tagents.replay_impersonator(torch.from_numpy(leaked), 5,
                                                np.random.default_rng(3))
        np.testing.assert_array_equal(on_device.numpy(), want)
    else:
        want = jagents.rand_source_impersonator(leaked, 2, _ArrayDS(), np.random.default_rng(3))
        got = tagents.rand_source_impersonator(leaked, 2, _ArrayDS(), np.random.default_rng(3))
    np.testing.assert_array_equal(got, want)


def test_scorer_with_an_oracle_matches_jax():
    """tests/test_eval.py's oracle on 5 episodes in batches of 2: the same
    result, and every call of either side padded to 2 episodes."""
    shapes = {"jax": [], "port": []}

    def oracle(side, mean):
        def score(test_sample, si_sample):
            shapes[side].append(tuple(test_sample.shape))
            return 0.1 - abs(mean(test_sample) - mean(si_sample))
        return score

    def bright(leaked_sample, n):
        return np.ones((leaked_sample.shape[0], n, 16, 16, 1), np.float32)

    want = jscorer.eval_authenticator_and_impersonator(
        ds=_ArrayDS(n_classes=5, examples=1), batch_size=2,
        authenticator=jagents.Authenticator(oracle("jax", lambda x: np.asarray(x).mean(
            axis=(1, 2, 3, 4)))),
        impersonator=jagents.Impersonator(bright), return_scores=True)
    got = tscorer.eval_authenticator_and_impersonator(
        ds=_ArrayDS(n_classes=5, examples=1), batch_size=2,
        authenticator=tagents.Authenticator(oracle("port", lambda x: torch.as_tensor(x).mean(
            dim=(1, 2, 3, 4)))),
        impersonator=tagents.Impersonator(bright), return_scores=True, device="cpu")
    assert got[:4] == pytest.approx(want[:4], abs=1e-12)
    for a, b in zip(got[4], want[4]):
        np.testing.assert_allclose(a, b, atol=1e-6)
    assert shapes["port"] == shapes["jax"] == [(2, 2, 16, 16, 1)] * 6


def test_gim_agents_match_jax(grid):
    """The port's GIM closures on the grid's checkpoint against the JAX package's
    on its transplanted twin, at the grid's batch of 3 episodes."""
    _, d = grid
    port_ckpt, port_args = tauth.get_exp_args_from_dir(str(d["gim"]))
    jax_ckpt, jax_args = jauth.get_exp_args_from_dir(str(d["jax_gim"]))
    cfg, _, _, state = tauth._restore_gim_state(port_ckpt, port_args, "cpu")
    _, jau, jim, jstate = jauth._restore_gim_state(jax_ckpt, jax_args)
    rng = np.random.default_rng(4)
    s = cfg.img_size
    test = rng.uniform(-1, 1, (3, cfg.n, s, s, 1)).astype(np.float32)
    si = rng.uniform(-1, 1, (3, cfg.k, s, s, 1)).astype(np.float32)
    leaked = rng.uniform(-1, 1, (3, cfg.m, s, s, 1)).astype(np.float32)
    z = rng.standard_normal((3, cfg.n, cfg.style_dim)).astype(np.float32)

    want = jauth.get_gim_authenticator(jax_ckpt, jax_args).act(test, si)[0]
    got = tauth.get_gim_authenticator(port_ckpt, port_args, "cpu").act(test, si)[0]
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    im_vars = {"params": jstate.params_im, "spectral": jstate.spectral_im}
    want_fake = np.asarray(jim.apply(im_vars, leaked, cfg.n, True, False, z=z))
    im_fn = tauth.get_gim_impersonator(port_ckpt, port_args, "cpu").im_model_func
    np.testing.assert_allclose(im_fn(leaked, z=z).numpy(), want_fake, atol=TOL, rtol=TOL)
    # without z the generator on the device draws, and every call draws afresh
    a, b = im_fn(leaked), im_fn(leaked)
    assert a.shape == want_fake.shape and not torch.equal(a, b)


def _condition(port_dir, ckpt_name: str) -> None:
    """Give the checkpoint's InstanceNorm affines and attention gammas random values.

    After two steps they still sit near (1, 0) and 0: the attention branch
    then adds almost nothing, and the env decoder's spatially constant maps
    meet near-zero-variance instance norms that amplify rounding noise.
    """
    from optimalstrategiesagainstgenerativeattacks_torch.nn.blocks import (
        InstanceNorm,
        SelfAttention,
    )
    from optimalstrategiesagainstgenerativeattacks_torch.train.image import build_models
    from optimalstrategiesagainstgenerativeattacks_torch.utils.config import ImageGameConfig

    path = port_dir / "ckpts" / ckpt_name
    payload = torch.load(path, weights_only=True)
    players = build_models(ImageGameConfig.from_dict(tauth.load_args(str(port_dir))))
    gen = torch.Generator().manual_seed(0)
    for key, module in zip(("au", "im"), players):
        sd = payload[key]
        for name, m in module.named_modules():
            if isinstance(m, InstanceNorm):
                sd[f"{name}.weight"] = 1.0 + 0.5 * torch.randn(m.weight.shape, generator=gen)
                sd[f"{name}.bias"] = 0.5 * torch.randn(m.bias.shape, generator=gen)
            elif isinstance(m, SelfAttention):
                sd[f"{name}.gamma"] = 0.5 * torch.randn(m.gamma.shape, generator=gen)
    torch.save(payload, path)


def _jax_gim_dir(port_dir, jax_dir, ckpt_name: str) -> None:
    """A JAX experiment directory holding the port checkpoint's players."""
    from optimalstrategiesagainstgenerativeattacks_tpu.train import image as jimage
    from optimalstrategiesagainstgenerativeattacks_tpu.train.checkpoints import CheckpointIO
    from optimalstrategiesagainstgenerativeattacks_tpu.utils import config as jconfig

    args = jconfig.load_args(str(port_dir))
    jconfig.save_args(args, str(jax_dir))
    jcfg = jconfig.ImageGameConfig.from_dict(args)
    jau, jim = jimage.build_models(jcfg)
    template, _, _, _ = jimage.create_state(jcfg, jau, jim, jax.random.PRNGKey(0))
    payload = torch.load(port_dir / "ckpts" / ckpt_name, weights_only=True)
    (pa, sa), (pi, si) = state_dict_to_flax(payload["au"]), state_dict_to_flax(payload["im"])
    state = template.replace(params_au=pa, spectral_au=sa, params_im=pi, spectral_im=si)
    CheckpointIO(str(jax_dir / "ckpts")).save(state, payload["global_step"],
                                               payload["last_epoch"])


def _jax_siamese_dir(port_dir, jax_dir, ckpt_name: str) -> None:
    import orbax.checkpoint as ocp

    shutil.copytree(port_dir, jax_dir, ignore=shutil.ignore_patterns("model_*"))
    payload = torch.load(port_dir / "ckpts" / ckpt_name, weights_only=True)
    params, stats = state_dict_to_flax(payload["model"])
    ocp.PyTreeCheckpointer().save(str(jax_dir / "ckpts" / ckpt_name),
                                  {"model": {"params": params, "batch_stats": stats}})


def _write_omniglot_tree(root) -> str:
    """<split>/<alphabet>/<character>/*.png: two alphabets of two characters,
    12 noise images each (20x20).  With 12 images a random-source fake rarely
    repeats the real sample it is scored beside, whose equal scores the two
    packages may round apart."""
    from PIL import Image

    rng = np.random.default_rng(0)
    for split in ("train", "val"):
        for a in range(2):
            for c in range(2):
                d = root / split / f"a{a}" / f"c{c}"
                d.mkdir(parents=True)
                for i in range(12):
                    Image.fromarray(rng.integers(0, 256, (20, 20), dtype=np.uint8)).save(
                        str(d / f"{i:02d}.png"))
    return str(root)


EVAL_ARGS = ["--img_size", "16", "--n", "2", "--k", "2", "--batch_size", "3",
             "--num_workers", "0", "--example_cnt_per_class", "2", "--calibrate_q", "0.9"]


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """Port-trained GIM and Siamese directories, their JAX twins, and both grids."""
    from optimalstrategiesagainstgenerativeattacks_torch import (
        eval_gim_on_authentication,
        train_gim_on_imgs,
        train_siamese_baseline,
    )

    root = tmp_path_factory.mktemp("grid")
    tree = _write_omniglot_tree(root / "ds")
    d = {name: root / name for name in ("gim", "siam", "jax_gim", "jax_siam")}
    train_gim_on_imgs.main([
        "--dataset_root", tree, "-o", str(d["gim"]), "--device", "cpu", "-dbg",
        "--img_size", "16", "--style_dim", "32", "--batch_size", "2", "--n", "2", "--k", "2",
        "--ds_n_examples_per_cls", "1", "--n_epochs", "1", "--num_workers", "0",
        "--compute_dtype", "float32", "--save_every", "1", "--eval_every", "100",
        "--save_imgs_every", "100", "--log_every", "1"])
    train_siamese_baseline.main([
        "--dataset_root", tree, "-o", str(d["siam"]), "--device", "cpu", "--img_size", "16",
        "--n", "2", "--k", "2", "--batch_size", "2", "--n_epochs", "1",
        "--example_cnt_per_class", "1"])
    assert sorted(os.listdir(d["gim"] / "ckpts")) == ["model_00000000", "model_00000001"]
    assert os.listdir(d["siam"] / "ckpts") == ["model_00000002"]
    _condition(d["gim"], "model_00000001")
    _jax_gim_dir(d["gim"], d["jax_gim"], "model_00000001")
    _jax_siamese_dir(d["siam"], d["jax_siam"], "model_00000002")

    # the GIM checkpoint named; the Siamese directory falls back to its latest
    specific = "model_00000001"
    eval_gim_on_authentication.main([
        "--ds_root", tree, "--gim_exp_dir", str(d["gim"]), "--baseline_type", "siamese",
        "--baseline_exp_dir", str(d["siam"]), "--specific_model", specific,
        "--csv_file_path", str(root / "port.csv"), "--dump_scores_dir", str(root / "port_scores"),
        "--device", "cpu", *EVAL_ARGS])
    ds = jauth.get_dataset(tree, "val", "omniglot", 2, 1, 16, 1, 2, 2)
    jauth.eval_authentication_task(
        ds=ds, m=1, n=2, k=2, batch_size=3, num_workers=0, gim_exp_dir=str(d["jax_gim"]),
        csv_file_path=str(root / "jax.csv"), specific_model=specific,
        baseline_exp_dir=str(d["jax_siam"]), baseline_type="siamese", calibrate_q=0.9,
        dump_scores_dir=str(root / "jax_scores"))
    return root, d


ACC_COLS = ["acc", "acc_on_fake", "acc_on_real", "acc_cal", "acc_on_fake_cal",
            "acc_on_real_cal", "acc_balanced"]


def test_grid_csv_matches_jax(grid):
    root, d = grid
    ours = pd.read_csv(root / "port.csv", index_col=0)
    theirs = pd.read_csv(root / "jax.csv", index_col=0)
    assert list(ours.columns) == list(theirs.columns) == list(tauth.CSV_COLS + tauth.CAL_COLS)
    assert list(ours.index) == list(theirs.index) == list(range(6))
    for col in ("au_type", "im_type", "ds_root", "m", "n", "k"):
        assert list(ours[col]) == list(theirs[col]), col
    assert set(ours["gim_exp_dir"]) == {str(d["gim"])}
    assert set(theirs["gim_exp_dir"]) == {str(d["jax_gim"])}
    assert ours["auc"].between(0, 1).all()
    assert np.isfinite(ours[list(tauth.CAL_COLS)].to_numpy()).all()
    attack = ours["im_type"] != "gim"  # the GIM attacker draws its noise otherwise
    assert attack.sum() == 4
    pd.testing.assert_frame_equal(ours.loc[attack, ACC_COLS], theirs.loc[attack, ACC_COLS],
                                  check_exact=True)
    np.testing.assert_allclose(ours.loc[attack, "auc"], theirs.loc[attack, "auc"], atol=1e-5)
    rest = ["th_cal", "th_balanced", "score_real_mean", "score_real_std", "score_fake_mean",
            "score_fake_std"]
    np.testing.assert_allclose(ours.loc[attack, rest], theirs.loc[attack, rest], atol=TOL,
                               rtol=TOL)
    for au in ("gim", "siamese"):
        for im in ("gim", "replay", "rnd_src"):
            got = np.load(root / "port_scores" / f"scores_{au}_{im}.npz")
            want = np.load(root / "jax_scores" / f"scores_{au}_{im}.npz")
            for key in ("score_real", "score_fake"):
                assert got[key].shape == want[key].shape == (8,)
                if key == "score_real" or im != "gim":
                    np.testing.assert_allclose(got[key], want[key], atol=TOL, rtol=TOL)


def _import_script():
    spec = importlib.util.spec_from_file_location(
        "torch_import_jax_ckpt", REPO / "scripts" / "torch_import_jax_ckpt.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_import_script_round_trips_the_checkpoints(grid, tmp_path):
    """JAX directories (the port's weights carried across) -> the script -> the
    port's own checkpoints again."""
    _, d = grid
    script = _import_script()
    for kind, jax_dir, port_dir, name, keys in (
            ("gim", d["jax_gim"], d["gim"], "model_00000001", ("au", "im")),
            ("siamese", d["jax_siam"], d["siam"], "model_00000002", ("model",))):
        out = tmp_path / kind
        path = script.main(["--jax_exp_dir", str(jax_dir), "--out_dir", str(out),
                            "--kind", kind])
        assert os.path.basename(path) == name
        got = torch.load(path, weights_only=True)
        want = torch.load(port_dir / "ckpts" / name, weights_only=True)
        for key in keys:
            assert got[key].keys() == want[key].keys()
            for k, v in want[key].items():
                torch.testing.assert_close(got[key][k], v, rtol=0, atol=0)
        if kind == "gim":
            assert (got["global_step"], got["last_epoch"]) == (want["global_step"],
                                                                 want["last_epoch"])
        assert tauth.load_args(str(out))["img_size"] == 16


@pytest.mark.parametrize("cli", ["eval_gim_on_authentication", "train_siamese_baseline",
                                 "train_arcface_baseline"])
def test_clis_refuse_cuda_without_a_gpu(cli):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    module = importlib.import_module(f"optimalstrategiesagainstgenerativeattacks_torch.{cli}")
    required = (["--ds_root", "ds", "--gim_exp_dir", "exp"] if cli.startswith("eval")
                else ["--dataset_root", "ds"])
    with pytest.raises(SystemExit, match="--device cuda"):
        module.main(required)
