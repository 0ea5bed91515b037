"""The port's loop around the train step, against the JAX package where both have it.

* Loader: on a tiny image tree written here, in the Omniglot layout
  (``<split>/<alphabet>/<character>/*.png``) and the hierarchical VoxCeleb2
  layout (``<split>/<identity>/<video>/*.jpg``, mirrored), the port's
  ``EpisodicBatchLoader`` yields the same uint8 batches as the JAX loader,
  epoch after epoch, with and without worker threads.
* ``args.json``: what either package's ``save_args`` writes, the other's
  ``load_args`` and config read back; the ``target_img_size`` key maps onto
  ``img_size``.
* Resume: 2 steps, a checkpoint, a fresh state loaded from it, 1 step equals
  3 uninterrupted steps, bit-exact in f32 on the CPU (players with their
  spectral buffers, both Adams, both schedulers across a milestone, the
  noise generator), at the R1 config.
* Loop: ``train_gim_imgs(device="cpu")`` writes ``model_{step:08d}``
  checkpoints, scalars, encoder diagnostics, image grids and evals at their
  cadences, and resumes from a checkpoint; a run resumed from its step-0
  checkpoint writes the step-1 eval scalars and image grids of the run never
  interrupted.
* CLI: its flags are the JAX CLI's without the TPU-only ones, plus
  ``--device``, with the same defaults; ``--device cpu -dbg`` trains the
  VoxCeleb2 layout with R1, saves, and resumes.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from optimalstrategiesagainstgenerativeattacks_torch import train_gim_on_imgs as tcli
from optimalstrategiesagainstgenerativeattacks_torch.data import episodic as tdata
from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg
from optimalstrategiesagainstgenerativeattacks_torch.train.checkpoints import (
    CheckpointIO,
    get_latest_ckpt,
)
from optimalstrategiesagainstgenerativeattacks_torch.utils import config as tconfig
from optimalstrategiesagainstgenerativeattacks_tpu.data import episodic as jdata
from optimalstrategiesagainstgenerativeattacks_tpu.utils import config as jconfig
from test_cli_parity import _flags
from test_torch_support import small_cfg, uint8_batch

torch.set_num_threads(1)

TPU_ONLY_FLAGS = {"--unroll_encoder_pair", "--remat_encoders",
                  "--au_microbatch", "--adain_scan_unroll", "--split_step", "--stack_opt"}
IMAGES_PER_CLASS = 6


def _write_tree(root, layout: str) -> str:
    """Two groups of two classes per split, IMAGES_PER_CLASS noise images each (20x20)."""
    from PIL import Image

    rng = np.random.default_rng(0)
    mode, suffix = ("L", ".png") if layout == "omniglot" else ("RGB", ".jpg")
    for split in ("train", "val"):
        for group in range(2):
            for cls in range(2):
                d = os.path.join(root, split, f"g{group}", f"c{cls}")
                os.makedirs(d)
                for i in range(IMAGES_PER_CLASS):
                    shape = (20, 20) if mode == "L" else (20, 20, 3)
                    arr = rng.integers(0, 256, shape, dtype=np.uint8)
                    Image.fromarray(arr, mode).save(os.path.join(d, f"{i:02d}{suffix}"))
    return str(root)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    return {layout: _write_tree(tmp_path_factory.mktemp(layout), layout)
            for layout in ("omniglot", "voxceleb2")}


def _dataset(pkg, layout, root, split="train", seed=3):
    kw = dict(root=root, split=split, img_size=16, m=1, n=2, si=2, example_cnt_per_class=3,
              seed=seed)
    if layout == "omniglot":
        return pkg.OmniglotGIMDataSet(img_channels=1, **kw)
    return pkg.ImgGIMDataSet(img_channels=3, hierarchical=True, mirror=True, **kw)


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("layout", ["omniglot", "voxceleb2"])
def test_loader_batches_equal_the_jax_loaders(trees, layout, workers):
    loaders = [pkg.EpisodicBatchLoader(_dataset(pkg, layout, trees[layout]), batch_size=4,
                                       num_workers=workers, seed=9)
               for pkg in (tdata, jdata)]
    assert len(loaders[0]) == len(loaders[1]) == 3
    for epoch in (0, 1):
        for loader in loaders:
            loader.set_epoch(epoch)
        pairs = list(zip(*loaders))
        assert len(pairs) == 3
        for got, want in pairs:
            for k in ("real_sample", "leaked_sample", "si_sample", "class"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got["real_sample"].dtype == np.uint8
            c = 1 if layout == "omniglot" else 3
            assert got["si_sample"].shape == (4, 2, 16, 16, c)


def test_args_json_round_trips_between_the_packages(tmp_path):
    port_fields = {f.name for f in dataclasses.fields(tconfig.ImageGameConfig)}
    jcfg = jconfig.ImageGameConfig(img_size=64, img_channels=3, reg_param=10.0, au_lr=1e-4,
                                   milestones=[10, 20], resume_from_ckpt="ckpts/model_00000005",
                                   au_microbatch=16)
    jconfig.save_args(jcfg, str(tmp_path / "jax"))
    got = tconfig.ImageGameConfig.from_dict(tconfig.load_args(str(tmp_path / "jax")))
    assert got == tconfig.ImageGameConfig(
        **{k: v for k, v in dataclasses.asdict(jcfg).items() if k in port_fields})

    tcfg = tconfig.ImageGameConfig(dataset_type="voxceleb2", batch_size=16, dbg=True, seed=4)
    tconfig.save_args(tcfg, str(tmp_path / "port"))
    back = jconfig.ImageGameConfig.from_dict(jconfig.load_args(str(tmp_path / "port")))
    assert {k: getattr(back, k) for k in port_fields} == dataclasses.asdict(tcfg)

    # an argparse namespace of the port's CLI, and the old target_img_size key
    args = tcli.build_parser().parse_args(["--dataset_root", "ds", "--img_size", "64"])
    tconfig.save_args(args, str(tmp_path / "cli"))
    assert tconfig.load_args(str(tmp_path / "cli"))["device"] == "cuda"
    assert tconfig.ImageGameConfig.from_dict(tconfig.load_args(str(tmp_path / "cli"))).img_size == 64
    old = {"target_img_size": 64, "img_channels": 3}
    (tmp_path / "old").mkdir()
    (tmp_path / "old" / "args.json").write_text(json.dumps(old))
    for pkg in (tconfig, jconfig):
        assert pkg.ImageGameConfig.from_dict(pkg.load_args(str(tmp_path / "old"))).img_size == 64
    assert tconfig.ImageGameConfig.from_dict(old).img_size == 64


def _snapshot(state):
    return {
        "au": {k: v.clone() for k, v in state.au.state_dict().items()},
        "im": {k: v.clone() for k, v in state.im.state_dict().items()},
        "opt": [opt.state_dict() for opt in (state.opt_au, state.opt_im)],
        "lr": [g["lr"] for opt in (state.opt_au, state.opt_im) for g in opt.param_groups],
        "gen": state.generator.get_state(),
        "step": state.step,
    }


def _assert_same(a, b):
    for player in ("au", "im"):
        assert a[player].keys() == b[player].keys()
        for k in a[player]:
            assert torch.equal(a[player][k], b[player][k]), (player, k)
    for oa, ob in zip(a["opt"], b["opt"]):
        assert oa["state"].keys() == ob["state"].keys()
        for i in oa["state"]:
            for k, v in oa["state"][i].items():
                assert torch.equal(v, ob["state"][i][k]), (i, k)
    assert a["lr"] == b["lr"]
    assert torch.equal(a["gen"], b["gen"])
    assert a["step"] == b["step"]


def test_resume_equals_uninterrupted_steps(tmp_path):
    cfg = small_cfg(reg_param=10.0, img_channels=3, milestones=[2], seed=4)
    batches = [uint8_batch(cfg, seed=s) for s in range(3)]

    def fresh(seed):
        au, im = timg.build_models(cfg)
        return timg.create_state(cfg, au, im, seed, "cpu")

    straight = fresh(cfg.seed)
    for b in batches:
        timg.train_step(straight, b)

    first = fresh(cfg.seed)
    for b in batches[:2]:
        timg.train_step(first, b)
    io = CheckpointIO(str(tmp_path / "ckpts"))
    path = io.save(first, first.step, last_epoch=7)
    assert os.path.basename(path) == "model_00000001"
    resumed = fresh(cfg.seed + 1)  # other weights and noise: the checkpoint must replace them
    assert io.load(path, resumed) == (1, 7)
    timg.train_step(resumed, batches[2])
    _assert_same(_snapshot(resumed), _snapshot(straight))
    assert resumed.opt_au.param_groups[0]["lr"] == pytest.approx(cfg.au_lr * cfg.lr_gamma)


def _loop_cfg(outdir, root, **kw):
    base = dict(outdir=str(outdir), dataset_root=root, n_epochs=2, ds_n_examples_per_cls=1,
                num_workers=0, save_every=2, log_every=2, eval_every=2, save_imgs_every=3,
                log_enc_every=3)
    base.update(kw)
    return small_cfg(**base)


def test_train_gim_imgs_writes_at_its_cadences_and_resumes(trees, tmp_path):
    from optimalstrategiesagainstgenerativeattacks_torch.train.logger import Logger

    cfg = _loop_cfg(tmp_path, trees["omniglot"])
    train_ds, val_ds = tcli.make_datasets(cfg)
    assert (len(train_ds), len(val_ds)) == (4, 4)  # 2 steps of B=2 an epoch
    logger = Logger(str(tmp_path / "logs"), str(tmp_path / "imgs"), str(tmp_path / "tb"))
    state = timg.train_gim_imgs(cfg, train_ds, val_ds, logger=logger, progress=False,
                                device="cpu")
    assert state.step == 3
    ckpts = tmp_path / "ckpts"
    assert sorted(os.listdir(ckpts)) == ["model_00000000", "model_00000002", "model_00000003"]
    assert get_latest_ckpt(str(ckpts)).endswith("model_00000003")
    assert torch.load(ckpts / "model_00000002", weights_only=True)["last_epoch"] == 1
    assert torch.load(ckpts / "model_00000003", weights_only=True)["last_epoch"] == 2

    def steps(category, k):
        return [s for s, _ in logger.stats[category][k]]

    assert steps("train_losses", "dis_loss") == [0, 2]
    assert steps("train_losses", "dis_reg") == [0, 2]
    assert steps("train_losses", "gen_loss") == [0, 2]
    assert steps("lr", "im_lm") == [0, 2]
    assert steps("perf", "train_steps_per_sec") == [2]
    assert steps("eval_losses", "dis_loss") == [0, 2]
    assert steps("eval_accuracy", "dis_acc") == [0, 2]
    assert steps("train-au_env_std", "fake") == [0, 3]
    assert steps("train-au_src_mean", "abs[fake-si]") == [0, 3]
    flat = [v for cat in logger.stats.values() for pts in cat.values() for _, v in pts]
    assert np.all(np.isfinite(flat))
    grids = tmp_path / "imgs" / "train imgs_0000"
    assert sorted(os.listdir(grids / "impersonator")) == ["00000000.png", "00000003.png"]
    assert sorted(os.listdir(grids / "leaked")) == ["00000000.png", "00000003.png"]
    assert os.path.isdir(tmp_path / "imgs" / "val imgs_0000" / "impersonator")

    # resume from the checkpoint of epoch 1: that epoch runs again from its start
    cfg2 = dataclasses.replace(cfg, resume_from_ckpt="ckpts/model_00000002")
    resumed = timg.train_gim_imgs(cfg2, train_ds, val_ds, logger=logger, progress=False,
                                  device="cpu")
    assert resumed.step == 4
    assert get_latest_ckpt(str(ckpts)).endswith("model_00000004")


class _FixedEpisodes:
    """Two classes that both give one fixed uint8 episode, whatever the epoch's RNG:
    every epoch's batch is the same, so a run resumed from a checkpoint takes the
    very steps of an uninterrupted one."""

    root = "<memory>"

    def __init__(self, cfg, seed: int):
        episode = uint8_batch(dataclasses.replace(cfg, batch_size=1), seed)
        self.episode = {k: v[0] for k, v in episode.items()}
        self.episode["class"] = np.int32(0)

    def __len__(self) -> int:
        return 2

    def sample_episode(self, index, rng):
        return self.episode

    def __getitem__(self, index):
        return self.episode


def test_resumed_loop_samples_and_evaluates_as_an_uninterrupted_one(tmp_path):
    """The step-1 eval scalars and image grids of a run resumed from its step-0
    checkpoint equal those of the run never interrupted: the loop's noise depends
    on (seed, step, batch) and (seed, episode) only."""
    from optimalstrategiesagainstgenerativeattacks_torch.train.logger import Logger

    cfg = _loop_cfg(tmp_path / "a", "", batch_size=2, save_every=1, log_every=1, eval_every=1,
                    save_imgs_every=1, log_enc_every=100)
    train_ds, val_ds = _FixedEpisodes(cfg, 0), _FixedEpisodes(cfg, 1)

    def run(run_cfg):
        out = run_cfg.outdir
        logger = Logger(*(os.path.join(out, d) for d in ("logs", "imgs", "tb")))
        timg.train_gim_imgs(run_cfg, train_ds, val_ds, logger=logger, progress=False,
                            device="cpu")
        return logger

    straight = run(cfg)  # epochs of one step: steps 0 and 1
    resumed = run(dataclasses.replace(  # epoch 0 again (step 1), then epoch 1 (step 2)
        cfg, outdir=str(tmp_path / "b"),
        resume_from_ckpt=str(tmp_path / "a" / "ckpts" / "model_00000000")))

    def at_step_1(logger, category):
        return {k: dict(pts)[1] for k, pts in logger.stats[category].items()}

    assert at_step_1(resumed, "train_losses") == at_step_1(straight, "train_losses")
    for category in ("eval_losses", "eval_au_out", "eval_accuracy"):
        assert at_step_1(resumed, category) == at_step_1(straight, category), category
    grids = [os.path.join(d, "imgs", f"{split} imgs_{i:04d}", "impersonator", "00000001.png")
             for d in ("a", "b") for split in ("train", "val") for i in (0, 1)]
    for a, b in zip(grids[:4], grids[4:]):
        assert (tmp_path / a).read_bytes() == (tmp_path / b).read_bytes(), a
    # the grids follow each episode under the same noise at every save
    zero = tmp_path / "a" / "imgs" / "train imgs_0000" / "impersonator" / "00000000.png"
    assert (tmp_path / grids[0]).read_bytes() != zero.read_bytes()  # the players moved


def test_cli_flags_are_the_jax_clis_without_the_tpu_only_ones():
    jax_flags = _flags("train_gim_on_imgs")
    port = tcli.build_parser()
    port_flags = {s for a in port._actions for s in a.option_strings}
    assert TPU_ONLY_FLAGS <= jax_flags
    port_only = {"-h", "--help", "--device", "--cudnn_benchmark"}
    assert port_flags - port_only == jax_flags - TPU_ONLY_FLAGS - {"-h", "--help"}
    defaults = vars(port.parse_args(["--dataset_root", "ds"]))
    assert defaults["device"] == "cuda" and defaults["cudnn_benchmark"] is False
    cfg = tconfig.ImageGameConfig.from_dict(defaults)
    assert cfg == tconfig.ImageGameConfig(dataset_root="ds")


def test_cli_trains_on_the_cpu_saves_and_resumes(trees, tmp_path):
    out = tmp_path / "out"
    argv = ["--dataset_root", trees["voxceleb2"], "--dataset_type", "voxceleb2", "-o", str(out),
            "--device", "cpu", "-dbg", "--img_size", "16", "--img_channels", "3",
            "--style_dim", "32", "--batch_size", "2", "--n", "2", "--k", "2",
            "--ds_n_examples_per_cls", "1", "--n_epochs", "1", "--num_workers", "0",
            "--reg_param", "10", "--compute_dtype", "float32", "--save_every", "1",
            "--eval_every", "100", "--save_imgs_every", "100", "--log_every", "1"]
    state = tcli.main(argv)
    assert state.step == 1  # 4 identities of one video = 4 episodes, B=2
    saved = json.loads((out / "args.json").read_text())
    assert saved["device"] == "cpu" and saved["reg_param"] == 10.0
    assert sorted(os.listdir(out / "ckpts")) == ["model_00000000", "model_00000001"]
    resumed = tcli.main(argv + ["-r", "ckpts/model_00000001", "--n_epochs", "2"])
    assert resumed.step == 3
    assert os.path.exists(out / "ckpts" / "model_00000003")
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            tcli.main(argv[:argv.index("--device")] + argv[argv.index("--device") + 2:])
