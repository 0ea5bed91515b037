"""The port's data feeding against the JAX package's, on the CPU.

* ``DeviceEpisodicLoader`` on the JAX tests' ``_FakeDS`` (class c's image j
  filled with c * 31 + j): the class sequence of every epoch equals the JAX
  loader's exactly; each episode's frames come from its class and are
  distinct; mirror flips are seen both ways; a set without a uniform cache is
  refused; ``set_epoch`` replays an epoch, batch for batch.
* ``stacked_cache()`` of both episodic datasets equals the JAX package's on
  the loop tests' Omniglot and VoxCeleb2 trees.
* ``device_prefetch`` on the CPU: the host loader's batches in order, with a
  thread and with ``depth=0``; a producer's error reaches the consumer; no
  thread is left alive after a ``break``.
* The loop: ``device_data`` picks the device loader on a uniform set and the
  prefetched host loader with "off"; "on" refuses a set without a cache; two
  steps, a checkpoint and one step of the next epoch from a fresh loader
  equal three uninterrupted steps, bit for bit.
"""

import dataclasses
import os
import threading
import time

import numpy as np
import pytest
import torch

from optimalstrategiesagainstgenerativeattacks_torch.data import episodic as tdata
from optimalstrategiesagainstgenerativeattacks_torch.data.device_sampler import (
    DeviceEpisodicLoader,
)
from optimalstrategiesagainstgenerativeattacks_torch.data.prefetch import device_prefetch
from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg
from optimalstrategiesagainstgenerativeattacks_torch.train.checkpoints import CheckpointIO
from optimalstrategiesagainstgenerativeattacks_tpu.data import episodic as jdata
from optimalstrategiesagainstgenerativeattacks_tpu.data.device_sampler import (
    DeviceEpisodicLoader as JaxDeviceEpisodicLoader,
)
from test_device_sampler import _FakeDS
from test_torch_loop import _assert_same, _dataset, _snapshot, _write_tree
from test_torch_support import small_cfg

torch.set_num_threads(1)


def _classes(loader, epoch):
    loader.set_epoch(epoch)
    return np.concatenate([np.asarray(b["class"]) for b in loader])


def test_class_sequence_equals_the_jax_loaders_epoch_after_epoch():
    ds = _FakeDS(n_classes=7, example_cnt_per_class=3)
    port = DeviceEpisodicLoader(ds, batch_size=4, seed=11, device="cpu")
    ref = JaxDeviceEpisodicLoader(ds, batch_size=4, seed=11)
    assert len(port) == len(ref) == 5
    for epoch in range(4):
        got, want = _classes(port, epoch), _classes(ref, epoch)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=f"epoch {epoch}")
        np.testing.assert_array_equal(got, port.class_schedule(epoch)[:20])
    # iteration moves to the next epoch by itself, as the JAX loader does
    port.set_epoch(0)
    ref.set_epoch(0)
    for _ in range(2):
        np.testing.assert_array_equal(np.concatenate([b["class"].numpy() for b in port]),
                                      np.concatenate([np.asarray(b["class"]) for b in ref]))


def test_episodes_come_from_their_class_and_are_distinct():
    ds = _FakeDS()
    loader = DeviceEpisodicLoader(ds, batch_size=4, seed=3, device="cpu")
    batches = list(loader)
    assert len(batches) == len(loader) == 6
    for b in batches:
        shapes = {k: tuple(v.shape) for k, v in b.items()}
        assert shapes == {"leaked_sample": (4, 1, 4, 4, 1), "real_sample": (4, 2, 4, 4, 1),
                          "si_sample": (4, 3, 4, 4, 1), "class": (4,)}
        assert b["real_sample"].dtype == torch.uint8 and b["class"].dtype == torch.int32
        ep = torch.cat([b["leaked_sample"], b["real_sample"], b["si_sample"]], dim=1)
        vals = ep[:, :, 0, 0, 0].long()
        # every pixel of an image is its (class, frame) value
        assert torch.equal(ep.long(), vals[:, :, None, None, None].expand_as(ep))
        assert torch.equal(vals // 31, b["class"].long()[:, None].expand_as(vals))
        for row in vals.tolist():
            assert len(set(row)) == len(row)


def test_mirror_flips_each_image_both_ways():
    ds = _FakeDS(hw=2, mirror=True)
    ds._cache[..., 0, :] = 0
    ds._cache[..., 1, :] = 9
    loader = DeviceEpisodicLoader(ds, batch_size=6, seed=1, device="cpu")
    rows = torch.cat([b["si_sample"][..., 0, :, 0].reshape(-1, 2) for b in loader])
    flipped = (rows == torch.tensor([9, 0])).all(1)
    unflipped = (rows == torch.tensor([0, 9])).all(1)
    assert bool((flipped | unflipped).all())
    assert 0.3 < flipped.float().mean().item() < 0.7  # p = 0.5 over 72 images


def test_a_set_without_a_uniform_cache_is_refused():
    class NoCache(_FakeDS):
        def stacked_cache(self):
            return None

    with pytest.raises(ValueError, match="uniform"):
        DeviceEpisodicLoader(NoCache(), batch_size=4, device="cpu")
    with pytest.raises(ValueError, match="images per class"):
        DeviceEpisodicLoader(_FakeDS(t=5), batch_size=4, device="cpu")


def test_set_epoch_replays_an_epoch_batch_for_batch():
    ds = _FakeDS(mirror=True)
    first = DeviceEpisodicLoader(ds, batch_size=4, seed=2, device="cpu")
    epochs = [list(first) for _ in range(3)]
    # a loader sharing the first's resident cache, moved straight to epoch 1
    again = DeviceEpisodicLoader(ds, batch_size=4, seed=2, device="cpu", data=first.data)
    assert again.data is first.data
    again.set_epoch(1)
    for got, want in zip(again, epochs[1], strict=True):
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert not torch.equal(epochs[0][0]["si_sample"], epochs[1][0]["si_sample"])
    other_seed = DeviceEpisodicLoader(ds, batch_size=4, seed=3, device="cpu")
    other_seed.set_epoch(1)
    assert not torch.equal(next(iter(other_seed))["class"], epochs[1][0]["class"])


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    return {layout: _write_tree(tmp_path_factory.mktemp(layout), layout)
            for layout in ("omniglot", "voxceleb2")}


@pytest.mark.parametrize("layout", ["omniglot", "voxceleb2"])
def test_stacked_cache_equals_the_jax_packages(trees, layout):
    got = _dataset(tdata, layout, trees[layout]).stacked_cache()
    want = _dataset(jdata, layout, trees[layout]).stacked_cache()
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert got.shape == (4, 6, 16, 16, 1 if layout == "omniglot" else 3)
    np.testing.assert_array_equal(got, want)


def _host_loader(trees, seed=9):
    return tdata.EpisodicBatchLoader(_dataset(tdata, "voxceleb2", trees["voxceleb2"]),
                                     batch_size=4, seed=seed)


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_prefetch_yields_the_host_batches_in_order(trees, depth):
    want = list(_host_loader(trees))
    got = list(device_prefetch(iter(_host_loader(trees)), "cpu", depth=depth))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert isinstance(g[k], torch.Tensor)
            np.testing.assert_array_equal(g[k].numpy(), w[k], err_msg=k)


def test_prefetch_raises_the_producers_error():
    def batches():
        yield {"x": np.zeros(2)}
        raise RuntimeError("decode failed")

    it = device_prefetch(batches(), "cpu", depth=2)
    assert next(it)["x"].shape == (2,)
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)


def test_prefetch_leaves_no_thread_after_an_early_break():
    produced = []

    def endless():
        while True:
            produced.append(len(produced))
            yield {"x": np.full(3, len(produced))}

    before = set(threading.enumerate())
    it = device_prefetch(endless(), "cpu", depth=2)
    for i, batch in enumerate(it):
        assert batch["x"][0] == i + 1
        if i == 4:
            break
    time.sleep(0.2)  # the producer is now blocked on the full queue
    assert [t.name for t in set(threading.enumerate()) - before] == ["device_prefetch"]
    it.close()
    assert set(threading.enumerate()) - before == set()
    assert len(produced) <= 5 + 2 + 1  # the queue's depth ahead of the consumer, one in hand


def test_train_loader_follows_device_data(trees, capsys):
    cfg = small_cfg(dataset_root=trees["omniglot"], ds_n_examples_per_cls=3, num_workers=0)
    ds = _dataset(tdata, "omniglot", trees["omniglot"])
    loader = timg.train_loader(cfg, ds, 4, "cpu")
    assert isinstance(loader, DeviceEpisodicLoader) and loader.seed == cfg.seed
    assert "device-resident dataset: 0 MB uint8 staged to cpu (4 classes x 6)" in (
        capsys.readouterr().out)
    off = timg.train_loader(dataclasses.replace(cfg, device_data="off"), ds, 4, "cpu")
    assert isinstance(off, tdata.EpisodicBatchLoader)
    ragged = tdata.OmniglotGIMDataSet(root=trees["omniglot"], split="train", img_channels=1,
                                      img_size=16, m=1, n=2, si=2, example_cnt_per_class=3)
    ragged._stacked = None  # as when the classes' image counts differ
    assert isinstance(timg.train_loader(cfg, ragged, 4, "cpu"), tdata.EpisodicBatchLoader)
    with pytest.raises(ValueError, match="uniform"):
        timg.train_loader(dataclasses.replace(cfg, device_data="on"), ragged, 4, "cpu")
    with pytest.raises(ValueError, match="device_data"):
        timg.train_loader(dataclasses.replace(cfg, device_data="yes"), ds, 4, "cpu")


@pytest.mark.parametrize("device_data", ["auto", "off"])
def test_loop_runs_on_either_loader(trees, tmp_path, capsys, device_data):
    from optimalstrategiesagainstgenerativeattacks_torch import train_gim_on_imgs as tcli
    from optimalstrategiesagainstgenerativeattacks_torch.train.logger import Logger

    cfg = small_cfg(outdir=str(tmp_path), dataset_root=trees["omniglot"], n_epochs=2,
                    ds_n_examples_per_cls=1, num_workers=0, save_every=100, log_every=1,
                    eval_every=100, save_imgs_every=100, log_enc_every=100,
                    device_data=device_data)
    train_ds, val_ds = tcli.make_datasets(cfg)
    logger = Logger(*(str(tmp_path / d) for d in ("logs", "imgs", "tb")))
    state = timg.train_gim_imgs(cfg, train_ds, val_ds, logger=logger, progress=False,
                                device="cpu")
    assert state.step == 3
    out = capsys.readouterr().out
    assert ("device-resident dataset" in out) == (device_data == "auto")
    assert ("host loader, prefetch depth 2" in out) == (device_data == "off")
    assert [s for s, _ in logger.stats["train_losses"]["dis_loss"]] == [0, 1, 2, 3]
    assert np.all(np.isfinite([v for _, v in logger.stats["train_losses"]["dis_loss"]]))
    assert [t for t in threading.enumerate() if t.name == "device_prefetch"] == []


def test_resume_on_the_device_loader_equals_uninterrupted_steps(trees, tmp_path):
    cfg = small_cfg(reg_param=10.0, img_channels=3, batch_size=2, seed=4)
    ds = _dataset(tdata, "voxceleb2", trees["voxceleb2"])  # 4 classes x 3 episodes, mirrored

    def fresh(seed):
        au, im = timg.build_models(cfg)
        return timg.create_state(cfg, au, im, seed, "cpu")

    def batches(epoch, n):
        loader = DeviceEpisodicLoader(ds, batch_size=cfg.batch_size, seed=cfg.seed, device="cpu")
        loader.set_epoch(epoch)
        return [b for b, _ in zip(loader, range(n))]

    straight = fresh(cfg.seed)
    for b in batches(0, 2) + batches(1, 1):
        timg.train_step(straight, b)

    first = fresh(cfg.seed)
    for b in batches(0, 2):
        timg.train_step(first, b)
    io = CheckpointIO(str(tmp_path / "ckpts"))
    path = io.save(first, first.step, last_epoch=1)
    resumed = fresh(cfg.seed + 1)
    assert io.load(path, resumed) == (1, 1)
    timg.train_step(resumed, batches(1, 1)[0])  # a new loader, its epoch 1
    _assert_same(_snapshot(resumed), _snapshot(straight))
    assert os.path.exists(path)
