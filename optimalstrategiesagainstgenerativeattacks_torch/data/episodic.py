"""Episodic (m, n, k) image datasets and a batched host-side loader.

A copy of the readers of
``optimalstrategiesagainstgenerativeattacks_tpu/data/episodic.py`` (capability
parity with the reference's ``data_handling/img_datasets.py``), kept in the
port so that it needs nothing of the JAX package.  Same seeding, so a
dataset and a seed give the same batches as the JAX loader:

  * ``ImgGIMDataSet``: directory-tree dataset ``<root>/<split>/[group/]
    class/*.jpg`` with class filtering (>= m+n+k images), disjoint episodic
    sampling, bilinear resize, mirror augmentation, hierarchical (group)
    mode for VoxCeleb2.  File lists are scanned once at init.
  * ``OmniglotGIMDataSet``: every image decoded once into one uint8 array
    per class; episode assembly is a numpy gather.
  * Episodes are sampled with a seeded ``numpy.random.Generator``; the
    loader seeds each epoch with ``np.random.default_rng((seed, epoch))``.
  * Samples are NHWC uint8; the train step normalises them to [-1, 1] on
    the device (``train/image.py:prepare_batch``).
  * ``ArcfaceDataSet``: single images labelled by identity, for the ArcFace
    baseline's classification training.
  * ``EpisodicBatchLoader`` assembles whole batches, with a thread pool for
    the disk-backed dataset.
  * ``stacked_cache()`` of either episodic dataset: every image in one uint8
    ``[n_classes, t, H, W, C]`` array when the classes' counts agree, for
    ``data/device_sampler.py:DeviceEpisodicLoader``.

PIL is imported only where an image is decoded.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from optimalstrategiesagainstgenerativeattacks_torch.data.utils import (
    list_dir,
    list_files,
    list_files_rec,
)

IMG_EXTENSIONS = (".png", ".jpg", "jpeg", ".JPG", "JPEG")


def load_image(
    img_path: str,
    img_size: int,
    img_mode: str = "RGB",
    mirror: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Decode -> convert -> bilinear resize -> uint8 HWC (+ random mirror).

    Matches the reference's ``img_datasets.load_image:284-303`` up to the
    dynamic-range shift, which is applied on the device.
    """
    from PIL import Image

    img = Image.open(img_path, mode="r").convert(img_mode)
    img = img.resize((img_size, img_size), resample=Image.BILINEAR)
    arr = np.asarray(img, dtype=np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if mirror and rng is not None and rng.random() < 0.5:
        arr = arr[:, ::-1, :]
    return arr


class ImgGIMDataSet:
    """Directory-tree episodic dataset (the reference's ``ImgGIMDataSet:24-115``)."""

    def __init__(
        self,
        root: str,
        split: str,
        img_channels: int,
        img_size: int,
        m: int,
        n: int,
        si: int,
        example_cnt_per_class: int,
        img_suffix: str = ".jpg",
        hierarchical: bool = False,
        mirror: bool = True,
        seed: int = 0,
    ):
        self.root = root
        self.split = split
        self.img_channels = img_channels
        self.img_mode = "L" if img_channels == 1 else "RGB"
        self.img_size = img_size
        self.m, self.n, self.si = m, n, si
        self.min_imgs_per_cls = m + n + si
        self.example_cnt_per_class = example_cnt_per_class
        self.img_suffix = img_suffix
        self.mirror = mirror
        self.data_dir = os.path.join(root, split)
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()

        if hierarchical:
            class_dirs: List[str] = []
            for pdir in list_dir(self.data_dir):
                pdir_path = os.path.join(self.data_dir, pdir)
                class_dirs.extend(os.path.join(pdir, d) for d in list_dir(pdir_path))
        else:
            class_dirs = list_dir(self.data_dir)

        # scan + filter once (classes need >= m+n+si images)
        self._class_dir_names: List[str] = []
        self._class_img_paths: List[List[str]] = []
        for d in class_dirs:
            dir_path = os.path.join(self.data_dir, d)
            paths = [
                os.path.join(dir_path, f)
                for f in sorted(os.listdir(dir_path))
                if f.endswith(img_suffix)
            ]
            if len(paths) >= self.min_imgs_per_cls:
                self._class_dir_names.append(d)
                self._class_img_paths.append(paths)
        self.n_classes = len(self._class_dir_names)

    def __len__(self) -> int:
        return self.n_classes * self.example_cnt_per_class

    def stacked_cache(self, num_workers: int = 8) -> Optional[np.ndarray]:
        """Every image decoded once into one uint8 [n_classes, t, H, W, C] array,
        for device-resident sampling (``data/device_sampler.py``); None when the
        classes' image counts differ.  No mirror here: the device sampler flips."""
        if getattr(self, "_stacked_cache", None) is not None:
            return self._stacked_cache
        if len({len(p) for p in self._class_img_paths}) != 1:
            return None

        def load_class(paths):
            return np.stack([load_image(p, self.img_size, self.img_mode) for p in paths], axis=0)

        with ThreadPoolExecutor(max_workers=max(1, num_workers)) as ex:
            per_class = list(ex.map(load_class, self._class_img_paths))
        self._stacked_cache = np.stack(per_class, axis=0)
        return self._stacked_cache

    def _split_indices(self, n_avail: int, rng: np.random.Generator):
        sampled = rng.choice(n_avail, size=self.m + self.n + self.si, replace=False)
        return (
            sampled[: self.m],
            sampled[self.m : self.m + self.n],
            sampled[self.m + self.n :],
        )

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.sample_episode(index)

    def sample_episode(
        self, index: int, rng: Optional[np.random.Generator] = None
    ) -> Dict[str, np.ndarray]:
        if rng is None:
            with self._lock:
                rng = np.random.default_rng(self._rng.integers(2**63))
        cls_idx = index // self.example_cnt_per_class
        paths = self._class_img_paths[cls_idx]
        leaked_idx, real_idx, si_idx = self._split_indices(len(paths), rng)

        def load_many(indices):
            return np.stack(
                [
                    load_image(paths[i], self.img_size, self.img_mode, self.mirror, rng)
                    for i in indices
                ],
                axis=0,
            )

        return {
            "real_sample": load_many(real_idx),
            "leaked_sample": load_many(leaked_idx),
            "si_sample": load_many(si_idx),
            "class": np.int32(cls_idx),
            "class_name": self._class_dir_names[cls_idx],
        }


class OmniglotGIMDataSet:
    """RAM-cached episodic Omniglot dataset (the reference's ``OmniglotGIMDataSet:118-211``).

    Two-level alphabets/characters scan; every image decoded to a uint8
    array at init (max 20 images per character); episode assembly is a
    numpy gather.
    """

    NUM_EXAMPLES_PER_CLASS = 20

    def __init__(
        self,
        root: str,
        split: str,
        img_channels: int,
        img_size: int,
        m: int,
        n: int,
        si: int,
        example_cnt_per_class: int,
        seed: int = 0,
    ):
        if m + n + si > self.NUM_EXAMPLES_PER_CLASS:
            raise ValueError(
                f"Max allowed value for m+n+si is {self.NUM_EXAMPLES_PER_CLASS}"
            )
        self.root = root
        self.split = split
        self.img_channels = img_channels
        self.img_size = img_size
        self.m, self.n, self.si = m, n, si
        self.example_cnt_per_class = example_cnt_per_class
        self.data_path = os.path.join(root, split)
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()

        self._alphabets = list_dir(self.data_path)
        self._characters = sum(
            (
                [os.path.join(a, c) for c in list_dir(os.path.join(self.data_path, a))]
                for a in self._alphabets
            ),
            [],
        )
        self.data: List[np.ndarray] = []
        for character in self._characters:
            char_dir = os.path.join(self.data_path, character)
            imgs = [
                load_image(os.path.join(char_dir, f), img_size, "L")
                for f in list_files(char_dir, IMG_EXTENSIONS)
            ]
            self.data.append(np.stack(imgs, axis=0))
        self.n_classes = len(self._characters)
        self._class_dir_names = self._characters
        # when every class has the same image count, one stacked array lets
        # the loader assemble a batch with a single fancy-indexed gather
        counts = {d.shape[0] for d in self.data}
        self._stacked = np.stack(self.data, axis=0) if len(counts) == 1 else None

    def stacked_cache(self) -> Optional[np.ndarray]:
        """uint8 [n_classes, t, H, W, 1] cache for device-resident sampling
        (None when the classes' image counts differ)."""
        return self._stacked

    def sample_batch(self, indices, seed: int,
                     rows: Optional[Tuple[int, int]] = None) -> Dict[str, np.ndarray]:
        """Assemble a whole batch in one vectorised gather (the loader's fast path).

        ``rows`` (lo, hi) assembles only those episodes of the batch, from the
        whole batch's draw, so the parts of a batch concatenate to the batch.
        """
        if self._stacked is None:
            raise NotImplementedError("classes have unequal image counts")
        rng = np.random.default_rng(seed)
        cls = np.asarray(indices) // self.example_cnt_per_class
        b = cls.shape[0]
        t = self._stacked.shape[1]
        take = self.m + self.n + self.si
        # B independent disjoint samples: argsort of uniform noise
        noise = rng.random((b, t))
        if rows is not None:
            cls, noise = cls[rows[0]:rows[1]], noise[rows[0]:rows[1]]
        order = np.argsort(noise, axis=1)[:, :take]
        gathered = self._stacked[cls[:, None], order]  # [B, take, H, W, 1]
        return {
            "leaked_sample": gathered[:, : self.m],
            "real_sample": gathered[:, self.m : self.m + self.n],
            "si_sample": gathered[:, self.m + self.n :],
            "class": cls.astype(np.int32),
        }

    def __len__(self) -> int:
        return self.n_classes * self.example_cnt_per_class

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.sample_episode(index)

    def sample_episode(
        self, index: int, rng: Optional[np.random.Generator] = None
    ) -> Dict[str, np.ndarray]:
        if rng is None:
            with self._lock:
                rng = np.random.default_rng(self._rng.integers(2**63))
        char_class = index // self.example_cnt_per_class
        images = self.data[char_class]
        sampled = rng.choice(images.shape[0], size=self.m + self.n + self.si, replace=False)
        return {
            "real_sample": images[sampled[self.m : self.m + self.n]],
            "leaked_sample": images[sampled[: self.m]],
            "si_sample": images[sampled[self.m + self.n :]],
            "class": np.int32(char_class),
            "class_name": self._characters[char_class],
        }


class ArcfaceDataSet:
    """Single-image classification dataset for baseline training (the
    reference's ``ArcfaceDataSet:217-270``): one class dir per identity,
    recursive file listing with a per-class path cache."""

    def __init__(
        self,
        root: str,
        split: str,
        img_channels: int,
        img_size: int,
        example_cnt_per_class: int,
        img_suffix: str = ".jpg",
        mirror: bool = True,
        seed: int = 0,
    ):
        self.root = root
        self.split = split
        self.img_channels = img_channels
        self.img_mode = "L" if img_channels == 1 else "RGB"
        self.img_size = img_size
        self.example_cnt_per_class = example_cnt_per_class
        self.img_suffix = img_suffix
        self.mirror = mirror
        self.data_dir = os.path.join(root, split)
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()

        self._class_dir_names = list_dir(self.data_dir)
        self.n_classes = len(self._class_dir_names)
        self.class_img_paths: Dict[int, List[str]] = {}

    def __len__(self) -> int:
        return self.n_classes * self.example_cnt_per_class

    def __getitem__(self, index: int) -> Tuple[np.ndarray, int]:
        with self._lock:
            rng = np.random.default_rng(self._rng.integers(2**63))
        cls_idx = index // self.example_cnt_per_class
        if cls_idx not in self.class_img_paths:
            cls_dir_path = os.path.join(self.data_dir, self._class_dir_names[cls_idx])
            self.class_img_paths[cls_idx] = list_files_rec(cls_dir_path, self.img_suffix)
        paths = self.class_img_paths[cls_idx]
        if not paths:
            raise FileNotFoundError(
                f"class dir {self._class_dir_names[cls_idx]!r} has no "
                f"'{self.img_suffix}' images under {self.data_dir}"
            )
        img_idx = int(rng.integers(len(paths)))
        img = load_image(paths[img_idx], self.img_size, self.img_mode, self.mirror, rng)
        return img, cls_idx


class EpisodicBatchLoader:
    """Shuffling, batch-assembling loader over an episodic dataset.

    Batches are dicts of stacked uint8 numpy arrays; a thread pool
    parallelises decoding for disk-backed datasets (RAM-cached Omniglot
    needs none); ``epoch`` seeds the episode RNG so runs are reproducible.
    ``shard`` (rank, world) assembles only the rank's contiguous slice of each
    batch of ``batch_size`` (which ``world`` must divide), from the same order
    and episode seeds, so the ranks' slices concatenate to the batch one
    process assembles.
    """

    def __init__(
        self,
        ds,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 0,
        seed: int = 0,
        shard: Tuple[int, int] = (0, 1),
    ):
        if batch_size % shard[1] or (shard[1] > 1 and not drop_last):
            raise ValueError(f"batch_size {batch_size} (drop_last {drop_last}) does not divide "
                             f"over {shard[1]} ranks")
        self.ds = ds
        self.batch_size = batch_size
        self.shard = shard
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        n = len(self.ds)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _assemble(self, indices: Sequence[int], rng_seeds: Sequence[int]):
        rank, world = self.shard
        part = len(indices) // world
        rows = (rank * part, (rank + 1) * part) if world > 1 else None
        # vectorised fast path (RAM-cached datasets): one gather per batch,
        # seeded by the whole batch's first episode
        if hasattr(self.ds, "sample_batch"):
            try:
                return self.ds.sample_batch(indices, int(rng_seeds[0]) & (2**63 - 1),
                                            rows=rows)
            except NotImplementedError:
                pass
        if rows is not None:
            indices, rng_seeds = indices[rows[0]:rows[1]], rng_seeds[rows[0]:rows[1]]
        if self.num_workers > 0:
            with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
                episodes = list(
                    ex.map(
                        lambda args: self.ds.sample_episode(
                            args[0], np.random.default_rng(args[1])
                        ),
                        zip(indices, rng_seeds),
                    )
                )
        else:
            episodes = [
                self.ds.sample_episode(i, np.random.default_rng(s))
                for i, s in zip(indices, rng_seeds)
            ]
        batch = {
            k: np.stack([e[k] for e in episodes], axis=0)
            for k in ("real_sample", "leaked_sample", "si_sample")
        }
        batch["class"] = np.asarray([e["class"] for e in episodes], np.int32)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.ds)
        order_rng = np.random.default_rng((self.seed, self._epoch))
        order = order_rng.permutation(n) if self.shuffle else np.arange(n)
        episode_seeds = order_rng.integers(2**63, size=n)
        end = n - (n % self.batch_size) if self.drop_last else n
        for start in range(0, end, self.batch_size):
            idx = order[start : start + self.batch_size]
            seeds = episode_seeds[start : start + self.batch_size]
            yield self._assemble(idx, seeds)
        self._epoch += 1
