"""Device-resident episodic sampling: the whole uint8 dataset lives on the device.

Counterpart of ``optimalstrategiesagainstgenerativeattacks_tpu/data/device_sampler.py``.
When every class has the same image count, the dataset's uint8 cache
``[n_classes, t, H, W, C]`` goes to the device once, and every batch is
assembled there: the class pick, each episode's disjoint frames (an argsort
of uniforms) and the random mirror.  After the upload, only each epoch's
int32 class ids cross to the device; no image bytes do.  Omniglot
(964 x 20 x 32x32) is 20 MB; a VoxCeleb2-shaped set at 64x64x3 with 6k
videos x 20 frames is ~1.5 GB, which the 80 GB card holds many times over.

Episodes follow ``EpisodicBatchLoader``'s contract over the same dataset:
each epoch visits ``example_cnt_per_class`` episodes of each class in the
order of ``np.random.default_rng((seed, epoch)).permutation``, exactly as
the JAX loader does; each episode draws m+n+k distinct frames of its class,
uniformly without replacement, and with ``mirror`` each image flips its
width with p=0.5.  Batch i of epoch e draws its frames and flips from a
generator seeded from (seed, e, i) (``utils/rng.py``), so a resumed run that
takes epoch e again gets the same batches.  The bits are not JAX's threefry
bits.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from optimalstrategiesagainstgenerativeattacks_torch.utils.rng import noise_generator


class DeviceEpisodicLoader:
    """Iterator over device-resident uint8 episodic batches; a drop-in for
    ``EpisodicBatchLoader`` over a dataset with a uniform ``stacked_cache()``.

    ``data`` shares another loader's resident cache (its ``.data``) instead of
    uploading the dataset again: the cache does not depend on the seed.
    """

    def __init__(self, ds, batch_size: int, seed: int = 0, drop_last: bool = True,
                 device="cuda", data: Optional[torch.Tensor] = None):
        if data is None:
            cache = ds.stacked_cache()
            if cache is None:
                raise ValueError("dataset has no uniform stacked cache; use EpisodicBatchLoader")
            data = torch.from_numpy(np.ascontiguousarray(cache)).to(device)
        self.data = data  # [n_classes, t, H, W, C] uint8, on the device
        self.device = data.device
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.seed = seed
        self._epoch = 0
        self.m, self.n, self.si = ds.m, ds.n, ds.si
        self.take = self.m + self.n + self.si
        self.n_classes, self.t = data.shape[:2]
        if self.take > self.t:
            raise ValueError(f"m+n+k={self.take} > images per class {self.t}")
        self.example_cnt_per_class = ds.example_cnt_per_class
        self.mirror = bool(getattr(ds, "mirror", False))

    def __len__(self) -> int:
        n = self.n_classes * self.example_cnt_per_class
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def class_schedule(self, epoch: int) -> np.ndarray:
        """The class of each episode of ``epoch``, in visiting order (int32)."""
        n = self.n_classes * self.example_cnt_per_class
        order = np.random.default_rng((self.seed, epoch)).permutation(n)
        return (order // self.example_cnt_per_class).astype(np.int32)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        epoch = self._epoch
        cls_ids = self.class_schedule(epoch)
        n = cls_ids.shape[0]
        cls_all = torch.from_numpy(cls_ids).to(self.device)  # the epoch's only upload
        end = n - (n % self.batch_size) if self.drop_last else n
        for i, start in enumerate(range(0, end, self.batch_size)):
            yield self._sample_batch(cls_all[start:start + self.batch_size],
                                     noise_generator(self.device, self.seed, epoch, i))
        self._epoch += 1

    def _sample_batch(self, cls: torch.Tensor, gen: torch.Generator) -> Dict[str, torch.Tensor]:
        """[B] int32 classes -> the batch dict, drawing frames and flips from ``gen``."""
        b = cls.shape[0]
        u = torch.rand((b, self.t), generator=gen, device=self.device)
        order = torch.argsort(u, dim=1)[:, :self.take]
        ep = self.data[cls.long()[:, None], order]  # [B, take, H, W, C] uint8
        if self.mirror:
            flip = torch.rand((b, self.take), generator=gen, device=self.device) < 0.5
            ep = torch.where(flip[:, :, None, None, None], ep.flip(3), ep)
        m, n = self.m, self.n
        return {"leaked_sample": ep[:, :m], "real_sample": ep[:, m:m + n],
                "si_sample": ep[:, m + n:], "class": cls}
