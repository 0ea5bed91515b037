"""Metrics and images of a run: TensorBoard scalars, PNG grids, pickled stats.

A copy of ``optimalstrategiesagainstgenerativeattacks_tpu/train/logger.py``
(itself at parity with the reference ``Logger``, ``training/logger.py:12-92``),
kept in the port so that it needs nothing of the JAX package: the same
output-dir contract (``<outdir>/{logs, imgs, tb}``,
``imgs/<category>/<k>/%08d.png`` grids), an in-memory picklable stats dict,
and tensorboardX scalars/images/figures/embeddings when tensorboardX is
installed.  Grids are assembled in numpy; PIL is imported only to write a
PNG.  In a data-parallel run (``parallel/mesh.py``) a logger on any rank but
0 writes nothing.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np

from optimalstrategiesagainstgenerativeattacks_torch.parallel.mesh import is_main

try:
    import tensorboardX

    _HAVE_TB = True
except Exception:  # pragma: no cover
    _HAVE_TB = False


def make_grid(imgs: np.ndarray, nrow: int = 5, padding: int = 2, pad_value: float = 0.0) -> np.ndarray:
    """[N, H, W, C] in [0,1] -> [H', W', C] grid (torchvision.make_grid analogue)."""
    imgs = np.asarray(imgs, np.float32)
    if imgs.ndim == 3:
        imgs = imgs[None]
    n, h, w, c = imgs.shape
    ncol = min(nrow, n)
    nrow_out = int(np.ceil(n / ncol))
    grid = np.full(
        (padding + nrow_out * (h + padding), padding + ncol * (w + padding), c),
        pad_value,
        np.float32,
    )
    for idx in range(n):
        r, col = divmod(idx, ncol)
        y = padding + r * (h + padding)
        x = padding + col * (w + padding)
        grid[y : y + h, x : x + w] = imgs[idx]
    return grid


def save_png(img: np.ndarray, path: str) -> None:
    """[H, W, C] float in [0,1] -> 8-bit PNG (C in {1, 3})."""
    from PIL import Image

    arr = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
    arr = (arr * 255.0 + 0.5).astype(np.uint8)
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    Image.fromarray(arr).save(path)


class Logger:
    """Scalar/image logger with the reference's directory contract."""

    def __init__(self, log_dir="./logs", img_dir="./imgs", tensorboard_dir: Optional[str] = None):
        self.stats = dict()
        self.log_dir = log_dir
        self.img_dir = img_dir
        self.monitoring_dir = tensorboard_dir
        self.writes = is_main()
        self.tb = None
        if self.writes:
            os.makedirs(log_dir, exist_ok=True)
            os.makedirs(img_dir, exist_ok=True)
            self.tb = tensorboardX.SummaryWriter(tensorboard_dir) if _HAVE_TB else None

    def add_scalar(self, category: str, k: str, v: float, global_step: int) -> None:
        if not self.writes:
            return
        self.stats.setdefault(category, {}).setdefault(k, []).append(
            (int(global_step), float(v))
        )
        if self.tb is not None:
            self.tb.add_scalar(f"{category}/{k}", float(v), int(global_step))

    def add_imgs(self, imgs: np.ndarray, category: str, k: str, global_step: int, nrow: int = 5) -> None:
        """imgs: [N, H, W, C] in [0, 1]. Writes PNG + TB image."""
        if not self.writes:
            return
        outdir = os.path.join(self.img_dir, category, str(k))
        os.makedirs(outdir, exist_ok=True)
        grid = make_grid(np.asarray(imgs), nrow=nrow)
        save_png(grid, os.path.join(outdir, "%08d.png" % int(global_step)))
        if self.tb is not None:
            self.tb.add_image(
                tag=f"{category}/{k}",
                img_tensor=np.clip(grid, 0, 1).transpose(2, 0, 1),
                global_step=int(global_step),
            )

    def add_figure(self, fig, category: str, k: str, global_step: int) -> None:
        if not self.writes:
            return
        outdir = os.path.join(self.img_dir, category, str(k))
        os.makedirs(outdir, exist_ok=True)
        fig.savefig(os.path.join(outdir, "%08d.png" % int(global_step)))
        if self.tb is not None:
            self.tb.add_figure(tag=f"{category}/{k}", figure=fig, global_step=int(global_step))

    def add_embeddings(self, embs, label_imgs, tag: str, global_step: int) -> None:
        if self.tb is not None:
            self.tb.add_embedding(
                tag=tag, mat=np.asarray(embs), label_img=np.asarray(label_imgs),
                global_step=int(global_step),
            )

    def get_last_scalar(self, category: str, k: str, default: float = 0.0) -> float:
        try:
            return self.stats[category][k][-1][1]
        except (KeyError, IndexError):
            return default

    def save_stats(self, filename: str) -> None:
        if not self.writes:
            return
        with open(os.path.join(self.log_dir, filename), "wb") as f:
            pickle.dump(self.stats, f)

    def load_stats(self, filename: str) -> None:
        path = os.path.join(self.log_dir, filename)
        if not os.path.exists(path):
            print(f'Warning: file "{path}" does not exist!')
            return
        try:
            with open(path, "rb") as f:
                self.stats = pickle.load(f)
        except EOFError:
            print("Warning: log file corrupted!")
