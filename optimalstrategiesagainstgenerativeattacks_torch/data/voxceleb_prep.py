"""VoxCeleb2 preparation: mp4 videos -> frame-JPEG directories, host code.

A copy of ``optimalstrategiesagainstgenerativeattacks_tpu/data/voxceleb_prep.py``
(the reference's ``data_handling/prepare_voxceleb_dataset.py``), kept in the
port so that it needs nothing of the JAX package: cv2 ``VideoCapture``, every
``skip_frames``-th frame, BGR -> RGB, resized to ``img_size``.  ``create_dataset``
writes one numbered directory per video under each identity (the hierarchical
layout ``data/episodic.py`` reads for ``voxceleb2``); ``id_vids_to_imgs`` and
``id_largest_vid_to_imgs`` write an identity's frames flat.  cv2 and PIL are
imported only where a video is decoded.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence

from optimalstrategiesagainstgenerativeattacks_torch.data.utils import list_dir, list_files_rec


def vid_to_images(vid_path: str, img_size: int, skip_frames: int = 5) -> List:
    """Every skip_frames-th frame of a video as a resized RGB PIL image."""
    import cv2
    from PIL import Image

    vidcap = cv2.VideoCapture(vid_path)
    images = []
    cnt = 0
    has_frame = True
    while has_frame:
        has_frame, frame = vidcap.read()
        if has_frame and cnt % skip_frames == 0:
            img = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            if img.shape[1] >= img_size:
                images.append(Image.fromarray(img).resize((img_size, img_size)))
            else:
                print(f"Warning: video {vid_path} is smaller then {img_size} pixels")
        cnt += 1
    vidcap.release()
    return images


def _save(images, dst_dir: str) -> None:
    os.makedirs(dst_dir, exist_ok=True)
    for i, img in enumerate(images):
        img.save(os.path.join(dst_dir, f"{i:08}.jpg"))


def _videos(id_src_root_dir: str) -> List[str]:
    return list_files_rec(id_src_root_dir, suffix=(".mp4",))


def id_vids_to_imgs(id_src_root_dir: str, id_dst_root_dir: str, img_size: int,
                    skip_frames: int = 5) -> None:
    """All of an identity's videos -> one flat numbered image directory."""
    _save([img for vid in _videos(id_src_root_dir)
           for img in vid_to_images(vid, img_size, skip_frames)], id_dst_root_dir)


def vids_to_id_imgs(id_src_root_dir: str, id_dst_root_dir: str, img_size: int,
                    skip_frames: int = 5) -> None:
    """One numbered subdirectory per video (the layout the training datasets read)."""
    for vid_idx, vid in enumerate(_videos(id_src_root_dir)):
        _save(vid_to_images(vid, img_size, skip_frames),
              os.path.join(id_dst_root_dir, f"{vid_idx:04}"))


def id_largest_vid_to_imgs(id_src_root_dir: str, id_dst_root_dir: str, img_size: int,
                           skip_frames: int = 5) -> None:
    """Only the identity's longest video -> a flat image directory."""
    _save(max((vid_to_images(vid, img_size, skip_frames) for vid in _videos(id_src_root_dir)),
              key=len), id_dst_root_dir)


def create_dataset(src_vid_ds_root: str, dst_img_ds_root: str, img_size: int,
                   skip_frames: int = 5) -> None:
    """Convert each identity directory of ``src_vid_ds_root`` with ``vids_to_id_imgs``."""
    for id_dir in list_dir(src_vid_ds_root):
        src_id_dir = os.path.join(src_vid_ds_root, id_dir)
        print(f"Processing dir: {src_id_dir}")
        vids_to_id_imgs(src_id_dir, os.path.join(dst_img_ds_root, id_dir), img_size,
                        skip_frames)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src_vid_ds_root", required=True,
                        help="path to voxceleb2 video directory at .../test/mp4/ or /dev/mp4")
    parser.add_argument("--dst_img_ds_root", required=True, help="location of new dataset")
    parser.add_argument("--img_size", type=int, default=64)
    parser.add_argument("--skip_frames", type=int, default=5)
    return parser


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    create_dataset(args.src_vid_ds_root, args.dst_img_ds_root, args.img_size, args.skip_frames)
