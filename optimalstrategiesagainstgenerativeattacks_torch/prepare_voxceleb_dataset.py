"""VoxCeleb2 mp4 -> frame-JPEG dataset, with the port's own copy of the preparation.

    python -m optimalstrategiesagainstgenerativeattacks_torch.prepare_voxceleb_dataset \\
        --src_vid_ds_root <voxceleb2>/dev/mp4 --dst_img_ds_root <ds> \\
        [--img_size 64] [--skip_frames 5]

The flags of the root ``prepare_voxceleb_dataset.py``, which imports the JAX
package and so needs JAX installed; this one needs only numpy, and cv2 and
PIL to decode the videos.  Host code: it runs no kernel and no device.
"""

from optimalstrategiesagainstgenerativeattacks_torch.data.voxceleb_prep import main

if __name__ == "__main__":
    main()
