"""Blender (nerf_synthetic) dataset loader.

Counterpart of ``nerf_shared_tpu/data/blender.py`` (reference
load_blender.py:44-98): three transforms_{split}.json files, RGBA images
/255, testskip stride on val/test, focal from camera_angle_x, the 40-pose
shifted spherical render path, half_res area-downsampling. 'near'/'far' are
read from the json when present, else (2, 6).
"""

from __future__ import annotations

import json
import os

import numpy as np

from nerf_shared_tpu_torch.data.images import imread_float, resize_area
from nerf_shared_tpu_torch.data.poses import pose_spherical_shifted

DEFAULT_NEAR, DEFAULT_FAR = 2.0, 6.0


def load_blender_data(basedir: str, half_res: bool = False, testskip: int = 1):
    """Returns (imgs [N,H,W,4], poses [N,4,4], render_poses [40,4,4],
    [H, W, focal], i_split, near, far)."""
    splits = ("train", "val", "test")
    metas = {}
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json")) as fp:
            metas[s] = json.load(fp)

    all_imgs, all_poses, counts = [], [], [0]
    near, far = DEFAULT_NEAR, DEFAULT_FAR
    for s in splits:
        meta = metas[s]
        near = float(meta.get("near", near))
        far = float(meta.get("far", far))
        skip = 1 if (s == "train" or testskip == 0) else testskip
        imgs, poses = [], []
        for frame in meta["frames"][::skip]:
            fname = os.path.join(basedir, frame["file_path"] + ".png")
            imgs.append(imread_float(fname))
            poses.append(np.asarray(frame["transform_matrix"], np.float32))
        imgs = np.stack(imgs, 0).astype(np.float32)
        poses = np.stack(poses, 0)
        counts.append(counts[-1] + imgs.shape[0])
        all_imgs.append(imgs)
        all_poses.append(poses)

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)

    H, W = imgs[0].shape[:2]
    camera_angle_x = float(metas["test"]["camera_angle_x"])
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)

    render_poses = np.stack(
        [
            pose_spherical_shifted(angle, 0.0, 4.0)
            for angle in np.linspace(-180, 180, 40 + 1)[:-1]
        ],
        0,
    )

    if half_res:
        H, W = H // 2, W // 2
        focal = focal / 2.0
        imgs = np.stack([resize_area(im, H, W) for im in imgs], 0)

    return imgs, poses, render_poses, [H, W, focal], i_split, near, far
