"""LINEMOD dataset loader.

Counterpart of ``nerf_shared_tpu/data/linemod.py`` (reference
load_LINEMOD.py:37-93): blender-style transforms_{split}.json files whose
frames carry their image's full path and an intrinsic matrix (K from the
first test frame); near / far the floor / ceil over the train and test
metas; the spherical render path at phi = -30; half_res area-downsamples
(``resize_area``) to 3 channels.
"""

from __future__ import annotations

import json
import os

import numpy as np

from nerf_shared_tpu_torch.data.images import imread_float, resize_area
from nerf_shared_tpu_torch.data.poses import pose_spherical


def load_LINEMOD_data(basedir: str, half_res: bool = False, testskip: int = 1):
    """Returns (imgs, poses, render_poses, [H, W, focal], K, i_split, near, far)."""
    splits = ("train", "val", "test")
    metas = {}
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json")) as fp:
            metas[s] = json.load(fp)

    all_imgs, all_poses, counts = [], [], [0]
    for s in splits:
        skip = 1 if (s == "train" or testskip == 0) else testskip
        imgs, poses = [], []
        for frame in metas[s]["frames"][::skip]:
            imgs.append(imread_float(frame["file_path"]))
            poses.append(np.asarray(frame["transform_matrix"], np.float32))
        imgs = np.stack(imgs, 0).astype(np.float32)
        counts.append(counts[-1] + imgs.shape[0])
        all_imgs.append(imgs)
        all_poses.append(np.stack(poses, 0))

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)

    H, W = imgs[0].shape[:2]
    K = np.asarray(metas["test"]["frames"][0]["intrinsic_matrix"], np.float64)
    focal = float(K[0][0])

    render_poses = np.stack([pose_spherical(angle, -30.0, 4.0)
                             for angle in np.linspace(-180, 180, 40 + 1)[:-1]], 0)

    if half_res:
        H, W = H // 2, W // 2
        focal = focal / 2.0
        imgs = np.stack([resize_area(im[..., :3], H, W) for im in imgs], 0)

    near = float(np.floor(min(metas["train"]["near"], metas["test"]["near"])))
    far = float(np.ceil(max(metas["train"]["far"], metas["test"]["far"])))
    return imgs, poses, render_poses, [H, W, focal], K, i_split, near, far
