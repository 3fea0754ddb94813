"""LLFF (forward-facing capture) dataset loader.

Counterpart of ``nerf_shared_tpu/data/llff.py`` (reference
load_llff.py:243-316): poses_bounds.npy (3x5 pose+hwf columns, 2 depth
bounds), the factor-downsampled images_{factor}/ cache (``minify_images``),
the [down, right, back] -> [right, up, back] axis swap, the
1/(bds.min*bd_factor) scene rescale, average-pose recentering, the
spherified or spiral render path (``path_zflat`` too), and the
closest-to-mean holdout view. Images may be PNG or baseline JPEG.
"""

from __future__ import annotations

import os

import numpy as np

from nerf_shared_tpu_torch.data.images import (
    image_files,
    imread_float,
    minify_images,
)
from nerf_shared_tpu_torch.data.poses import (
    average_pose,
    normalize,
    recenter_poses,
    spherify_poses,
    spiral_path,
)


def _load_poses_and_images(basedir: str, factor: int | None):
    arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses = arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])  # [3,5,N]
    bds = arr[:, -2:].transpose([1, 0])  # [2,N]

    if factor is not None and factor != 1:
        imgdir = minify_images(basedir, factor)
        sc = 1.0 / factor
    else:
        imgdir = os.path.join(basedir, "images")
        sc = 1.0

    names = image_files(imgdir)
    if poses.shape[-1] != len(names):
        raise ValueError(
            f"{len(names)} images but {poses.shape[-1]} poses in {basedir}")

    imgs = np.stack([imread_float(os.path.join(imgdir, f))[..., :3] for f in names], 0)
    sh = imgs[0].shape
    poses[:2, 4, :] = np.array(sh[:2]).reshape([2, 1])  # actual H, W
    poses[2, 4, :] = poses[2, 4, :] * sc  # focal scaled by factor
    return poses, bds, imgs


def load_llff_data(basedir: str, factor: int = 8, recenter: bool = True,
                   bd_factor: float = 0.75, spherify: bool = False,
                   path_zflat: bool = False):
    """Returns (images [N,H,W,3], poses [N,3,5], bds [N,2],
    render_poses [M,3,5], i_test)."""
    poses, bds, imgs = _load_poses_and_images(basedir, factor)

    # LLFF stores [down, right, back]; NeRF wants [right, up, back]
    poses = np.concatenate([poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], axis=1)
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)  # [N,3,5]
    images = imgs.astype(np.float32)                       # [N,H,W,3]
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)       # [N,2]

    # rescale so the nearest depth bound sits at 1/bd_factor
    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds *= sc

    if recenter:
        poses = recenter_poses(poses)

    if spherify:
        poses, render_poses, bds = spherify_poses(poses, bds)
    else:
        c2w = average_pose(poses)
        up = normalize(poses[:, :3, 1].sum(0))

        # focus depth from the harmonic blend of the depth bounds
        close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
        dt = 0.75
        focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)

        # spiral radii from the 90th percentile of camera offsets
        rads = np.percentile(np.abs(poses[:, :3, 3]), 90, 0)
        c2w_path = c2w
        N_views, N_rots = 120, 2
        if path_zflat:
            zloc = -close_depth * 0.1
            c2w_path[:3, 3] = c2w_path[:3, 3] + zloc * c2w_path[:3, 2]
            rads[2] = 0.0
            N_rots = 1
            N_views //= 2
        render_poses = spiral_path(c2w_path, up, rads, focal, zrate=0.5,
                                   rots=N_rots, N=N_views)

    render_poses = np.asarray(render_poses, dtype=np.float32)

    # holdout: the view closest to the average pose (reference :309-311)
    c2w = average_pose(poses)
    dists = np.sum(np.square(c2w[:3, 3] - poses[:, :3, 3]), -1)
    i_test = int(np.argmin(dists))

    return images, poses.astype(np.float32), bds, render_poses, i_test
