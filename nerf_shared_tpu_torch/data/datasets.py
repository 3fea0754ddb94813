"""Dataset dispatch + per-type bounds/intrinsics rules.

Counterpart of ``nerf_shared_tpu/data/datasets.py`` (reference
utils.py:216-313): the four dataset types (llff, blender, LINEMOD,
deepvoxels), the llffhold test split, the NDC-vs-scene near/far rules,
white-background alpha-compositing, the deepvoxels hemisphere bounds, the
pinhole K from the focal when the loader gives none, and the render_test
pose swap.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from nerf_shared_tpu_torch.data import blender, deepvoxels, linemod, llff


@dataclasses.dataclass
class Dataset:
    """Everything the trainer and the renderer need, as plain numpy host
    arrays."""

    images: np.ndarray        # [N, H, W, 3] float32
    poses: np.ndarray         # [N, 3|4, 4] float32
    render_poses: np.ndarray  # [M, ...]
    hwf: Tuple[int, int, float]
    i_train: np.ndarray
    i_val: np.ndarray
    i_test: np.ndarray
    K: np.ndarray             # 3x3 intrinsics
    near: float
    far: float

    @property
    def i_split(self):
        return self.i_train, self.i_val, self.i_test

    @property
    def bds_dict(self):
        return {"near": self.near, "far": self.far}


def load_datasets(args) -> Dataset:
    """Dispatch on args.dataset_type (reference utils.py:216-313)."""
    K = None

    if args.dataset_type == "llff":
        images, poses, bds, render_poses, i_test = llff.load_llff_data(
            args.datadir, args.factor, recenter=True, bd_factor=0.75,
            spherify=args.spherify)
        hwf = poses[0, :3, -1]
        poses = poses[:, :3, :4]
        if not isinstance(i_test, (list, np.ndarray)):
            i_test = [i_test]
        if args.llffhold > 0:
            i_test = np.arange(images.shape[0])[:: args.llffhold]
        i_val = np.asarray(i_test)
        i_train = np.array([i for i in np.arange(images.shape[0])
                            if (i not in i_test and i not in i_val)])
        if args.no_ndc:
            near, far = float(bds.min()) * 0.9, float(bds.max()) * 1.0
        else:
            near, far = 0.0, 1.0

    elif args.dataset_type == "blender":
        images, poses, render_poses, hwf, i_split, near, far = (
            blender.load_blender_data(args.datadir, args.half_res, args.testskip))
        i_train, i_val, i_test = i_split
        images = _composite_background(images, args.white_bkgd)

    elif args.dataset_type == "LINEMOD":
        images, poses, render_poses, hwf, K, i_split, near, far = (
            linemod.load_LINEMOD_data(args.datadir, args.half_res, args.testskip))
        i_train, i_val, i_test = i_split
        images = _composite_background(images, args.white_bkgd)

    elif args.dataset_type == "deepvoxels":
        images, poses, render_poses, hwf, i_split = deepvoxels.load_dv_data(
            scene=args.shape, basedir=args.datadir, testskip=args.testskip)
        i_train, i_val, i_test = i_split
        # bounds from the capture hemisphere radius (reference utils.py:283-285)
        hemi_R = float(np.mean(np.linalg.norm(poses[:, :3, -1], axis=-1)))
        near, far = hemi_R - 1.0, hemi_R + 1.0

    else:
        raise ValueError(f"Unknown dataset type {args.dataset_type!r}")

    H, W, focal = hwf
    H, W = int(H), int(W)
    if K is None:
        K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    K = np.asarray(K, np.float64)

    if args.render_test:
        render_poses = np.array(poses[np.asarray(i_test)])

    return Dataset(
        images=np.ascontiguousarray(images, np.float32),
        poses=np.ascontiguousarray(poses, np.float32),
        render_poses=np.asarray(render_poses, np.float32),
        hwf=(H, W, float(focal)),
        i_train=np.asarray(i_train),
        i_val=np.asarray(i_val),
        i_test=np.asarray(i_test),
        K=K,
        near=float(near),
        far=float(far),
    )


def _composite_background(images: np.ndarray, white_bkgd: bool) -> np.ndarray:
    """RGBA -> RGB: alpha-blend onto white, or drop alpha
    (reference utils.py:255-258)."""
    if images.shape[-1] < 4:
        return images
    if white_bkgd:
        return images[..., :3] * images[..., -1:] + (1.0 - images[..., -1:])
    return images[..., :3]
