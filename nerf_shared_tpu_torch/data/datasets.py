"""Dataset dispatch + per-type bounds/intrinsics rules.

Counterpart of ``nerf_shared_tpu/data/datasets.py`` (reference
utils.py:216-313). This slice of the port reads the blender format; the
other dataset types raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from nerf_shared_tpu_torch.data import blender

# dataset types the JAX package reads that the port does not yet
_NOT_PORTED = {
    "llff": "ROADMAP A10 (LLFF loader + NDC render path)",
    "LINEMOD": "ROADMAP A10 (LINEMOD loader)",
    "deepvoxels": "ROADMAP A10 (deepvoxels loader)",
}


@dataclasses.dataclass
class Dataset:
    """Everything the renderer needs, as plain numpy host arrays."""

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
    if args.dataset_type in _NOT_PORTED:
        raise NotImplementedError(
            f"dataset_type {args.dataset_type!r} is not ported to "
            f"nerf_shared_tpu_torch yet: {_NOT_PORTED[args.dataset_type]}")
    if args.dataset_type != "blender":
        raise ValueError(f"Unknown dataset type {args.dataset_type!r}")

    images, poses, render_poses, hwf, i_split, near, far = (
        blender.load_blender_data(args.datadir, args.half_res, args.testskip)
    )
    i_train, i_val, i_test = i_split
    images = _composite_background(images, args.white_bkgd)

    H, W, focal = hwf
    H, W = int(H), int(W)
    K = np.array(
        [[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], np.float64)

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
