"""DeepVoxels dataset loader.

Counterpart of ``nerf_shared_tpu/data/deepvoxels.py`` (reference
load_deepvoxels.py:6-108): intrinsics.txt (focal/center/near/scale/size
and an optional world2cam flag), per-image pose txt files with the y/z
axis-flip transform, train/validation/test directories with testskip
striding on validation and test, 512x512 images, render path = the test
poses.
"""

from __future__ import annotations

import os

import numpy as np

from nerf_shared_tpu_torch.data.images import imread_float

_AXIS_FLIP = np.array([[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1.0]])


def parse_intrinsics(filepath: str, trgt_sidelength: int, invert_y: bool = False):
    """(4x4 intrinsic, grid barycenter, scale, near plane, world2cam) of an
    intrinsics.txt, the intrinsics rescaled to a trgt_sidelength square."""
    with open(filepath) as f:
        focal, cx, cy = list(map(float, f.readline().split()))[:3]
        grid_barycenter = np.array(list(map(float, f.readline().split())))
        near_plane = float(f.readline())
        scale = float(f.readline())
        height, width = map(float, f.readline().split())
        try:
            world2cam = bool(int(f.readline()))
        except (ValueError, TypeError):
            world2cam = False

    cx = cx / width * trgt_sidelength
    cy = cy / height * trgt_sidelength
    focal = trgt_sidelength / height * focal
    fy = -focal if invert_y else focal
    full_intrinsic = np.array([[focal, 0.0, cx, 0.0], [0.0, fy, cy, 0.0],
                               [0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]])
    return full_intrinsic, grid_barycenter, scale, near_plane, world2cam


def _load_pose(path: str) -> np.ndarray:
    with open(path) as f:
        nums = [float(x) for x in f.read().split()]
    return np.asarray(nums, dtype=np.float32).reshape(4, 4)


def _dir_poses(posedir: str) -> np.ndarray:
    files = sorted(f for f in os.listdir(posedir) if f.endswith("txt"))
    poses = np.stack([_load_pose(os.path.join(posedir, f)) for f in files], 0)
    poses = poses @ _AXIS_FLIP
    return poses[:, :3, :4].astype(np.float32)


def _dir_images(imgdir: str, stride: int = 1) -> np.ndarray:
    files = sorted(f for f in os.listdir(imgdir) if f.endswith("png"))[::stride]
    return np.stack([imread_float(os.path.join(imgdir, f)) for f in files],
                    0).astype(np.float32)


def load_dv_data(scene: str = "cube", basedir: str = "/data/deepvoxels", testskip: int = 8):
    """Returns (imgs, poses, render_poses, [H, W, focal], i_split)."""
    H = W = 512
    train_base = os.path.join(basedir, "train", scene)
    full_intrinsic, _, _, _, _ = parse_intrinsics(
        os.path.join(train_base, "intrinsics.txt"), H)
    focal = full_intrinsic[0, 0]

    poses = _dir_poses(os.path.join(train_base, "pose"))
    testposes = _dir_poses(os.path.join(basedir, "test", scene, "pose"))[::testskip]
    valposes = _dir_poses(os.path.join(basedir, "validation", scene, "pose"))[::testskip]

    imgs = _dir_images(os.path.join(train_base, "rgb"))
    testimgs = _dir_images(os.path.join(basedir, "test", scene, "rgb"), testskip)
    valimgs = _dir_images(os.path.join(basedir, "validation", scene, "rgb"), testskip)

    all_imgs = [imgs, valimgs, testimgs]
    counts = np.cumsum([0] + [x.shape[0] for x in all_imgs])
    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]

    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate([poses, valposes, testposes], 0)
    return imgs, poses, testposes, [H, W, focal], i_split
