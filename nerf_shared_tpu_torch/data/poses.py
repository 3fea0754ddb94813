"""Camera pose math shared by the dataset loaders (pure numpy, host-side).

A copy of ``nerf_shared_tpu/data/poses.py``: the port keeps its own so that
it imports nothing of the JAX package.

Covers the reference's pose helpers: spherical render paths
(load_blender.py:10-41, load_LINEMOD.py:10-34), average-pose recentering,
spiral path, and pose spherification (load_llff.py:125-240).
"""

from __future__ import annotations

import numpy as np


def _trans_z(t):
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = t
    return m


def _rot_phi(phi):
    c, s = np.cos(phi), np.sin(phi)
    return np.array(
        [[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]],
        dtype=np.float32,
    )


def _rot_theta(th):
    c, s = np.cos(th), np.sin(th)
    return np.array(
        [[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]],
        dtype=np.float32,
    )


def pose_spherical(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """Standard NeRF spherical camera pose (the original formulation, used by
    the LINEMOD path, reference load_LINEMOD.py:29-34)."""
    c2w = _trans_z(radius)
    c2w = _rot_phi(phi_deg / 180.0 * np.pi) @ c2w
    c2w = _rot_theta(theta_deg / 180.0 * np.pi) @ c2w
    flip = np.array(
        [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
        dtype=np.float32,
    )
    return flip @ c2w


def pose_spherical_shifted(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """The reference blender loader's *modified* spherical path: rotation
    only, then a fixed offset translation [3, 0.3, -1]
    (reference load_blender.py:36-41; the radius argument is unused there)."""
    del radius
    c2w = _rot_phi(phi_deg / 180.0 * np.pi)
    c2w = _rot_theta(theta_deg / 180.0 * np.pi) @ c2w
    shift = np.array(
        [[1, 0, 0, 3], [0, 1, 0, 0.3], [0, 0, 1, -1], [0, 0, 0, 1]],
        dtype=np.float32,
    )
    return shift @ c2w


def normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def view_matrix(z: np.ndarray, up: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Right-handed camera basis from forward axis, up hint, and position
    (reference load_llff.py:128-134)."""
    vec2 = normalize(z)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], axis=1)


def average_pose(poses: np.ndarray) -> np.ndarray:
    """Mean camera: average center, summed view/up axes
    (reference load_llff.py:140-149). poses: [N, 3, 5] (with hwf column)."""
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([view_matrix(vec2, up, center), hwf], axis=1)


def recenter_poses(poses: np.ndarray) -> np.ndarray:
    """Transform all poses into the average-camera frame
    (reference load_llff.py:166-178)."""
    out = poses.copy()
    bottom = np.array([[0, 0, 0, 1.0]], dtype=poses.dtype)
    c2w = np.concatenate([average_pose(poses)[:3, :4], bottom], axis=0)
    homog = np.concatenate(
        [poses[:, :3, :4], np.tile(bottom[None], (poses.shape[0], 1, 1))], axis=1
    )
    fixed = np.linalg.inv(c2w) @ homog
    out[:, :3, :4] = fixed[:, :3, :4]
    return out


def spiral_path(
    c2w: np.ndarray,
    up: np.ndarray,
    rads: np.ndarray,
    focal: float,
    zrate: float,
    rots: int,
    N: int,
) -> list:
    """Spiral of N camera poses around the average pose, looking at a focus
    depth (reference load_llff.py:153-162)."""
    render_poses = []
    rads = np.array(list(rads) + [1.0])
    hwf = c2w[:, 4:5]
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, N + 1)[:-1]:
        c = c2w[:3, :4] @ (
            np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0])
            * rads
        )
        z = normalize(c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        render_poses.append(np.concatenate([view_matrix(z, up, c), hwf], axis=1))
    return render_poses


def spherify_poses(poses: np.ndarray, bds: np.ndarray):
    """Recenter about the point closest to all camera axes, rescale to unit
    radius, and produce a circular render path (reference load_llff.py:184-240)."""

    def to44(p):
        bottom = np.tile(
            np.reshape(np.eye(4)[-1, :], [1, 1, 4]), [p.shape[0], 1, 1]
        )
        return np.concatenate([p, bottom], axis=1)

    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]

    # point minimizing distance to all camera z-axes (least squares)
    A_i = np.eye(3) - rays_d * np.transpose(rays_d, [0, 2, 1])
    b_i = -A_i @ rays_o
    pt_mindist = np.squeeze(
        -np.linalg.inv((np.transpose(A_i, [0, 2, 1]) @ A_i).mean(0)) @ b_i.mean(0)
    )

    center = pt_mindist
    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = normalize(up)
    vec1 = normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = normalize(np.cross(vec0, vec1))
    c2w = np.stack([vec1, vec2, vec0, center], axis=1)

    poses_reset = np.linalg.inv(to44(c2w[None])) @ to44(poses[:, :3, :4])

    rad = np.sqrt(np.mean(np.sum(np.square(poses_reset[:, :3, 3]), -1)))
    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc
    rad *= sc

    centroid = np.mean(poses_reset[:, :3, 3], 0)
    zh = centroid[2]
    radcircle = np.sqrt(rad**2 - zh**2)

    new_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, 120):
        camorigin = np.array(
            [radcircle * np.cos(th), radcircle * np.sin(th), zh]
        )
        up = np.array([0, 0, -1.0])
        vec2 = normalize(camorigin)
        vec0 = normalize(np.cross(vec2, up))
        vec1 = normalize(np.cross(vec2, vec0))
        new_poses.append(np.stack([vec0, vec1, vec2, camorigin], axis=1))
    new_poses = np.stack(new_poses, 0)

    new_poses = np.concatenate(
        [new_poses, np.broadcast_to(poses[0, :3, -1:], new_poses[:, :3, -1:].shape)],
        axis=-1,
    )
    poses_reset = np.concatenate(
        [
            poses_reset[:, :3, :4],
            np.broadcast_to(poses[0, :3, -1:], poses_reset[:, :3, -1:].shape),
        ],
        axis=-1,
    )
    return poses_reset, new_poses, bds
