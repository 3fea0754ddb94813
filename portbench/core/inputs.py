"""Everything a run feeds both sides, made from ``--seed``: the weights,
the training images and poses, the render path and each request's pose.

Weights and images are made on the run's device by a ``torch.Generator``
there, each set in one call; the poses are small and made on the host
with numpy. The pose math (the blender loader's 40-pose shifted orbit,
the LLFF spiral) is the published loaders' (nerf-pytorch
``load_blender.py`` and ``load_llff.py``), kept here so that the inputs do
not depend on the measured program.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Tuple

import numpy as np
import torch

from portbench.reference import nerf as ref


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of run seed ``seed``."""
    h = hashlib.blake2b(f"{int(seed)}:{tag}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") >> 1


def device_generator(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, tag))
    return g


def net_of(cfg: dict) -> dict:
    """The network's sizes as the reference takes them."""
    f = cfg["flags"]
    return {"depth": f["netdepth"], "width": f["netwidth"], "skips": (4,),
            "multires": f["multires"], "multires_views": f["multires_views"]}


def make_weights(seed: int, cfg: dict, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"coarse", "fine": name -> tensor}: weights ~ U(-sqrt(6 / fan_in),
    sqrt(6 / fan_in)) (He's uniform init, which keeps the activations' scale
    through the ReLU layers, so densities and colours vary over the scene
    as a trained field's do), biases ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in));
    one uniform draw on the device for each network. Then the density
    head's bias is shifted so that the mean density over seeded points of
    the scene's box is the configuration's ``density_mean``: a random
    network's mean density is otherwise as likely negative as not, and a
    frame of an empty field would show nothing of the network."""
    ref.no_tf32()
    net = net_of(cfg)
    ds = cfg["dataset"]
    lo, hi = (torch.tensor(v, dtype=torch.float32, device=device) for v in ds["density_box"])
    shapes = ref.param_shapes(net["depth"], net["width"], net["skips"], net["multires"],
                              net["multires_views"])
    out = {}
    for branch in ("coarse", "fine"):
        total = sum(math.prod(s) for _, s in shapes)
        u = torch.rand(total, generator=device_generator(seed, "weights/" + branch, device),
                       device=device)
        leaves, at = {}, 0
        fan_in = None
        for name, shape in shapes:
            if name.endswith(".weight"):
                fan_in = shape[1]
            n = math.prod(shape)
            bound = math.sqrt((6.0 if name.endswith(".weight") else 1.0) / fan_in)
            leaves[name] = ((u[at:at + n] * 2.0 - 1.0) * bound).reshape(shape)
            at += n
        g = device_generator(seed, "density/" + branch, device)
        pts = lo + (hi - lo) * torch.rand((4096, 1, 3), generator=g, device=device)
        dirs = torch.nn.functional.normalize(
            torch.randn((4096, 3), generator=g, device=device), dim=-1)
        sigma = ref.mlp(leaves, net, pts, dirs)[..., 3]
        leaves["alpha_linear.bias"] += ds["density_mean"] - sigma.mean()
        out[branch] = leaves
    return out


# ------------------------------------------------------------------ poses

def _rot_x(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]], np.float64)


def _rot_y(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]], np.float64)


def orbit_pose(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """A camera on the sphere of ``radius`` looking at the origin (the
    blender scenes' training views)."""
    c2w = np.eye(4)
    c2w[2, 3] = radius
    c2w = _rot_y(math.radians(theta_deg)) @ _rot_x(math.radians(phi_deg)) @ c2w
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float64)
    return flip @ c2w


def blender_render_path(n: int = 40) -> np.ndarray:
    """The blender loader's render path: rotations about the origin then a
    fixed shift [3, 0.3, -1], ``n`` angles over the circle."""
    shift = np.array([[1, 0, 0, 3], [0, 1, 0, 0.3], [0, 0, 1, -1], [0, 0, 0, 1]], np.float64)
    return np.stack([(shift @ _rot_y(math.radians(a)) @ _rot_x(0.0))[:3, :4]
                     for a in np.linspace(-180, 180, n + 1)[:-1]]).astype(np.float32)


def _normalize(v):
    return v / np.linalg.norm(v)


def _view(z, up, pos):
    z = _normalize(z)
    x = _normalize(np.cross(up, z))
    return np.stack([x, np.cross(z, x), z, pos], axis=1)


def llff_spiral(poses: np.ndarray, near: float, far: float, n: int = 120,
                rots: int = 2, zrate: float = 0.5) -> np.ndarray:
    """The LLFF loader's spiral around the mean camera, focused at the
    harmonic blend of the depth bounds."""
    center = poses[:, :3, 3].mean(0)
    up = poses[:, :3, 1].sum(0)
    c2w = _view(poses[:, :3, 2].sum(0), up, center)
    focal = 1.0 / ((1.0 - 0.75) / (near * 0.9) + 0.75 / (far * 5.0))
    rads = np.append(np.percentile(np.abs(poses[:, :3, 3]), 90, 0), 1.0)
    out = []
    for th in np.linspace(0.0, 2.0 * np.pi * rots, n + 1)[:-1]:
        c = c2w @ (np.array([math.cos(th), -math.sin(th), -math.sin(th * zrate), 1.0]) * rads)
        z = _normalize(c - c2w @ np.array([0, 0, -focal, 1.0]))
        out.append(_view(z, _normalize(up), c))
    return np.stack(out).astype(np.float32)


def rotation(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = _normalize(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + math.sin(angle) * k + (1 - math.cos(angle)) * (k @ k)


def jittered(c2w: np.ndarray, rng: np.random.Generator, rot_deg: float,
             trans: float) -> np.ndarray:
    """``c2w`` turned about a random axis by up to ``rot_deg`` and moved by
    up to ``trans`` along each axis."""
    out = np.array(c2w, np.float64)
    out[:3, :3] = rotation(rng.normal(size=3), math.radians(rot_deg) * rng.uniform(-1, 1)) \
        @ out[:3, :3]
    out[:3, 3] += rng.uniform(-trans, trans, size=3)
    return out.astype(np.float32)


# ------------------------------------------------------------------ scenes

def scene_of(cfg: dict) -> dict:
    """The scene's shapes and the render settings the reference needs."""
    f, ds = cfg["flags"], cfg["dataset"]
    H, W = ds["H"], ds["W"]
    if ds["kind"] == "blender":
        focal = 0.5 * (2 * W) / math.tan(0.5 * ds["camera_angle_x"]) / 2.0
    else:
        focal = ds["focal"]
    return {"H": H, "W": W, "focal": focal,
            "K": [[focal, 0.0, 0.5 * W], [0.0, focal, 0.5 * H], [0.0, 0.0, 1.0]],
            "ndc": ds["kind"] == "llff", "near": ds["near"], "far": ds["far"],
            "N_samples": f["N_samples"], "N_importance": f["N_importance"],
            "N_rand": f["N_rand"], "chunk": f["chunk"], "white_bkgd": bool(f.get("white_bkgd", False)),
            "raw_noise_std": float(f.get("raw_noise_std", 0.0)),
            "single_image": bool(f.get("no_batching", False)),
            "precrop_iters": int(f.get("precrop_iters", 0)),
            "precrop_frac": float(f.get("precrop_frac", 0.5))}


def make_poses(seed: int, cfg: dict) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(poses [N, 3, 4], render_path [M, 3, 4], i_train, i_test) of the
    configuration's dataset, from the seed."""
    ds = cfg["dataset"]
    rng = np.random.default_rng(sub_seed(seed, "poses"))
    n = ds["n_views"]
    if ds["kind"] == "blender":
        poses = np.stack([orbit_pose(rng.uniform(-180, 180), rng.uniform(-90, 0),
                                     ds["radius"])[:3, :4] for _ in range(n)])
        return (poses.astype(np.float32), blender_render_path(ds["render_path_views"]),
                np.arange(n), np.arange(0))
    # forward-facing: cameras near the origin looking down -z
    poses = []
    for _ in range(n):
        p = np.eye(4)[:3]
        p[:, :3] = rotation(rng.normal(size=3), math.radians(ds["view_spread_deg"])
                            * rng.uniform(-1, 1))
        p[:, 3] = rng.uniform(-1, 1, size=3) * np.array(ds["offset_spread"])
        poses.append(p)
    poses = np.stack(poses).astype(np.float32)
    i_test = np.arange(n)[::ds["llffhold"]]
    i_train = np.array([i for i in range(n) if i not in i_test])
    path = llff_spiral(poses, ds["bounds"][0], ds["bounds"][1], ds["render_path_views"])
    return poses, path, i_train, i_test


def make_images(seed: int, cfg: dict, n: int, device) -> torch.Tensor:
    """[n, H, W, 3] training images ~ U(0, 1), one draw on the device."""
    ds = cfg["dataset"]
    return torch.rand((n, ds["H"], ds["W"], 3), generator=device_generator(seed, "images", device),
                      device=device)


def request_pose(seed: int, path: np.ndarray, k: int, jitter: dict) -> np.ndarray:
    """The [3, 4] pose of request ``k``: the render path walked from a
    seeded start, each pose jittered from the seed."""
    start = sub_seed(seed, "requests") % len(path)
    rng = np.random.default_rng(sub_seed(seed, f"request/{k}"))
    c2w = np.vstack([path[(start + k) % len(path)], [0, 0, 0, 1]])
    return jittered(c2w, rng, jitter["rot_deg"], jitter["trans"])[:3]
