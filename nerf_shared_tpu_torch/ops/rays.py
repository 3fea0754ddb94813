"""Ray generation: pixel grid -> world-space rays, plus the NDC warp.

Counterpart of ``nerf_shared_tpu/ops/rays.py`` (reference utils.py:33-71).
Differentiable with respect to ``c2w``. Camera convention (OpenGL): x right,
y up, the camera looks down -z; dirs = [(i-cx)/fx, -(j-cy)/fy, -1].

``cone_radii`` / ``frame_radii``: the base radius of each pixel's cone in
mip-NeRF (Barron et al., ICCV 2021; its blender loader's ``radii``): the
distance dx between the unnormalised world directions of the pixel and
the pixel one row below, times 2/sqrt(12). The radius rides in the ray
batch (render/renderer.py).
"""

from __future__ import annotations

import math

import torch

CONE_SCALE = 2.0 / math.sqrt(12.0)


def cone_radii(rays_d: torch.Tensor, rays_d_below: torch.Tensor) -> torch.Tensor:
    """[..., 1]: dx · 2/sqrt(12), dx the distance between each ray's
    direction and the direction of the pixel one row below."""
    return torch.linalg.norm(rays_d_below - rays_d, dim=-1, keepdim=True) * CONE_SCALE


def frame_radii(rays_d: torch.Tensor) -> torch.Tensor:
    """[H, W, 1] radii of a frame's rays [H, W, 3]: each row's distance to
    the next; the last row takes the row two above it (``dx[-2:-1]``, as
    mip-NeRF's loader pads it; the equal neighbour at two rows)."""
    if rays_d.shape[0] < 2:
        raise ValueError("cone radii need frames of two rows or more")
    dx = torch.linalg.norm(rays_d[:-1] - rays_d[1:], dim=-1, keepdim=True)
    return torch.cat([dx, dx[-2:-1] if dx.shape[0] > 1 else dx], dim=0) * CONE_SCALE


def get_rays(H: int, W: int, K, c2w: torch.Tensor):
    """World-space rays for every pixel of an H×W image.

    ``K`` is a 3x3 intrinsics matrix (only fx, fy, cx, cy are read) and
    ``c2w`` a [3,4] or [4,4] tensor. Returns rays_o, rays_d, each [H, W, 3],
    on ``c2w``'s device."""
    K = torch.as_tensor(K, dtype=torch.float32, device=c2w.device)
    i, j = torch.meshgrid(
        torch.arange(W, dtype=torch.float32, device=c2w.device),
        torch.arange(H, dtype=torch.float32, device=c2w.device),
        indexing="xy",
    )
    dirs = torch.stack(
        [(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1], -torch.ones_like(i)],
        dim=-1,
    )  # [H, W, 3] camera frame
    rays_d = torch.einsum("hwc,rc->hwr", dirs, c2w[:3, :3].to(torch.float32))
    rays_o = c2w[:3, -1].to(torch.float32).expand(rays_d.shape)
    return rays_o, rays_d


def ndc_rays(H: int, W: int, focal: float, near: float, rays_o, rays_d):
    """Shift ray origins to the near plane and apply the projective NDC warp
    (reference utils.py:54-71)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (W / (2.0 * focal)) * (
        rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2])
    d1 = -1.0 / (H / (2.0 * focal)) * (
        rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]

    return torch.stack([o0, o1, o2], dim=-1), torch.stack([d0, d1, d2], dim=-1)
