"""Volume-rendering alpha compositing: raw network outputs -> pixel values.

Counterpart of ``raw2outputs`` and ``exclusive_cumprod`` in
``nerf_shared_tpu/ops/compositing.py`` (reference render_utils.py:241-290):

  alpha   = 1 - exp(-relu(sigma + noise) * delta)   (delta_last = 1e10,
                                                      scaled by ||rays_d||)
  weights = alpha * cumprod_exclusive(1 - alpha + 1e-10)
  rgb_map = sum(weights * sigmoid(rgb));  + (1 - acc) on a white background
  depth, disp = 1 / max(1e-10, depth / max(acc, 1e-10)), acc = sum(weights)

The transmittance stays a cumprod (a log-space cumsum gives NaN cotangents
at saturated alpha) and the disparity is floored so empty rays give 1e10
instead of NaN. ``noise=`` overrides the sigma-noise draw for tests.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def exclusive_cumprod(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """cumprod with an implicit leading 1 (TF exclusive=True semantics)."""
    cp = torch.cumprod(x, dim=dim)
    ones = torch.ones_like(cp.narrow(dim, 0, 1))
    return torch.cat([ones, cp.narrow(dim, 0, x.shape[dim] - 1)], dim=dim)


def raw2outputs(
    raw: torch.Tensor,       # [N, S, >=4]
    z_vals: torch.Tensor,    # [N, S]
    rays_d: torch.Tensor,    # [N, 3]
    raw_noise_std: float = 0.0,
    white_bkgd: bool = False,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
):
    """raw -> (rgb_map, disp_map, acc_map, weights, depth_map)."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    # the sentinel is shaped from z_vals, so one sample per ray still gets
    # its interval (the JAX package's dists[..., :1] is empty at S = 1)
    dists = torch.cat([dists, torch.full_like(z_vals[..., :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(rays_d[..., None, :], dim=-1)

    rgb = torch.sigmoid(raw[..., :3])
    sigma = raw[..., 3]
    if noise is None:
        if raw_noise_std > 0.0:
            noise = torch.randn(sigma.shape, generator=generator,
                                device=sigma.device) * raw_noise_std
        else:
            noise = 0.0
    alpha = 1.0 - torch.exp(-F.relu(sigma + noise) * dists)

    weights = alpha * exclusive_cumprod(1.0 - alpha + 1e-10, dim=-1)

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    disp_map = 1.0 / torch.clamp(
        depth_map / torch.clamp(acc_map, min=1e-10), min=1e-10)

    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return rgb_map, disp_map, acc_map, weights, depth_map
