"""mip-NeRF's cone tracing: conical frustums as Gaussians, and the
integrated positional encoding (IPE) of a Gaussian.

Barron et al., "Mip-NeRF: A Multiscale Representation for Anti-Aliasing
Neural Radiance Fields" (ICCV 2021), the equations of its
``internal/mip.py``:

- each pixel casts a cone of base radius ``cone_radii`` (ops/rays.py); the
  interval [t0, t1] of a ray is a conical frustum, lifted to a Gaussian of
  mean o + t_mean·d and diagonal covariance t_var·d² + r_var·(1 - d²/|d|²)
  with the stable forms of ``frustum_gaussians``;
- the IPE of a Gaussian (mean μ, per-coordinate variance σ²) at the
  frequencies 2^l, l in [min_deg, max_deg), is the expected sinusoid
  sin(2^l μ)·exp(-4^l σ²/2) and cos(2^l μ)·exp(-4^l σ²/2), with no identity
  columns.

Column order (``ipe``): the port's embedding order, frequency-major, per
frequency the three sines then the three cosines ([sin(f0 μ), cos(f0 μ),
sin(f1 μ), ...], as ``ops/embedding.embed`` orders its bands), so the
kernels' encoder tables (ops/cuda/fused_mlp.py ``encoder_tables``) serve
both encodings. mip-NeRF's own code puts every sine before every cosine;
``tests/plain/mipnerf.py`` maps one order onto the other.

A Gaussian goes to the network as one record [..., 6]: the mean, then the
variances (``gaussian_record``), which is what kernels B1 and B2 read
through their IPE encoder (csrc/mlp_tile_tc.cuh ``IpeEnc``).
"""

from __future__ import annotations

from typing import Tuple

import torch


def frustum_gaussians(d: torch.Tensor, t0: torch.Tensor, t1: torch.Tensor,
                      radii: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean offset [N, S, 3], covariance diagonal [N, S, 3]) of the conical
    frustums [t0, t1] ([N, S]) along directions d [N, 3] with base radii
    [N, 1], in the stable forms of mip-NeRF's
    ``conical_frustum_to_gaussian`` (the mean is relative to the origin)."""
    mu = (t0 + t1) / 2
    hw = (t1 - t0) / 2
    den = 3 * mu ** 2 + hw ** 2
    t_mean = mu + (2 * mu * hw ** 2) / den
    t_var = (hw ** 2) / 3 - (4 / 15) * ((hw ** 4 * (12 * mu ** 2 - hw ** 2)) / den ** 2)
    r_var = radii ** 2 * ((mu ** 2) / 4 + (5 / 12) * hw ** 2 - 4 / 15 * (hw ** 4) / den)
    mean = d[..., None, :] * t_mean[..., None]
    d_mag_sq = torch.clamp(torch.sum(d ** 2, dim=-1, keepdim=True), min=1e-10)
    d_outer = d ** 2
    null_outer = 1 - d_outer / d_mag_sq
    cov = t_var[..., None] * d_outer[..., None, :] + r_var[..., None] * null_outer[..., None, :]
    return mean, cov


def cast_rays(t_vals: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor,
              radii: torch.Tensor) -> torch.Tensor:
    """The Gaussian records [N, S, 6] (mean, variances) of the S intervals
    between the S + 1 edges ``t_vals`` [N, S + 1] of each cone."""
    mean, cov = frustum_gaussians(rays_d, t_vals[..., :-1], t_vals[..., 1:], radii)
    return gaussian_record(mean + rays_o[..., None, :], cov)


def gaussian_record(mean: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
    """[..., 6]: the mean, then the diagonal of the covariance."""
    return torch.cat([mean, cov], dim=-1).contiguous()


def ipe_freqs(min_deg: int, max_deg: int) -> list:
    """The IPE's frequencies 2^l, l in [min_deg, max_deg)."""
    return [float(2.0 ** l) for l in range(min_deg, max_deg)]


def ipe(mean: torch.Tensor, var: torch.Tensor, min_deg: int, max_deg: int) -> torch.Tensor:
    """The integrated positional encoding [..., 6 (max_deg - min_deg)] of
    Gaussians (mean, variance [..., 3]), in the module's column order. Each
    argument f·μ and each scaled variance f²·σ² is one product (exact for
    the power-of-two f), as the kernels' IpeEnc forms them."""
    parts = []
    for f in ipe_freqs(min_deg, max_deg):
        y = mean * f
        att = torch.exp(-0.5 * (var * (f * f)))
        parts += [torch.sin(y) * att, torch.cos(y) * att]
    return torch.cat(parts, dim=-1)
