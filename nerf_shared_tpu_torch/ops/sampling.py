"""Depth sampling along rays: stratified coarse samples + hierarchical
inverse-CDF resampling.

Counterpart of ``nerf_shared_tpu/ops/sampling.py`` (reference
render_utils.py:105-129 and utils.py:74-117). ``torch.searchsorted`` with
``right=True`` counts ``cdf <= u`` exactly as the JAX package's compare +
reduce does; the bin-edge lookups are ``torch.gather``. The ``t_rand=`` and
``u=`` arguments override the random draws for deterministic tests.

mip-NeRF's intervals (``--model_type mipnerf``): ``sample_along_rays`` at
N_samples + 1 gives a ray's stratified edges, and ``resample_intervals``
its fine edges: the coarse weights blurred by a 2-tap max and a 2-tap
mean, padded by ``resample_padding``, then as many new edges by
``sorted_piecewise_constant_pdf`` (mip-NeRF's ``internal/math.py``:
stratified u, the CDF forced to end at exactly 1).
"""

from __future__ import annotations

from typing import Optional

import torch


def sample_along_rays(
    near: torch.Tensor,    # [N, 1]
    far: torch.Tensor,     # [N, 1]
    N_samples: int,
    lindisp: bool = False,
    perturb: float = 1.0,
    t_rand: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Coarse z_vals per ray, [N, N_samples] (reference render_utils.py:105-129)."""
    n_rays = near.shape[0]
    t_vals = torch.linspace(0.0, 1.0, N_samples, device=near.device)
    if not lindisp:
        z_vals = near * (1.0 - t_vals) + far * t_vals
    else:
        z_vals = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)
    z_vals = z_vals.expand(n_rays, N_samples)

    if perturb > 0.0:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
        lower = torch.cat([z_vals[..., :1], mids], dim=-1)
        if t_rand is None:
            t_rand = torch.rand(z_vals.shape, generator=generator,
                                device=near.device)
        z_vals = lower + (upper - lower) * t_rand
    return z_vals


def sample_pdf(
    bins: torch.Tensor,      # [N, B] bin edges (z_vals midpoints)
    weights: torch.Tensor,   # [N, B-1] unnormalized weights
    N_samples: int,
    det: bool = False,
    u: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Inverse-CDF sampling of ``N_samples`` new depths per ray, with the
    reference's +1e-5 weight floor and denom < 1e-5 guard. Callers detach
    the result (reference render_utils.py:145)."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [N, B]

    if u is None:
        shape = cdf.shape[:-1] + (N_samples,)
        if det:
            u = torch.linspace(0.0, 1.0, N_samples, device=cdf.device)
            u = u.expand(shape)
        else:
            u = torch.rand(shape, generator=generator, device=cdf.device)
    u = u.contiguous()

    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)

    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


EPS32 = float(torch.finfo(torch.float32).eps)


def sorted_piecewise_constant_pdf(bins: torch.Tensor, weights: torch.Tensor, n: int,
                                  det: bool = False, u: Optional[torch.Tensor] = None,
                                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """n sorted samples [N, n] of the piecewise-constant pdf of ``weights``
    [N, B - 1] over the edges ``bins`` [N, B]: mip-NeRF's sampler. Weights
    summing below 1e-5 are padded up to it; u is stratified, k/n plus
    U(0, 1/n - eps) (``det``: a linspace over [0, 1 - eps]). The interval
    of each u is the last CDF entry at or below it, found by
    ``torch.searchsorted`` as mip-NeRF's mask max / min finds it."""
    eps = 1e-5
    wsum = torch.sum(weights, dim=-1, keepdim=True)
    pad = torch.clamp(eps - wsum, min=0.0)
    weights = weights + pad / weights.shape[-1]
    wsum = wsum + pad
    pdf = weights / wsum
    cdf = torch.clamp(torch.cumsum(pdf[..., :-1], dim=-1), max=1.0)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf, torch.ones_like(cdf[..., :1])], dim=-1)
    shape = cdf.shape[:-1] + (n,)
    if u is None:
        if det:
            u = torch.linspace(0.0, 1.0 - EPS32, n, device=cdf.device).expand(shape)
        else:
            s = 1.0 / n
            u = torch.arange(n, device=cdf.device) * s + torch.rand(
                shape, generator=generator, device=cdf.device) * (s - EPS32)
            u = torch.clamp(u, max=1.0 - EPS32)
    u = u.contiguous()
    idx = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(idx - 1, min=0)
    above = torch.clamp(idx, max=cdf.shape[-1] - 1)
    c0, c1 = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    b0, b1 = torch.gather(bins, -1, below), torch.gather(bins, -1, above)
    t = torch.clamp(torch.nan_to_num((u - c0) / (c1 - c0), 0.0), 0.0, 1.0)
    return b0 + t * (b1 - b0)


def blur_weights(weights: torch.Tensor, padding: float) -> torch.Tensor:
    """mip-NeRF's resampling weights: a 2-tap max over the edge-padded
    weights, then a 2-tap mean, plus ``padding``."""
    w = torch.cat([weights[..., :1], weights, weights[..., -1:]], dim=-1)
    w_max = torch.maximum(w[..., :-1], w[..., 1:])
    return 0.5 * (w_max[..., :-1] + w_max[..., 1:]) + padding


def resample_intervals(t_vals: torch.Tensor, weights: torch.Tensor, padding: float,
                       det: bool = False, u: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The fine edges [N, S + 1] from the coarse edges ``t_vals`` [N, S + 1]
    and their intervals' weights [N, S]; callers stop their gradient."""
    return sorted_piecewise_constant_pdf(t_vals, blur_weights(weights, padding),
                                         t_vals.shape[-1], det, u, generator)
