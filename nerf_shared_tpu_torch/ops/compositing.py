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

The transmittance's backward reads nothing on the host. torch's own
``cumprod`` backward tests its input for zeros with ``.item()``, which
stops the host until the card has run everything before it, twice a
training step; ``exclusive_cumprod`` takes torch's zero-free formula
(bit for bit the same gradients) and handles a zero factor with masks on
the device.

``composite_intervals`` is mip-NeRF's (Barron et al., ICCV 2021,
``volumetric_rendering``) for ``--model_type mipnerf``: samples are
intervals [t_i, t_i+1] with delta = (t_i+1 - t_i)·|d| and no sentinel,
density softplus(sigma + density_bias), colour sigmoid(rgb)·(1 + 2 pad)
- pad, transmittance exp(-(exclusive cumsum of density·delta)), and the
depth the weights' mean of the interval midpoints, clipped to the ray's
span.

``distortion_loss`` and ``interlevel_loss`` are the mip-NeRF 360 training
regularizers of the same JAX module (the distortion and the proposal
histogram bound); both drop the final sample, which rides the 1e10
sentinel interval.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def exclusive_cumprod(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """cumprod with an implicit leading 1 (TF exclusive=True semantics)."""
    return _ExclusiveCumprod.apply(x, dim)


class _ExclusiveCumprod(torch.autograd.Function):
    """``exclusive_cumprod`` with a backward that makes no host read."""

    @staticmethod
    def forward(ctx, x, dim):
        cp = torch.cumprod(x, dim=dim)
        ones = torch.ones_like(cp.narrow(dim, 0, 1))
        out = torch.cat([ones, cp.narrow(dim, 0, x.shape[dim] - 1)], dim=dim)
        ctx.dim = dim
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        """From the input and the output, in differentiable torch ops.

        The inclusive cumprod cp has the cotangent g shifted one place down
        (g_cp[m] = g[m + 1], 0 at the end), and cp[m] = out[m + 1]. Before
        a row's first zero factor the gradient is torch's zero-free
        formula, reversed_cumsum(cp * g_cp) / x; at the first zero it is
        the product of the factors before it (out) times the reversed
        cumsum of g_cp times the product of the factors after it; past it,
        0. Its own gradient (a double backward) is exact on rows without a
        zero factor; on the others it leaves out the terms that pair the
        first zero with a later factor."""
        x, out = ctx.saved_tensors
        dim, n = ctx.dim, x.shape[ctx.dim]
        zero = torch.zeros_like(g.narrow(dim, 0, 1))
        g_cp = torch.cat([g.narrow(dim, 1, n - 1), zero], dim=dim)
        w = torch.cat([(out * g).narrow(dim, 1, n - 1), zero], dim=dim)
        is_zero = x == 0
        zeros_so_far = torch.cumsum(is_zero, dim=dim)
        before = zeros_so_far == 0
        first = is_zero & (zeros_so_far == 1)
        below = _reversed_cumsum(w, dim) / torch.where(before, x, 1.0)
        after = torch.cumprod(torch.where(before | first, 1.0, x), dim=dim)
        at_first = out * _reversed_cumsum(g_cp * after, dim)
        return torch.where(before, below, torch.where(first, at_first, 0.0)), None


def _reversed_cumsum(t: torch.Tensor, dim: int) -> torch.Tensor:
    return t.flip(dim).cumsum(dim).flip(dim)


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


def composite_intervals(raw: torch.Tensor, t_vals: torch.Tensor, rays_d: torch.Tensor,
                        density_bias: float, rgb_padding: float, white_bkgd: bool):
    """raw [N, S, 4] of the intervals between edges t_vals [N, S + 1] ->
    (rgb_map, disp_map, acc_map, weights, depth_map), mip-NeRF's
    activations and composite (module docstring); disp = 1 / depth."""
    rgb = torch.sigmoid(raw[..., :3]) * (1 + 2 * rgb_padding) - rgb_padding
    density = F.softplus(raw[..., 3] + density_bias)
    t_dists = t_vals[..., 1:] - t_vals[..., :-1]
    delta = t_dists * torch.linalg.norm(rays_d[..., None, :], dim=-1)
    density_delta = density * delta
    alpha = 1 - torch.exp(-density_delta)
    trans = torch.exp(-torch.cat([torch.zeros_like(density_delta[..., :1]),
                                  torch.cumsum(density_delta[..., :-1], dim=-1)], dim=-1))
    weights = alpha * trans
    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    acc_map = torch.sum(weights, dim=-1)
    t_mids = 0.5 * (t_vals[..., :-1] + t_vals[..., 1:])
    # nan (an empty ray) -> 0, clipped to the near end, as mip-NeRF's
    # jnp.nan_to_num(distance, jnp.inf) does (its second argument is copy)
    depth = torch.nan_to_num(torch.sum(weights * t_mids, dim=-1) / acc_map)
    depth = torch.minimum(torch.maximum(depth, t_vals[..., 0]), t_vals[..., -1])
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return rgb_map, 1.0 / depth, acc_map, weights, depth


def distortion_loss(z_vals: torch.Tensor, weights: torch.Tensor, near: float,
                    far: float) -> torch.Tensor:
    """mip-NeRF 360's distortion loss (Barron et al. 2022, eq. 15), the mean
    over rays of sum_ij w_i w_j |m_i - m_j| + (1/3) sum_i w_i^2 ds_i over the
    normalised distance s = (z - near) / (far - near), m the interval
    midpoints. The pairwise term is the prefix-sum identity
    2 sum_i w_i (m_i A_i - B_i), A / B the exclusive prefix sums of w and
    w m (two cumsums, no [N, S, S] tensor)."""
    s = (z_vals - near) / max(far - near, 1e-9)
    sm = 0.5 * (s[..., 1:] + s[..., :-1])
    ds = s[..., 1:] - s[..., :-1]
    w = weights[..., :-1]
    a = torch.cumsum(w, dim=-1) - w
    b = torch.cumsum(w * sm, dim=-1) - w * sm
    pairwise = 2.0 * torch.sum(w * (sm * a - b), dim=-1)
    self_term = torch.sum(w * w * ds, dim=-1) / 3.0
    return torch.mean(pairwise + self_term)


def interlevel_loss(z_prop: torch.Tensor, w_prop: torch.Tensor,
                    z_fine: torch.Tensor, w_fine: torch.Tensor,
                    eps: float = 1e-7) -> torch.Tensor:
    """The proposal (interlevel) loss, mip-NeRF 360 eq. 13-14 in the NeRF
    weight convention (weight i on [z_i, z_i+1]): for each final interval
    the proposal mass on the intervals overlapping it must reach the final
    mass inside it; the squared deficit over the final mass, summed over
    intervals and averaged over rays. The final histogram is detached, so
    the gradient reaches the proposal alone. The overlap bound is one
    batched product of the [N, Sf-1, Sp-1] overlap mask with the proposal
    masses, in fp32."""
    pl, pr = z_prop[..., :-1], z_prop[..., 1:]
    wp = w_prop[..., :-1]
    fl, fr = z_fine[..., :-1].detach(), z_fine[..., 1:].detach()
    wf = w_fine[..., :-1].detach()
    overlap = ((pr[..., None, :] > fl[..., :, None])
               & (pl[..., None, :] < fr[..., :, None]))
    bound = torch.matmul(overlap.to(wp.dtype), wp[..., None])[..., 0]
    excess = torch.clamp(wf - bound, min=0.0)
    return torch.mean(torch.sum(excess ** 2 / (wf + eps), dim=-1))
