"""Occupancy-grid accelerated rendering: sample-level empty-space skipping.

Counterpart of ``nerf_shared_tpu/render/occupancy.py``. A binary occupancy
grid over the scene AABB, built from the trained model's own density field,
decides which sample points reach the network:

  1. ``build_occupancy_grid`` probes sigma at jittered points inside every
     cell of a G³ grid (through ``_apply_model``: kernel B1 under
     ``use_pallas``), thresholds alpha over one cell crossing, and dilates
     by one cell (a 3³ max-pool) so the grid is conservative.
  2. ``render_flat_rays_occ`` places C candidate depths per ray, looks each
     up in the grid, and keeps K occupied ones (the nearest, or the largest
     estimated contribution). Only those K points reach the network (kernel
     B3); padding slots composite with sigma -1e10, so they contribute
     nothing (kernel B5). ``n_fine > 0`` adds a hierarchical refinement pass
     on top (``refine_hierarchical``), whose depths come back as ``z_vals``.

The [rays, K] rectangle is kept as in the JAX package; ``gate_rays`` drops
rays with no occupied candidate first (one host fetch of the active count).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from nerf_shared_tpu_torch.ops.rays import get_rays
from nerf_shared_tpu_torch.ops.sampling import sample_along_rays, sample_pdf
from nerf_shared_tpu_torch.render.gated import pow2_blocks
from nerf_shared_tpu_torch.render.renderer import (
    RenderConfig,
    _apply_model,
    _apply_model_rays,
    _composite,
    _model_parts,
    split_rays,
)

_PAD = 1e8  # sort key offset that pushes unoccupied candidates past every z


class OccupancyGrid(NamedTuple):
    """Binary occupancy over an axis-aligned box. ``sigma`` (optional)
    carries the max-dilated relu density the grid was thresholded from, so
    consumers can rank candidates by estimated contribution."""

    grid: torch.Tensor      # [G0, G1, G2] bool
    aabb_min: torch.Tensor  # [3] float32
    aabb_max: torch.Tensor  # [3] float32
    sigma: Optional[torch.Tensor] = None  # [G0, G1, G2] float32 (relu'd)

    @property
    def resolution(self) -> int:
        return self.grid.shape[0]

    def occupied_fraction(self) -> float:
        return float(self.grid.float().mean())


def _cells(shape, aabb_min, aabb_max, pts):
    """(flat cell index [...], in_box [...]) of pts [..., 3] in a grid of
    ``shape`` over the box; indices are clipped into the grid."""
    dims = torch.tensor(shape, dtype=torch.float32, device=pts.device)
    u = (pts - aabb_min) / (aabb_max - aabb_min)
    in_box = ((u >= 0.0) & (u < 1.0)).all(-1)
    idx = (u * dims).to(torch.int64)
    idx = torch.minimum(idx.clamp(min=0), dims.to(torch.int64) - 1)
    g0, g1, g2 = shape
    return (idx[..., 0] * g1 + idx[..., 1]) * g2 + idx[..., 2], in_box


def lookup(occ: OccupancyGrid, pts: torch.Tensor) -> torch.Tensor:
    """pts [..., 3] -> bool [...]: True iff the containing cell is occupied.
    Points outside the AABB are unoccupied."""
    flat, in_box = _cells(tuple(occ.grid.shape), occ.aabb_min, occ.aabb_max, pts)
    return occ.grid.reshape(-1)[flat] & in_box


def lookup_values(values: torch.Tensor, aabb_min, aabb_max,
                  pts: torch.Tensor) -> torch.Tensor:
    """pts [..., 3] -> float [...]: the nearest cell of a [G,G,G] value
    grid; 0 outside the AABB."""
    flat, in_box = _cells(tuple(values.shape), aabb_min, aabb_max, pts)
    return torch.where(in_box, values.reshape(-1)[flat], 0.0)


def lookup_sigma(occ: OccupancyGrid, pts: torch.Tensor) -> torch.Tensor:
    """pts [..., 3] -> float32 [...]: the cell's stored max density (0 outside
    the AABB or when the grid carries no sigma)."""
    if occ.sigma is None:
        return torch.zeros(pts.shape[:-1], dtype=torch.float32, device=pts.device)
    return lookup_values(occ.sigma, occ.aabb_min, occ.aabb_max, pts)


def estimate_contribution(sigma, widths, mask):
    """Estimated compositing weight w = alpha·T per candidate from grid
    densities: alpha = 1 - exp(-sigma·width) on masked entries (0 elsewhere),
    T = exclusive cumprod of (1 - alpha + 1e-10). Shared by the froxel and
    world-grid weighted selections."""
    alpha = torch.where(mask, 1.0 - torch.exp(-sigma * widths), 0.0)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    return alpha * trans


def rank_pack_topk(mask: torch.Tensor, weight: torch.Tensor, n_keep: int):
    """Top-K by weight among masked entries, in ascending index order:
    (quantized 1-w) << 10 | index packs rank and identity into one int32
    key; one sort selects, a K-wide sort restores index order. Zero-weight
    ties fall back to nearest first through the index.
    mask/weight [T, C] -> (idx [T, K] int64 clipped to C-1, valid [T, K])."""
    C = mask.shape[-1]
    if C > 1024:
        raise ValueError(f"rank_pack_topk: {C} candidates; the index has 10 bits")
    big = 1 << 30
    iota = torch.arange(C, dtype=torch.int32, device=mask.device)
    rank = ((1.0 - weight).clamp(0.0, 1.0) * float((1 << 20) - 1)).to(torch.int32) << 10
    keys = torch.where(mask, rank | iota, big)
    sel = torch.sort(keys, dim=-1).values[:, :n_keep]
    idx = torch.where(sel < big, sel & 1023, 2 * C)
    idx = torch.sort(idx, dim=-1).values.to(torch.int64)
    valid = idx < C
    return idx.clamp(max=C - 1), valid


def _dilate(grid_f: torch.Tensor, iterations: int) -> torch.Tensor:
    """3³ max-pool dilation: grow occupancy (or density) by one cell per
    iteration."""
    for _ in range(iterations):
        grid_f = F.max_pool3d(grid_f[None, None], 3, stride=1, padding=1)[0, 0]
    return grid_f


def coarsen(occ: OccupancyGrid, factor: int) -> OccupancyGrid:
    """Conservative low-resolution view: a coarse cell is occupied iff any of
    its factor³ fine cells is, then dilated by one coarse cell — a strict
    superset, so a ray with no coarse hit has no fine hit."""
    g = occ.grid.shape[0]
    if g % factor:
        raise ValueError(f"grid {g} is not a multiple of {factor}")
    f = F.max_pool3d(occ.grid.float()[None, None], factor, stride=factor)[0, 0]
    return OccupancyGrid(_dilate(f, 1) > 0.5, occ.aabb_min, occ.aabb_max)


def _device_of(params) -> torch.device:
    return next(iter(params.values())).device


@torch.no_grad()
def build_occupancy_grid(
    params,
    cfg,
    rcfg: RenderConfig,
    aabb_min,
    aabb_max,
    resolution: int = 128,
    generator: Optional[torch.Generator] = None,
    n_jitter: int = 4,
    alpha_threshold: float = 1e-3,
    dilation: int = 1,
    block: int = 65536,
    jitter: Optional[torch.Tensor] = None,
) -> OccupancyGrid:
    """Mark every cell whose density would absorb more than
    ``alpha_threshold`` over one cell crossing, taking the max sigma over
    ``n_jitter`` uniformly jittered probes per cell (the cell center when
    n_jitter is 0), then dilate. Cells are probed in blocks of ``block``
    points, each as one ray of ``block`` samples with one fixed view
    direction (sigma does not read it). ``jitter`` [n_jitter, G³, 3] in
    [-0.5, 0.5) pins the probe offsets (in cells), else they are drawn from
    ``generator`` on the parameters' device."""
    device = _device_of(params)
    g = int(resolution)
    lo = torch.as_tensor(np.asarray(aabb_min, np.float32), device=device).reshape(3)
    hi = torch.as_tensor(np.asarray(aabb_max, np.float32), device=device).reshape(3)
    cell = (hi - lo) / g
    ax = (torch.arange(g, dtype=torch.float32, device=device) + 0.5) / g
    centers = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1)
    centers = lo + centers.reshape(-1, 3) * (hi - lo)
    n = centers.shape[0]
    if jitter is not None and tuple(jitter.shape) != (n_jitter, n, 3):
        raise ValueError(f"jitter has shape {tuple(jitter.shape)}, "
                         f"expected {(n_jitter, n, 3)}")
    dummy_dirs = (torch.full((1, 3), 1.0 / math.sqrt(3.0), device=device)
                  if cfg.use_viewdirs else None)

    sigma = torch.empty(n, dtype=torch.float32, device=device)
    for i in range(0, n, block):
        pts_c = centers[i:i + block]
        sig = torch.zeros(pts_c.shape[0], dtype=torch.float32, device=device)
        for j in range(max(n_jitter, 1)):
            if n_jitter == 0:
                pts = pts_c
            elif jitter is not None:
                pts = pts_c + jitter[j, i:i + block].to(device) * cell
            else:
                pts = pts_c + (torch.rand(pts_c.shape, generator=generator,
                                          device=device) - 0.5) * cell
            raw = _apply_model(params, cfg, pts[None], dummy_dirs, rcfg)
            sig = torch.maximum(sig, raw[0, :, 3])
        sigma[i:i + block] = sig

    step = torch.linalg.norm(cell)
    occ = F.relu(sigma) * step > -math.log1p(-min(alpha_threshold, 0.999))
    grid_f = _dilate(occ.reshape(g, g, g).float(), dilation)
    # sigma is max-dilated like the bits, so cells marked only by dilation
    # inherit their neighbour's density for weighted ranking
    sigma_grid = _dilate(F.relu(sigma).reshape(g, g, g), dilation)
    return OccupancyGrid(grid_f > 0.5, lo, hi, sigma_grid)


class OccupancyMaintainer:
    """In-training grid maintenance: the render hooks ask for the grid at a
    training step and get one rebuilt from the current fine network when it
    is older than ``min_interval`` steps (hooks of one step share a build).
    Each build's jitter is drawn from a generator seeded by the step."""

    def __init__(self, rcfg: RenderConfig, fcfg, aabb_min, aabb_max,
                 resolution: int = 128, alpha_threshold: float = 1e-3,
                 min_interval: int = 1):
        self.rcfg, self.fcfg = rcfg, fcfg
        self.aabb_min = np.asarray(aabb_min, np.float32)
        self.aabb_max = np.asarray(aabb_max, np.float32)
        self.resolution = int(resolution)
        self.alpha_threshold = float(alpha_threshold)
        self.min_interval = int(min_interval)
        self._grid: Optional[OccupancyGrid] = None
        self._built_at = -(1 << 30)

    def get(self, params_fine, step: int) -> OccupancyGrid:
        if self._grid is None or step - self._built_at >= self.min_interval:
            gen = torch.Generator(device=_device_of(params_fine)).manual_seed(step)
            self._grid = build_occupancy_grid(
                params_fine, self.fcfg, self.rcfg, self.aabb_min, self.aabb_max,
                resolution=self.resolution,
                alpha_threshold=self.alpha_threshold, generator=gen)
            self._built_at = step
        return self._grid


def aabb_from_poses(H, W, K, poses, near: float, far: float,
                    margin: float = 0.05) -> tuple:
    """Conservative scene AABB (numpy [3] each): the min/max over every
    pose's origin and its four corner rays' near and far points, expanded by
    ``margin`` of the span."""
    poses = np.asarray(poses)
    if poses.ndim == 2:
        poses = poses[None]
    pts = []
    corners = [(0, 0), (0, W - 1), (H - 1, 0), (H - 1, W - 1)]
    for c2w in poses:
        ro, rd = get_rays(H, W, K, torch.as_tensor(c2w[:3, :4], dtype=torch.float32))
        ro, rd = ro.numpy(), rd.numpy()
        for (i, j) in corners:
            pts.append(ro[i, j] + rd[i, j] * near)
            pts.append(ro[i, j] + rd[i, j] * far)
        pts.append(ro[0, 0])
    pts = np.stack(pts)
    lo, hi = pts.min(0), pts.max(0)
    span = hi - lo
    return lo - margin * span, hi + margin * span


def _topk_nearest_occupied(z_cand, occ_c, n_keep, far, method):
    """The ``n_keep`` nearest occupied candidate depths per ray (z_cand
    [R, C] is ascending). "sort" offsets unoccupied keys past every depth
    and sorts; "onehot" ranks occupied entries with a cumsum and takes each
    rank-k depth with a masked sum. Returns (z_sel [R, K], padding at
    ``far``; valid [R, K])."""
    if method == "sort":
        key = torch.where(occ_c, z_cand, z_cand + _PAD)
        z_sorted = torch.sort(key, dim=-1).values[:, :n_keep]
        valid = z_sorted < _PAD / 2
        return torch.where(valid, z_sorted, far), valid
    if method != "onehot":
        raise ValueError(f"unknown selection {method!r}")
    rank = torch.cumsum(occ_c.to(torch.int32), dim=-1) - 1
    ks = torch.arange(n_keep, dtype=torch.int32, device=z_cand.device)
    onehot = (rank[..., None] == ks) & occ_c[..., None]          # [R, C, K]
    z_sel = torch.where(onehot, z_cand[..., None], 0.0).sum(-2)
    n_active = occ_c.to(torch.int32).sum(-1).clamp(max=n_keep)
    valid = ks < n_active[:, None]
    return torch.where(valid, z_sel, far), valid


def _topk_weighted_occupied(z_cand, sig_c, occ_c, n_keep, far):
    """The ``n_keep`` occupied candidates with the largest estimated
    contribution alpha·T from the grid's density, in ascending depth order
    (zero-weight ties: nearest first). Returns (z_sel padded to ``far``,
    valid)."""
    deltas = torch.diff(z_cand, dim=-1)
    deltas = torch.cat([deltas, deltas[:, -1:]], dim=-1)
    w = estimate_contribution(sig_c, deltas, occ_c)
    idx, valid = rank_pack_topk(occ_c, w, n_keep)
    z_sel = torch.gather(z_cand, 1, idx)
    return torch.where(valid, z_sel, far), valid


def background_maps(shape, rcfg: RenderConfig, device,
                    n_samples: int = 0) -> Dict[str, torch.Tensor]:
    """The maps of rays that reach no occupied sample, of leading ``shape``:
    the background colour, disp 1e10, acc 0 and no kept samples (what
    compositing all-padding rays gives); with ``n_samples`` also their
    ``z_vals``, all at far."""
    bg = 1.0 if rcfg.white_bkgd else 0.0
    shape = tuple(shape)
    out = {
        "rgb_map": torch.full(shape + (3,), bg, dtype=torch.float32, device=device),
        "disp_map": torch.full(shape, 1e10, dtype=torch.float32, device=device),
        "acc_map": torch.zeros(shape, dtype=torch.float32, device=device),
        "n_active": torch.zeros(shape, dtype=torch.int64, device=device),
    }
    if n_samples:
        out["z_vals"] = torch.full(shape + (n_samples,), float(rcfg.far),
                                   dtype=torch.float32, device=device)
    return out


def _masked_sigma(raw, keep):
    """raw [..., 4] with sigma -1e10 where ``keep`` is False: those samples
    composite to zero weight."""
    sigma = torch.where(keep, raw[..., 3], -1e10)
    return torch.cat([raw[..., :3], sigma[..., None]], dim=-1)


def refine_hierarchical(params, fcfg, rcfg, rays_o, rays_d, viewdirs,
                        z_sel, valid, weights, n_fine, generator=None):
    """Hierarchical refinement of a gated coarse pass: ``n_fine`` new depths
    by inverse CDF from the coarse weights, merged with the coarse depths,
    and the network re-evaluated at the union (the reference's fine-pass
    semantics, render_utils.py:137-155). Coarse padding at z = far re-enters
    unmasked; rays with no occupied candidate keep the background through a
    full sigma mask. Returns (rgb, disp, acc, z_vals), z_vals the depths the
    fine pass evaluated."""
    z_mid = 0.5 * (z_sel[..., 1:] + z_sel[..., :-1])
    z_samples = sample_pdf(z_mid, weights[..., 1:-1], n_fine,
                           det=(rcfg.perturb == 0.0), generator=generator).detach()
    z_all = torch.sort(torch.cat([z_sel, z_samples], -1), -1).values.contiguous()
    raw = _apply_model_rays(params, fcfg, rays_o, rays_d, z_all, viewdirs, rcfg)
    live = valid.any(-1, keepdim=True).expand_as(z_all)
    rgb, disp, acc, _, _ = _composite(_masked_sigma(raw, live), z_all, rays_d,
                                      rcfg, generator=generator)
    return rgb, disp, acc, z_all


def _render_occ_block(params_fine, occ: OccupancyGrid, rb, rcfg: RenderConfig,
                      fcfg, n_candidates: int, n_keep: int, select: str,
                      n_fine: int = 0, generator=None) -> Dict[str, torch.Tensor]:
    """Candidate triage + top-K selection + masked render of one ray block;
    ``n_fine > 0`` adds refine_hierarchical and its depths (``z_vals``)."""
    rays_o, rays_d, viewdirs = split_rays(rb)
    near, far = rb[:, 6:7], rb[:, 7:8]
    z_cand = sample_along_rays(near, far, n_candidates, lindisp=rcfg.lindisp,
                               perturb=rcfg.perturb, generator=generator)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_cand[..., None]
    occ_c = lookup(occ, pts)
    if select == "weighted":
        if occ.sigma is None:
            raise ValueError(
                "select='weighted' needs an OccupancyGrid carrying sigma "
                "(build_occupancy_grid attaches it); this grid is bits-only")
        z_sel, valid = _topk_weighted_occupied(
            z_cand, lookup_sigma(occ, pts), occ_c, n_keep, far)
    else:
        z_sel, valid = _topk_nearest_occupied(z_cand, occ_c, n_keep, far, select)
    z_sel = z_sel.contiguous()

    raw = _apply_model_rays(params_fine, fcfg, rays_o, rays_d, z_sel, viewdirs,
                            rcfg)
    rgb, disp, acc, weights, _ = _composite(_masked_sigma(raw, valid), z_sel,
                                            rays_d, rcfg, generator=generator)
    out = {"n_active": valid.sum(-1)}
    if n_fine > 0:
        rgb, disp, acc, out["z_vals"] = refine_hierarchical(
            params_fine, fcfg, rcfg, rays_o, rays_d, viewdirs, z_sel, valid,
            weights, n_fine, generator)
    return {"rgb_map": rgb, "disp_map": disp, "acc_map": acc, **out}


def _occ_render_blocks(params_fine, occ, rays, rcfg, fcfg, n_candidates,
                       n_keep, block, select="sort", n_fine=0, generator=None):
    outs = [_render_occ_block(params_fine, occ, rays[i:i + block], rcfg, fcfg,
                              n_candidates, n_keep, select, n_fine, generator)
            for i in range(0, rays.shape[0], block)]
    return {k: torch.cat([o[k] for o in outs], 0) for k in outs[0]}


def _occ_ray_counts(occ: OccupancyGrid, rays, lindisp: bool,
                    n_candidates: int, block: int) -> torch.Tensor:
    """Occupied-candidate count per ray at deterministic placement: grid
    lookups only, no network (the ray gate's triage)."""
    counts = []
    for i in range(0, rays.shape[0], block):
        rb = rays[i:i + block]
        z = sample_along_rays(rb[:, 6:7], rb[:, 7:8], n_candidates,
                              lindisp=lindisp, perturb=0.0)
        pts = rb[:, None, 0:3] + rb[:, None, 3:6] * z[..., None]
        counts.append(lookup(occ, pts).sum(-1))
    return torch.cat(counts, 0)


def render_flat_rays_occ(
    rays_flat: torch.Tensor,   # [N, 8|11]
    fine_model,                # NeRF module or (params, cfg)
    occ: OccupancyGrid,
    rcfg: RenderConfig,
    fcfg=None,
    chunk: int = 1024 * 32,
    generator: Optional[torch.Generator] = None,
    n_candidates: int = 128,
    n_keep: int = 64,
    select: str = "sort",
    gate_rays: bool = False,
    occ_coarse: Optional[OccupancyGrid] = None,
    count_candidates: int = 64,
    n_fine: int = 0,
) -> Dict[str, torch.Tensor]:
    """Occupancy-gated render of a flat ray batch: C candidate depths per
    ray triaged by the grid, K of the occupied ones through the network.
    Exact when the grid is exact and no ray has more than K occupied
    candidates. ``gate_rays`` also skips the network for rays with no
    occupied candidate in a coarsened grid (a conservative superset): a
    lookup-only counting pass, then device-side compaction into power-of-two
    blocks with one host fetch of the active count; the result then carries
    ``active_ray_fraction`` (a float)."""
    pf, fcfg_m = _model_parts(fine_model)
    fcfg = fcfg if fcfg is not None else fcfg_m
    n = rays_flat.shape[0]
    if not gate_rays:
        return _occ_render_blocks(pf, occ, rays_flat, rcfg, fcfg, n_candidates,
                                  n_keep, min(chunk, max(n, 1)), select, n_fine,
                                  generator)

    if occ_coarse is None:
        factor = max(occ.grid.shape[0] // 32, 1)
        occ_coarse = coarsen(occ, factor) if factor > 1 else occ
    counts = _occ_ray_counts(occ_coarse, rays_flat, rcfg.lindisp,
                             count_candidates, min(chunk, max(n, 1)))
    mask = counts > 0
    order = torch.argsort((~mask).to(torch.int8), stable=True)  # active first
    n_active = int(mask.sum())  # the one host fetch
    out = background_maps((n,), rcfg, rays_flat.device,
                          n_samples=n_keep + n_fine if n_fine > 0 else 0)
    out["active_ray_fraction"] = n_active / max(n, 1)
    if n_active == 0:
        return out
    block, idx = pow2_blocks(n_active, n, chunk, order)
    ret = _occ_render_blocks(pf, occ, rays_flat[idx], rcfg, fcfg, n_candidates,
                             n_keep, block, select, n_fine, generator)
    scatter = order[:n_active]
    for k, v in ret.items():
        out[k] = out[k].index_put((scatter,), v[:n_active])
    return out
