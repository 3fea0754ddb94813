"""Occupancy-gated training: spend the network only where the scene is.

Counterpart of ``nerf_shared_tpu/train/occ_train.py`` (NerfAcc-style
density grids, PAPERS.md):

  - A density grid (``DensityGrid``: an EMA of periodic probes over the
    scene AABB, every cell at the ``_UNINIT`` sentinel until its first
    probe) tracks where the evolving field is non-empty
    (``update_density_grid``), and ``binarize_density_grid`` thresholds it
    into the binary ``OccupancyGrid`` of render/occupancy.py.
  - Each step draws C jittered stratified candidates per ray, looks them up
    in the binary grid, and keeps K of the occupied ones chosen uniformly at
    random (``_random_k_of_occupied``: the k-th smallest random key from a
    full sort, compacted in depth order by the cumsum / one-hot rank), or,
    with a density grid (--train_occ_budget), by an Exp(1)/w race.
  - Only the fine network trains, through ``_apply_model`` (kernels B1
    forward and B2 backward under ``fused_backward`` on CUDA tensors, the
    grid families' P1 / P2); invalid slots composite with sigma -1e10 via
    the plain ``_composite`` (the trainer clears ``use_pallas``). The
    coarse branch (and any per-image group) gets zero gradients, so Adam
    decays its moments and moves it exactly as optax does on the JAX
    state's zero coarse gradients.

Random draws come from a ``torch.Generator`` on the rays' device; every
draw can be pinned through ``draws`` for tests: ``occ_nerf_loss`` takes
``t_rand`` (the candidates' jitter), ``u`` (the selection's race
uniforms in [1e-7, 1)), ``explore_u`` and ``noise`` (sigma noise, already
scaled by ``raw_noise_std``); ``update_density_grid`` takes ``idx`` (the
probed cells under ``max_probes``) and ``jitter`` (offsets in cells in
[-0.5, 0.5), one row per probe). There is no superstep: the trainer
(apps/train.py) runs one step at a time and refreshes the grid once per
dispatch window of the JAX trainer.

Data-parallel (``world``, as ``make_occ_train_step(mesh=)``): each rank
draws ceil(N_rand / n) rays from its own generator; the grid and the
parameters stay replicated and the gradients are mean-reduced before Adam,
the aux values as in train/step.py. The trainer refreshes the grid from
a generator that is the same on every rank, from parameters that are
equal on every rank, so every rank holds the same grid.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from nerf_shared_tpu_torch.ops.sampling import sample_along_rays
from nerf_shared_tpu_torch.render.occupancy import (
    OccupancyGrid,
    _dilate,
    lookup,
    lookup_values,
)
from nerf_shared_tpu_torch.render.renderer import (
    RenderConfig,
    _apply_model,
    _composite,
    split_rays,
)
from nerf_shared_tpu_torch.train.pipeline import PixelSamplerSpec, pixel_rays, sample_pixels
from nerf_shared_tpu_torch.train.state import TrainState
from nerf_shared_tpu_torch.parallel.distributed import World, all_reduce_grads
from nerf_shared_tpu_torch.train.step import local_spec, pack_ray_batch, reduce_aux
from nerf_shared_tpu_torch.utils.metrics import img2mse, mse2psnr


def _pinned(x, dtype, device) -> torch.Tensor:
    """A pinned draw (an array or a tensor on any device) as a tensor on
    ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


class DensityGrid(NamedTuple):
    """EMA density over the scene AABB. ``ema`` starts at the _UNINIT
    sentinel: every cell binarizes occupied until its first probe."""

    ema: torch.Tensor       # [G, G, G] float32
    aabb_min: torch.Tensor  # [3]
    aabb_max: torch.Tensor  # [3]


# "no probe yet": binarizes occupied, and the first update replaces it with
# the probe instead of EMA-ing (1e4 * 0.95^n would stay occupied for ~270
# updates)
_UNINIT = 1e4


def init_density_grid(aabb_min, aabb_max, resolution: int,
                      device=None) -> DensityGrid:
    def box(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device).reshape(3)

    return DensityGrid(
        torch.full((resolution,) * 3, _UNINIT, dtype=torch.float32, device=device),
        box(aabb_min), box(aabb_max))


def _probe_points(grid: DensityGrid, idx: Optional[torch.Tensor]) -> torch.Tensor:
    """Cell centres [m, 3]: of the cells ``idx`` (flat indices), or of every
    cell in C order."""
    g = grid.ema.shape[0]
    lo, hi = grid.aabb_min, grid.aabb_max
    if idx is not None:
        ijk = torch.stack([idx // (g * g), (idx // g) % g, idx % g], -1)
        return lo + (ijk.to(torch.float32) + 0.5) / g * (hi - lo)
    ax = (torch.arange(g, dtype=torch.float32, device=lo.device) + 0.5) / g
    centers = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1)
    return lo + centers.reshape(-1, 3) * (hi - lo)


@torch.no_grad()
def update_density_grid(
    grid: DensityGrid,
    params_fine,
    fcfg,
    rcfg: RenderConfig,
    generator: Optional[torch.Generator] = None,
    decay: float = 0.95,
    block: int = 65536,
    max_probes: Optional[int] = None,
    draws: Optional[Dict] = None,
) -> DensityGrid:
    """One maintenance pass: probe cells at one uniformly jittered point
    each, ema = max(ema * decay, sigma) (relu'd sigma; the first probe of a
    cell replaces _UNINIT). Points go through ``_apply_model`` with the
    caller's config in blocks of ``block``, each as one ray of samples with
    one fixed view direction (sigma does not read it).

    ``max_probes`` < G³ probes that many random cells (with replacement):
    unprobed cells decay, unprobed _UNINIT cells stay occupied, and a cell
    drawn more than once keeps the largest of its updates."""
    draws = draws or {}
    device = grid.ema.device
    g = grid.ema.shape[0]
    n = g ** 3
    cell = (grid.aabb_max - grid.aabb_min) / g
    dirs = (torch.full((1, 3), 1.0 / math.sqrt(3.0), device=device)
            if fcfg.use_viewdirs else None)
    subsampled = max_probes is not None and max_probes < n
    idx = None
    if subsampled:
        m = int(max_probes)
        idx = (_pinned(draws["idx"], torch.int64, device) if "idx" in draws else
               torch.randint(0, n, (m,), generator=generator, device=device))
    else:
        m = n
    centers = _probe_points(grid, idx)
    jitter = draws.get("jitter")
    if jitter is not None:
        jitter = _pinned(jitter, torch.float32, device)
    sigma = torch.empty(m, dtype=torch.float32, device=device)
    for i in range(0, m, block):
        pts_c = centers[i:i + block]
        off = (jitter[i:i + block] if jitter is not None else
               torch.rand(pts_c.shape, generator=generator, device=device) - 0.5)
        raw = _apply_model(params_fine, fcfg, (pts_c + off * cell)[None], dirs, rcfg)
        sigma[i:i + block] = F.relu(raw[0, :, 3])
    if subsampled:
        flat = grid.ema.reshape(-1)
        decayed = torch.where(flat >= _UNINIT, flat, flat * decay)
        old = flat[idx]
        new_vals = torch.where(old >= _UNINIT, sigma, torch.maximum(old * decay, sigma))
        # a cell drawn twice keeps the larger of its updates (XLA's scatter
        # leaves the winner of duplicate writes unspecified; an amax is the
        # same on every device and run)
        ema = decayed.scatter_reduce(0, idx, new_vals, "amax",
                                     include_self=False).reshape((g,) * 3)
    else:
        sigma = sigma.reshape((g,) * 3)
        ema = torch.where(grid.ema >= _UNINIT, sigma,
                          torch.maximum(grid.ema * decay, sigma))
    return DensityGrid(ema, grid.aabb_min, grid.aabb_max)


@torch.no_grad()
def binarize_density_grid(grid: DensityGrid, alpha_threshold: float = 1e-3,
                          dilation: int = 1,
                          force_occupied: bool = False) -> OccupancyGrid:
    """EMA densities -> a conservative binary grid: occupied where alpha
    over one cell's diagonal exceeds ``alpha_threshold``, dilated by
    ``dilation`` cells; it carries the dilated relu'd EMA as its sigma
    (unprobed cells hold _UNINIT and rank first). ``force_occupied`` marks
    every cell occupied (the training warmup; no sigma)."""
    if force_occupied:
        return OccupancyGrid(torch.ones(grid.ema.shape, dtype=torch.bool,
                                        device=grid.ema.device),
                             grid.aabb_min, grid.aabb_max)
    g = grid.ema.shape[0]
    step = torch.linalg.norm((grid.aabb_max - grid.aabb_min) / g)
    occ = grid.ema * step > -math.log1p(-min(alpha_threshold, 0.999))
    grid_f = _dilate(occ.to(torch.float32), dilation)
    sigma = _dilate(F.relu(grid.ema), dilation)
    return OccupancyGrid(grid_f > 0.5, grid.aabb_min, grid.aabb_max, sigma)


def _random_k_of_occupied(z_cand, occ_c, n_keep: int, far, explore: float = 0.0,
                          weights=None, generator: Optional[torch.Generator] = None,
                          draws: Optional[Dict] = None):
    """Keep ``n_keep`` of each ray's occupied candidates chosen at random,
    compacted in depth order. z_cand [R, C] ascending, occ_c [R, C] bool ->
    (z_sel [R, K] ascending, padding = far; valid [R, K]).

    Race keys u ~ U[1e-7, 1) (``draws["u"]``); ``explore`` > 0 marks each
    unoccupied candidate occupied with that probability (``draws
    ["explore_u"]``); ``weights`` [R, C] turn the race into Exp(1)/w with a
    floor of 0.25x the mean occupied weight. The k-th smallest key of a
    full sort decides (keys <= kth & occupied), so ties and padding behave
    as in the JAX version."""
    draws = draws or {}
    dev = z_cand.device

    def uniform(name, lo=0.0):
        if name in draws:
            return _pinned(draws[name], torch.float32, dev)
        u = torch.rand(z_cand.shape, generator=generator, device=dev)
        return u * (1.0 - lo) + lo if lo else u

    u = uniform("u", 1e-7)
    if explore > 0.0:
        occ_c = occ_c | (uniform("explore_u") < explore)
    if weights is not None:
        w = torch.clamp(weights, min=0.0)
        occ_f = occ_c.to(torch.float32)
        mean_w = torch.sum(torch.where(occ_c, w, 0.0), -1, keepdim=True) / (
            torch.sum(occ_f, -1, keepdim=True) + 1e-6)
        w = w + 0.25 * mean_w + 1e-6
        u = -torch.log(u) / w
    keys = torch.where(occ_c, u, torch.inf)
    kth = torch.sort(keys, dim=-1).values[:, n_keep - 1:n_keep]
    chosen = (keys <= kth) & occ_c
    rank = torch.cumsum(chosen.to(torch.int32), dim=-1) - 1
    ks = torch.arange(n_keep, dtype=torch.int32, device=dev)
    onehot = (rank[..., None] == ks) & chosen[..., None]          # [R, C, K]
    z_sel = torch.where(onehot, z_cand[..., None], 0.0).sum(-2)
    n_sel = torch.clamp(chosen.to(torch.int32).sum(-1), max=n_keep)
    valid = ks < n_sel[:, None]
    return torch.where(valid, z_sel, far), valid


def occ_nerf_loss(params: Dict, occ: OccupancyGrid, ray_batch, target,
                  rcfg: RenderConfig, fcfg, n_candidates: int, n_keep: int,
                  explore: float = 0.0, density: Optional[DensityGrid] = None,
                  tv_reg: float = 0.0, generator: Optional[torch.Generator] = None,
                  draws: Optional[Dict] = None):
    """(loss, aux): MSE of the grid-gated fine render against the target
    pixels [+ tv_reg * the fine planes' total variation]. ``density`` (an
    EMA grid) makes the selection density-proportional (candidate
    budgeting). aux: img_loss, psnr, n_active_mean, acc_mean, loss (and tv
    when it applies), on the device."""
    draws = draws or {}
    rays_o, rays_d, viewdirs = split_rays(ray_batch)
    near, far = ray_batch[:, 6:7], ray_batch[:, 7:8]
    t_rand = draws.get("t_rand")
    if t_rand is not None:
        t_rand = _pinned(t_rand, torch.float32, ray_batch.device)
    z_cand = sample_along_rays(near, far, n_candidates, lindisp=rcfg.lindisp,
                               perturb=rcfg.perturb, t_rand=t_rand, generator=generator)
    pts = (rays_o[:, None, :] + rays_d[:, None, :] * z_cand[..., None]).detach()
    occ_c = lookup(occ, pts)
    weights = None
    if density is not None:
        ema = torch.where(density.ema >= _UNINIT, 0.0, density.ema)
        weights = lookup_values(ema, density.aabb_min, density.aabb_max, pts)
    z_sel, valid = _random_k_of_occupied(z_cand, occ_c, n_keep, far,
                                         explore=explore, weights=weights,
                                         generator=generator, draws=draws)
    z_sel = z_sel.contiguous()
    pts_sel = rays_o[:, None, :] + rays_d[:, None, :] * z_sel[..., None]
    raw = _apply_model(params["fine"], fcfg, pts_sel, viewdirs, rcfg)
    sigma = torch.where(valid, raw[..., 3], -1e10)
    raw = torch.cat([raw[..., :3], sigma[..., None]], dim=-1)
    noise = draws.get("noise")
    if noise is not None:
        noise = _pinned(noise, torch.float32, ray_batch.device)
    rgb, _, acc, _, _ = _composite(raw, z_sel, rays_d, rcfg, noise, generator)

    img_loss = img2mse(rgb, target)
    loss = img_loss
    aux = {"img_loss": img_loss, "psnr": mse2psnr(img_loss),
           "n_active_mean": torch.mean(valid.sum(-1).to(torch.float32)),
           "acc_mean": torch.mean(acc)}
    planes = params["fine"].get("planes")
    if tv_reg > 0.0 and planes is not None:
        tv = torch.mean((planes[:, 1:] - planes[:, :-1]) ** 2) \
            + torch.mean((planes[:, :, 1:] - planes[:, :, :-1]) ** 2)
        loss = loss + tv_reg * tv
        aux["tv"] = tv
    aux["loss"] = loss
    return loss, aux


def make_occ_train_step(rcfg: RenderConfig, fcfg, spec: PixelSamplerSpec,
                        n_candidates: int = 64, n_keep: int = 32,
                        explore: float = 0.02, tv_reg: float = 0.0,
                        world: Optional[World] = None):
    """``step(state, occ, images, poses, generator, density=None, draws=None)
    -> aux``: one occupancy-gated iteration on ``state`` in place (pixel
    draw, grid triage, fine render, backward, Adam). ``generator`` is the
    run's CPU generator, as in train/step.py: it draws the pixels and seeds
    the render's device generator. ``draws`` pins the pixel draw (the keys
    of train/pipeline.sample_pixels) and the render's (occ_nerf_loss's).
    ``density`` (a DensityGrid) turns on candidate budgeting. With
    ``world`` the step is data-parallel (module docstring)."""
    if n_keep > n_candidates:
        raise ValueError(
            f"n_keep ({n_keep}) must be <= n_candidates ({n_candidates}) "
            "— check --train_occ_keep vs --train_occ_candidates")

    spec = local_spec(spec, world)
    rank, n_ranks = (0, 1) if world is None else (world.rank, world.size)

    def step(state: TrainState, occ: OccupancyGrid, images, poses,
             generator: torch.Generator, density: Optional[DensityGrid] = None,
             draws: Optional[Dict] = None):
        img_idx, y, x = sample_pixels(generator, images.shape[0], state.step, spec, draws,
                                      rank, n_ranks)
        render_gen = torch.Generator(device=images.device)
        render_gen.manual_seed(int(torch.randint(0, 1 << 62, (), generator=generator)))
        rays_o, rays_d, target = pixel_rays(images, poses, spec, img_idx, y, x)
        ray_batch = pack_ray_batch(rays_o, rays_d, rcfg, spec.H, spec.W, spec.fx)
        params = {b: m.params() for b, m in state.branches()}
        loss, aux = occ_nerf_loss(params, occ, ray_batch, target, rcfg, fcfg,
                                  n_candidates, n_keep, explore=explore,
                                  density=density, tv_reg=tv_reg,
                                  generator=render_gen, draws=draws)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        # every parameter the loss does not reach (the coarse branch, the
        # per-image groups) gets a zero gradient, not None: Adam then decays
        # its moments and moves it as optax does on the JAX state
        for group in state.optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        if world is not None:
            all_reduce_grads(state, world)
        state.apply_gradients()
        aux = {k: v.detach() for k, v in aux.items()}
        return aux if world is None else reduce_aux(aux, world)

    return step
