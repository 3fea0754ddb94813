"""Renders sharded over the ranks of a world: the H·W rays of a frame split
over "data".

Counterpart of ``nerf_shared_tpu/parallel/render.py``. Rays are
independent, so a frame splits over the ranks: the flat rays are padded to
a multiple of the world size by repeating the last ray, rank r renders its
contiguous slice in blocks of ``block`` rays, and every rank's maps are
all-gathered and trimmed (``distributed.shard_rows`` / ``gather_rows``).
Rank r's draws come from a generator seeded ``rank_seed(seed, r)``, the
counterpart of ``fold_in(key, axis_index("data"))``.

A rank's slice goes through the port's own renderer, so on the card it
runs the unsharded path's kernels: B3 + B5 for the dense frame (B4 under
``fused_composite``), B3 + B5 for the occupancy block, P1 for a grid
family. The JAX package's sharded renders turn its Pallas kernels off
(``use_pallas=False``); the port keeps ``rcfg``'s kernels (ROADMAP C,
deliberate differences). On the CPU both routes are plain.

With one rank (a plain run, or a world of one) nothing is padded or
gathered, so with ``block`` equal to the unsharded render's ``chunk`` each
function is the unsharded path bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from nerf_shared_tpu_torch.parallel.distributed import (
    World,
    gather_rows,
    rank_seed,
    shard_rows,
)
from nerf_shared_tpu_torch.render.renderer import RenderConfig, Renderer


def rank_generator(world: Optional[World], seed: int, device) -> torch.Generator:
    """This rank's generator of a sharded render's draws, on ``device``."""
    rank = world.rank if world is not None else 0
    return torch.Generator(device=device).manual_seed(rank_seed(seed, rank))


def gather_maps(out: Dict[str, torch.Tensor], n: int, world: Optional[World]):
    """Each map of a rank's slice gathered to the whole [n, ...] map."""
    return {k: gather_rows(v, n, world) for k, v in out.items()}


def make_sharded_render(world: Optional[World], rcfg: RenderConfig, ccfg, fcfg,
                        block: int = 16384):
    """Build render_fn(params_coarse, params_fine, rays_flat [N, 8|11],
    seed=0) -> dict of [N, ...] maps (``render_rays``' keys) on every rank.
    ``params_fine`` None reuses the coarse network, as ``render_rays``
    does."""
    renderer = Renderer(**dataclasses.asdict(rcfg))

    @torch.no_grad()
    def render_fn(params_coarse, params_fine, rays_flat: torch.Tensor,
                  seed: int = 0) -> Dict[str, torch.Tensor]:
        n = rays_flat.shape[0]
        local = shard_rows(rays_flat, world)
        out = renderer.render_flat_rays(
            local, (params_coarse, ccfg),
            None if params_fine is None else (params_fine, fcfg),
            chunk=min(block, max(local.shape[0], 1)),
            generator=rank_generator(world, seed, local.device))
        return gather_maps(out, n, world)

    return render_fn


def make_sharded_pose_render(world: Optional[World], rcfg: RenderConfig, ccfg, fcfg,
                             H: int, W: int, block: int = 16384):
    """A full-image dense render of one pose over the world: the H·W rays
    packed as ``Renderer._pack_rays`` packs them (viewdirs before the NDC
    warp), split over the ranks and gathered. Eval semantics are forced
    (``perturb`` 0, no sigma noise), so the pixels are the unsharded eval
    render's. This is the sharded path of ``render_only``, the service and
    the dense training hooks.

    Returns render_pose(params_coarse, params_fine, K, c2w, seed=0) -> dict
    of [H, W, ...] maps (rgb_map / disp_map / acc_map / ...)."""
    eval_cfg = dataclasses.replace(rcfg, perturb=0.0, raw_noise_std=0.0,
                                   fused_backward=False)
    packer = Renderer(**dataclasses.asdict(eval_cfg))
    render_fn = make_sharded_render(world, eval_cfg, ccfg, fcfg, block=block)

    def render_pose(params_coarse, params_fine, K, c2w, seed: int = 0):
        device = next(iter(params_coarse.values())).device
        c2w = torch.as_tensor(c2w, dtype=torch.float32, device=device)[:3, :4]
        rays_flat, _ = packer._pack_rays(H, W, K, None, c2w, device)
        out = render_fn(params_coarse, params_fine, rays_flat, seed)
        return {k: v.reshape((H, W) + tuple(v.shape[1:])) for k, v in out.items()}

    return render_pose


def make_sharded_render_occ(world: Optional[World], rcfg: RenderConfig, fcfg,
                            block: int = 16384, n_candidates: int = 128,
                            n_keep: int = 64, select: str = "sort", n_fine: int = 0):
    """An occupancy-grid render over the world: the grid and the network
    replicate, the rays split, the maps gather. Each rank runs the
    unsharded path's block (``occupancy._render_occ_block``: the candidate
    triage, the top-K selection and the masked render); the host-synced ray
    gate of ``render_flat_rays_occ`` stays single-card, as in JAX.

    Returns render_fn(params_fine, occ_grid, rays_flat, seed=0) -> dict."""
    from nerf_shared_tpu_torch.render.occupancy import _occ_render_blocks

    @torch.no_grad()
    def render_fn(params_fine, occ_grid, rays_flat: torch.Tensor,
                  seed: int = 0) -> Dict[str, torch.Tensor]:
        n = rays_flat.shape[0]
        local = shard_rows(rays_flat, world)
        out = _occ_render_blocks(
            params_fine, occ_grid, local, rcfg, fcfg, n_candidates, n_keep,
            min(block, max(local.shape[0], 1)), select, n_fine,
            rank_generator(world, seed, local.device))
        return gather_maps(out, n, world)

    return render_fn
