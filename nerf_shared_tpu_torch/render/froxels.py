"""Camera-froxel occupancy: per-frame empty-space skipping for pose renders.

Counterpart of ``nerf_shared_tpu/render/froxels.py``. Every ray of a pose render shares
one camera origin, so the world occupancy grid is resampled once per frame
into camera frustum voxels ("froxels"): a [ceil(H/tile), ceil(W/tile), C]
boolean over (pixel tile, depth bin), where the depth bins are exactly the
stratified-sampling strata of ``ops/sampling.sample_along_rays``. Bin
selection (the K nearest occupied bins, or the K of largest estimated
contribution when the grid carries density) runs once per tile, and each ray
evaluates the network only at one sample inside each selected bin (kernel
B3) and composites them (kernel B5); ``n_fine > 0`` adds the hierarchical
refinement of occupancy.refine_hierarchical.

A froxel is marked if any of its depth probes (both stratum edges and the
center, along the tile-center ray, plus the corner rays on request) hits an
occupied world cell; the froxel tensor is then dilated in the tile plane.
``skip_empty`` renders only tiles with a marked bin (the rest are exact
background) after one host fetch of the tile activity.

``make_sharded_render_froxel`` splits a frame's rays over the ranks of a
world: every rank computes the selection for the whole frame, renders its
slice of the rays and their bins (no tile skipping) and gathers the maps.

``check_froxel_preset`` refuses the measured-degenerate presets:
``build_froxels``, ``render_image_froxels`` and the sharded render call it.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from nerf_shared_tpu_torch.ops.rays import get_rays, ndc_rays
from nerf_shared_tpu_torch.parallel.distributed import World, shard_rows
from nerf_shared_tpu_torch.parallel.render import gather_maps, rank_generator
from nerf_shared_tpu_torch.render.occupancy import (
    OccupancyGrid,
    _masked_sigma,
    background_maps,
    estimate_contribution,
    lookup,
    lookup_sigma,
    rank_pack_topk,
    refine_hierarchical,
)
from nerf_shared_tpu_torch.render.renderer import (
    RenderConfig,
    _apply_model_rays,
    _composite,
    _model_parts,
)


class FroxelGrid(NamedTuple):
    """Per-frame frustum occupancy. ``bits[ty, tx, c]`` is True iff depth bin
    c of pixel tile (ty, tx) may hold occupied space; ``lower``/``upper`` are
    the [C] stratum edges, ``z0`` the strata's perturb-0 depths, ``weight``
    (when the grid carried sigma) the estimated contribution per bin."""

    bits: torch.Tensor    # [Ht, Wt, C] bool
    lower: torch.Tensor   # [C] float32
    upper: torch.Tensor   # [C] float32
    z0: torch.Tensor      # [C] float32
    weight: Optional[torch.Tensor] = None  # [Ht, Wt, C] float32


def check_froxel_preset(n_depth: int, n_keep: int):
    """Raise on the measured-degenerate froxel presets: at n_keep * 8 <
    n_depth the conservative bin marking exceeds the keep budget and
    nearest-K never reaches the surface bins (C=128/K=8 renders collapse to
    ~11 dB in the JAX package's measurements, BASELINE.md rounds 2-4)."""
    if n_keep * 8 < n_depth:
        raise ValueError(
            f"froxel preset n_depth={n_depth}, n_keep={n_keep} is degenerate: "
            "conservative bin marking exceeds the keep budget (measured ~11 dB "
            f"collapse at C=128/K=8, BASELINE.md). Use n_keep >= {n_depth // 8} "
            "for this n_depth, or a coarser n_depth.")


def _strata(near: float, far: float, n_depth: int, lindisp: bool, device):
    """(lower, upper, z0) [C]: the stratified-sampling bins of
    sample_along_rays around its linspace points."""
    t = np.linspace(0.0, 1.0, n_depth, dtype=np.float64)
    if lindisp:
        z = 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    else:
        z = near * (1.0 - t) + far * t
    mids = 0.5 * (z[1:] + z[:-1])
    lower = np.concatenate([z[:1], mids])
    upper = np.concatenate([mids, z[-1:]])
    return tuple(torch.as_tensor(a.astype(np.float32), device=device)
                 for a in (lower, upper, z))


def _tile_dirs(H: int, W: int, K, c2w, tile: int, offsets, ndc: bool = False):
    """Per-tile probe rays at pixel coordinates (ty*tile + oy, tx*tile + ox)
    for each (oy, ox) in ``offsets``, in ops/rays.get_rays' convention
    (NDC-warped with ``ndc``). Returns (origins, dirs), each [P, Ht, Wt, 3]."""
    K = torch.as_tensor(np.asarray(K, np.float32), device=c2w.device)
    Ht, Wt = -(-H // tile), -(-W // tile)
    ty = torch.arange(Ht, dtype=torch.float32, device=c2w.device) * tile
    tx = torch.arange(Wt, dtype=torch.float32, device=c2w.device) * tile
    os_, ds = [], []
    for oy, ox in offsets:
        i, j = torch.meshgrid(tx + ox, ty + oy, indexing="xy")
        dirs = torch.stack([(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1],
                            -torch.ones_like(i)], dim=-1)
        rd = torch.einsum("hwc,rc->hwr", dirs, c2w[:3, :3])
        ro = c2w[:3, -1].expand(rd.shape)
        if ndc:
            ro, rd = ndc_rays(H, W, K[0, 0], 1.0, ro, rd)
        os_.append(ro)
        ds.append(rd)
    return torch.stack(os_), torch.stack(ds)


def _max_pool_same(x, wy: int, wz: int):
    """Max over a (wy, wy, wz) window centred on each entry of [Ht, Wt, C]."""
    return F.max_pool3d(x[None, None], (wy, wy, wz), stride=1,
                        padding=(wy // 2, wy // 2, wz // 2))[0, 0]


@torch.no_grad()
def build_froxels(occ: OccupancyGrid, H: int, W: int, K, c2w, near: float,
                  far: float, n_depth: int = 64, tile: int = 8,
                  lindisp: bool = False, dilate: int = 1, dilate_z: int = 0,
                  corner_rays: bool = False, ndc: bool = False, *,
                  n_keep: int) -> FroxelGrid:
    """Resample the world occupancy grid into camera froxels for one pose,
    for a render that keeps ``n_keep`` bins per tile (checked by
    ``check_froxel_preset``). Probes per froxel: the tile-center ray (plus
    the four corner rays with ``corner_rays``) at each stratum's lower
    edge, center and upper edge, OR-reduced, then dilated ``dilate`` steps
    in the tile plane (and ``dilate_z`` in depth); the density score dilates
    with the bits."""
    check_froxel_preset(n_depth, n_keep)
    lower, upper, z0 = _strata(float(near), float(far), n_depth, lindisp,
                               c2w.device)
    c = (tile - 1) / 2.0
    offsets = [(c, c)]
    if corner_rays:
        offsets += [(0.0, 0.0), (0.0, tile - 1.0), (tile - 1.0, 0.0),
                    (tile - 1.0, tile - 1.0)]
    origins, dirs = _tile_dirs(H, W, K, c2w, tile, offsets, ndc=ndc)
    zs = torch.stack([lower, z0, upper])  # [3, C]
    pts = (origins[:, None, :, :, None, :]
           + dirs[:, None, :, :, None, :] * zs[None, :, None, None, :, None])
    bits = lookup(occ, pts).any(1).any(0)  # [Ht, Wt, C]
    score = (lookup_sigma(occ, pts).amax(dim=(0, 1))
             if occ.sigma is not None else None)

    if dilate > 0 or dilate_z > 0:
        f = bits.float()
        d, dz = dilate, dilate_z
        for _ in range(max(d, dz)):
            wy, wz = (3 if d > 0 else 1), (3 if dz > 0 else 1)
            f = _max_pool_same(f, wy, wz)
            if score is not None:
                score = _max_pool_same(score, wy, wz)
            d -= 1
            dz -= 1
        bits = f > 0.5

    weight = None
    if score is not None:
        # widths in ray parameter t: |d| is common within a tile and only
        # the ranking matters
        weight = estimate_contribution(score, (upper - lower)[None, None, :], bits)
    return FroxelGrid(bits, lower, upper, z0, weight)


def _select_bins(bits: torch.Tensor, n_keep: int):
    """Per tile, the K nearest occupied depth bins: bits [T, C] ->
    (idx [T, K] clipped to C-1, valid [T, K])."""
    C = bits.shape[-1]
    iota = torch.arange(C, dtype=torch.int64, device=bits.device)
    keys = torch.where(bits, iota, 2 * C)
    sel = torch.sort(keys, dim=-1).values[:, :n_keep]
    return sel.clamp(max=C - 1), sel < C


def _broadcast_tiles(x: torch.Tensor, H: int, W: int, tile: int):
    """[Ht, Wt, ...] -> [H, W, ...] by tile replication (cropped at the edge)."""
    return x.repeat_interleave(tile, 0).repeat_interleave(tile, 1)[:H, :W]


def _ray_inputs(rcfg: RenderConfig, H: int, W: int, K, c2w, ndc_hw=None):
    """Flat per-ray origins, directions and (viewdirs) of one pose, as
    Renderer._pack_rays builds them (viewdirs from the pre-warp directions).
    ``ndc_hw`` is the true image size for the NDC warp when (H, W) is the
    tile-padded pixel grid."""
    rays_o, rays_d = get_rays(H, W, K, c2w)
    viewdirs = None
    if rcfg.use_viewdirs:
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        viewdirs = viewdirs.reshape(-1, 3)
    if rcfg.ndc:
        nh, nw = ndc_hw if ndc_hw is not None else (H, W)
        rays_o, rays_d = ndc_rays(nh, nw, float(np.asarray(K)[0][0]), 1.0,
                                  rays_o, rays_d)
    return rays_o.reshape(-1, 3), rays_d.reshape(-1, 3), viewdirs


def _selection_maps(fro: FroxelGrid, rcfg: RenderConfig, H: int, W: int,
                    tile: int, n_keep: int):
    """Tile-level top-K bin selection broadcast to flat per-ray maps:
    (z_lo, z_hi, valid), each [HW, K]. Contribution-weighted when the
    FroxelGrid carries weights, nearest-K otherwise."""
    Ht, Wt, C = fro.bits.shape
    if fro.weight is not None:
        idx, valid = rank_pack_topk(fro.bits.reshape(-1, C),
                                    fro.weight.reshape(-1, C), n_keep)
    else:
        idx, valid = _select_bins(fro.bits.reshape(-1, C), n_keep)
    if rcfg.perturb > 0.0:
        z_lo, z_hi = fro.lower[idx], fro.upper[idx]
    else:
        # the stratum's canonical depth, so an all-occupied grid with K = C
        # is the dense coarse pass
        z_lo = z_hi = fro.z0[idx]
    k = idx.shape[-1]

    def per_ray(a):
        return _broadcast_tiles(a.reshape(Ht, Wt, k), H, W, tile).reshape(-1, k)

    return per_ray(z_lo), per_ray(z_hi), per_ray(valid)


def _render_ray_block(params_fine, rcfg: RenderConfig, fcfg, ro, rd, vd, lo,
                      hi, va, generator=None, n_fine: int = 0):
    """Evaluate and composite one block of rays at their selected bins."""
    if rcfg.perturb > 0.0:
        u = torch.rand(lo.shape, generator=generator, device=lo.device)
    else:
        u = 0.5
    z = lo + (hi - lo) * u
    z = torch.where(va, z, torch.tensor(rcfg.far, dtype=z.dtype,
                                        device=z.device)).contiguous()
    raw = _apply_model_rays(params_fine, fcfg, ro, rd, z, vd, rcfg)
    rgb, disp, acc, weights, _ = _composite(_masked_sigma(raw, va), z, rd, rcfg,
                                            generator=generator)
    out = {"n_active": va.sum(-1)}
    if n_fine > 0:
        rgb, disp, acc, out["z_vals"] = refine_hierarchical(
            params_fine, fcfg, rcfg, ro, rd, vd, z, va, weights, n_fine, generator)
    return {"rgb_map": rgb, "disp_map": disp, "acc_map": acc, **out}


def _map_ray_blocks(params_fine, rcfg, fcfg, parts, generator, block: int,
                    n_fine: int = 0):
    """_render_ray_block over blocks of ``block`` flat rays. ``parts`` =
    [ro, rd, lo, hi, va(, vd)], flat [n, ...]."""
    n = parts[0].shape[0]
    outs = []
    for i in range(0, n, block):
        ro, rd, lo, hi, va, *vd = [p[i:i + block].contiguous() for p in parts]
        outs.append(_render_ray_block(params_fine, rcfg, fcfg, ro, rd,
                                      vd[0] if vd else None, lo, hi, va,
                                      generator, n_fine))
    return {k: torch.cat([o[k] for o in outs], 0) for k in outs[0]}


def _tile_major(a, Ht: int, Wt: int, tile: int):
    """Flat [Hp*Wp, ...] (Hp = Ht*tile) -> tile-major [Ht*Wt, tile², ...]."""
    a = a.reshape((Ht, tile, Wt, tile) + a.shape[1:]).transpose(1, 2)
    return a.reshape((Ht * Wt, tile * tile) + a.shape[4:])


def _render_tiles_scatter(params_fine, parts, idx, rcfg, fcfg, H: int, W: int,
                          tile: int, block: int, generator=None,
                          n_fine: int = 0):
    """Render the tiles ``idx`` selects and scatter their pixels into full
    [H, W] maps whose other tiles hold the exact background."""
    t2 = tile * tile
    sel = [p[idx].reshape((-1,) + p.shape[2:]) for p in parts]
    out = _map_ray_blocks(params_fine, rcfg, fcfg, sel, generator, block, n_fine)
    Ht, Wt = -(-H // tile), -(-W // tile)
    full = background_maps((parts[0].shape[0], t2), rcfg, parts[0].device,
                           n_samples=out["z_vals"].shape[-1] if "z_vals" in out else 0)
    res = {}
    for k, v in out.items():
        trailing = tuple(v.shape[1:])
        fullk = full[k].index_put((idx,), v.reshape((idx.shape[0], t2) + trailing)
                                  .to(full[k].dtype))
        fullk = fullk.reshape((Ht, Wt, tile, tile) + trailing).transpose(1, 2)
        res[k] = fullk.reshape((Ht * tile, Wt * tile) + trailing)[:H, :W]
    return res


def render_image_froxels(
    fine_model,                 # NeRF module or (params, cfg)
    occ: OccupancyGrid,
    rcfg: RenderConfig,
    H: int,
    W: int,
    K,
    c2w,
    fcfg=None,
    generator: Optional[torch.Generator] = None,
    n_depth: int = 64,
    n_keep: int = 16,
    tile: int = 8,
    dilate: int = 1,
    dilate_z: int = 0,
    corner_rays: bool = False,
    chunk: int = 1024 * 64,
    froxels: Optional[FroxelGrid] = None,
    skip_empty: bool = True,
    n_fine: int = 0,
) -> Dict[str, torch.Tensor]:
    """Render one pose with froxel-gated sampling: build (or reuse) the
    frame's FroxelGrid, select K depth bins per pixel tile, and evaluate the
    network only at one sample inside each selected bin. Returns [H, W, ...]
    maps (rgb / disp / acc / n_active; with ``n_fine`` also the fine pass's
    ``z_vals``).

    ``skip_empty`` (default) renders only tiles with an occupied bin, in
    the tile-major layout, after one host fetch of the tile activity; the
    active-tile count is bucketed to multiples of 512 tiles. The output is
    the unskipped path's: skipped tiles are all-padding rays, which
    composite to the exact background."""
    check_froxel_preset(n_depth, n_keep)
    pf, fcfg_m = _model_parts(fine_model)
    fcfg = fcfg if fcfg is not None else fcfg_m
    dev = next(iter(pf.values())).device
    c2w = torch.as_tensor(c2w, dtype=torch.float32, device=dev)[:3, :4]
    if froxels is None:
        froxels = build_froxels(
            occ, H, W, K, c2w, float(rcfg.near), float(rcfg.far),
            n_depth=n_depth, tile=tile, lindisp=rcfg.lindisp, dilate=dilate,
            dilate_z=dilate_z, corner_rays=corner_rays, ndc=rcfg.ndc,
            n_keep=n_keep)
    if not skip_empty:
        rays_o, rays_d, viewdirs = _ray_inputs(rcfg, H, W, K, c2w)
        parts = [rays_o, rays_d, *_selection_maps(froxels, rcfg, H, W, tile, n_keep)]
        if viewdirs is not None:
            parts.append(viewdirs)
        out = _map_ray_blocks(pf, rcfg, fcfg, parts, generator,
                              min(chunk, H * W), n_fine)
        return {k: v.reshape((H, W) + tuple(v.shape[1:])) for k, v in out.items()}

    Ht, Wt, C = froxels.bits.shape
    Hp, Wp = Ht * tile, Wt * tile
    # the pixel grid covers the tile-padded image; the NDC warp uses the
    # true (H, W), as build_froxels did
    rays_o, rays_d, viewdirs = _ray_inputs(rcfg, Hp, Wp, K, c2w, ndc_hw=(H, W))
    parts = [rays_o, rays_d, *_selection_maps(froxels, rcfg, Hp, Wp, tile, n_keep)]
    if viewdirs is not None:
        parts.append(viewdirs)
    parts = [_tile_major(p, Ht, Wt, tile) for p in parts]
    active = froxels.bits.reshape(-1, C).any(-1).cpu().numpy()  # host fetch
    n_act = int(active.sum())
    if n_act == 0:
        return background_maps((H, W), rcfg, dev,
                               n_samples=n_keep + n_fine if n_fine > 0 else 0)
    order = np.argsort(~active, kind="stable")
    n_pad = min(active.shape[0], -(-n_act // 512) * 512)
    idx = torch.as_tensor(order[:n_pad], device=dev)
    return _render_tiles_scatter(pf, parts, idx, rcfg, fcfg, H, W, tile,
                                 min(chunk, n_pad * tile * tile), generator, n_fine)


def make_sharded_render_froxel(world: Optional[World], rcfg: RenderConfig, fcfg,
                               H: int, W: int, tile: int = 8, n_keep: int = 16,
                               block: int = 16384, n_fine: int = 0):
    """A froxel render of one pose over the ranks of ``world``: the
    FroxelGrid and the network replicate, the flat rays and their
    tile-selected bins split, the maps gather (the collective shape of
    parallel/render.make_sharded_render). The selection runs on every rank
    for the whole frame (a few lane sorts per tile); the network and the
    composite, all of the frame's cost, split. Rank r's slice renders as
    ``render_image_froxels(skip_empty=False)`` does, in blocks of
    ``block`` rays, with its draws from ``rank_seed(seed, r)``.

    Returns render_fn(params_fine, froxels, K, c2w, seed=0) -> dict of
    [H, W, ...] maps (rgb / disp / acc / n_active; with ``n_fine`` also
    ``z_vals``)."""
    n = H * W

    @torch.no_grad()
    def render_fn(params_fine, froxels: FroxelGrid, K, c2w, seed: int = 0):
        check_froxel_preset(froxels.bits.shape[-1], n_keep)
        dev = next(iter(params_fine.values())).device
        c2w = torch.as_tensor(c2w, dtype=torch.float32, device=dev)[:3, :4]
        rays_o, rays_d, viewdirs = _ray_inputs(rcfg, H, W, K, c2w)
        parts = [rays_o, rays_d, *_selection_maps(froxels, rcfg, H, W, tile, n_keep)]
        if viewdirs is not None:
            parts.append(viewdirs)
        local = [shard_rows(p, world) for p in parts]
        out = _map_ray_blocks(params_fine, rcfg, fcfg, local,
                              rank_generator(world, seed, dev),
                              min(block, max(local[0].shape[0], 1)), n_fine)
        out = gather_maps(out, n, world)
        return {k: v.reshape((H, W) + tuple(v.shape[1:])) for k, v in out.items()}

    return render_fn
