"""Mesh-export CLI: a triangle mesh from a trained radiance field.

Counterpart of ``nerf_shared_tpu/apps/mesh_cli.py``:

    python -m nerf_shared_tpu_torch.apps.mesh_cli --config configs/lego.txt \\
        [--mesh_res 256] [--mesh_iso 50] [--mesh_out path.obj|.ply]

It reads the training config (the same ``--config`` works), loads the newest
checkpoint as the trainer's resume does (the EMA shadow under
``--ema_decay``, from the ``.ckpt.npz`` sibling of a ``.tar``; the triplane's
checkpointed plane resolution), probes raw sigma of the fine network (the
coarse one without a hierarchy) on ``--device`` (default ``cuda``: kernel
B1, P1 for the grid families) and isosurfaces on the host (ops/meshing.py;
the cell scan it ran is logged). NDC scenes mesh in NDC coordinates unless
``--mesh_world`` inverts the warp (winding flipped, gradient normals
transformed covariantly).

Under torchrun with ``--mesh_shape N`` the probe splits over the N ranks
(ops/meshing.probe_density_grid(mesh=)) and rank 0 alone runs the cell
scan, the normals and colours, and writes the mesh:

    torchrun --nproc_per_node 2 -m nerf_shared_tpu_torch.apps.mesh_cli \
        --config configs/lego.txt --mesh_shape 2
"""

from __future__ import annotations

import os

import numpy as np
import torch

from nerf_shared_tpu_torch.config import ConfigArgumentParser, config_parser


def extend_parser_for_mesh(parser: ConfigArgumentParser) -> ConfigArgumentParser:
    parser.add_argument("--mesh_res", type=int, default=256,
                        help="lattice resolution (cubes per axis)")
    parser.add_argument("--mesh_iso", type=float, default=50.0,
                        help="iso level on raw (pre-ReLU) sigma; the original"
                             " NeRF export convention is 50")
    parser.add_argument("--mesh_out", type=str, default="",
                        help="output path (.obj or .ply); default"
                             " <basedir>/<expname>/mesh_<step>.obj")
    parser.add_argument("--mesh_aabb", type=float, default=0.0,
                        help="half-extent of a cube probe volume; 0 = auto"
                             " (NDC box for NDC scenes, else the camera-"
                             "frustum hull of the training poses)")
    parser.add_argument("--mesh_block", type=int, default=65536,
                        help="points per device probe launch")
    parser.add_argument("--mesh_color", action="store_true",
                        help="bake per-vertex radiance (viewed along the "
                             "inward normal) into the exported mesh")
    parser.add_argument("--mesh_normals", type=str, default="none",
                        choices=["none", "face", "grad"],
                        help="export per-vertex normals: area-weighted "
                             "face normals or the smoother density "
                             "gradient -∇sigma/|∇sigma|")
    parser.add_argument("--mesh_world", action="store_true",
                        help="NDC scenes only: invert the projective NDC "
                             "warp so the mesh lands in the recentered "
                             "LLFF world frame (far content clips to the "
                             "z'=0.999 shell); no-op for non-NDC scenes")
    return parser


def mesh_aabb(args, renderer, ds, H, W):
    """Probe volume: an explicit cube, the NDC box, or the training poses'
    frustum hull (the occupancy grid's rules)."""
    if args.mesh_aabb > 0:
        h = float(args.mesh_aabb)
        return (np.array([-h, -h, -h], np.float32),
                np.array([h, h, h], np.float32))
    if renderer.cfg.ndc:
        return (np.array([-1.05, -1.05, -1.001], np.float32),
                np.array([1.05, 1.05, 1.001], np.float32))
    from nerf_shared_tpu_torch.render.occupancy import aabb_from_poses

    return aabb_from_poses(H, W, ds.K, ds.poses[ds.i_train],
                           renderer.cfg.near, renderer.cfg.far)


def run_mesh(args, native: str = "auto"):
    """Export the mesh of the newest checkpoint; returns (path, verts,
    faces), and (None, None, None) on a rank > 0 of a world, which only
    probes. ``native`` picks the cell scan (ops/meshing.scan_route)."""
    from nerf_shared_tpu_torch.apps.train import join_world, pin_fp32, resolve_device
    from nerf_shared_tpu_torch.parallel import distributed

    device = resolve_device(args.device)
    pin_fp32()
    world = join_world(args, device)
    try:
        return _run_mesh(args, torch.device(world.device) if world.launched else device,
                         world, native)
    finally:
        distributed.shutdown(world)


def _run_mesh(args, device, world, native):
    from nerf_shared_tpu_torch.apps.train import _resolve_triplane_aabb, _sync_triplane_res
    from nerf_shared_tpu_torch.data.datasets import load_datasets
    from nerf_shared_tpu_torch.factory import create_nerf_models, get_renderer, nerf_configs
    from nerf_shared_tpu_torch.ops.meshing import (
        density_gradient_normals,
        extract_mesh,
        ndc_normals_to_world,
        ndc_points_to_world,
        probe_density_grid,
        save_mesh,
        scan_route,
        vertex_colors,
        vertex_normals,
    )
    from nerf_shared_tpu_torch.utils import checkpoints as ckpt_utils

    ds = load_datasets(args)
    H, W = int(ds.hwf[0]), int(ds.hwf[1])
    _resolve_triplane_aabb(args, ds, H, W)
    ccfg, fcfg = _sync_triplane_res(args, *nerf_configs(args))
    coarse, fine = create_nerf_models(args, device, cfgs=(ccfg, fcfg))
    # mesh the weights eval renders: the EMA shadow under --ema_decay
    coarse_sd, fine_sd, start = ckpt_utils.load_checkpoint(
        args, ema=float(getattr(args, "ema_decay", 0.0)) > 0.0)
    if coarse_sd is not None:
        coarse.load_state_dict(coarse_sd, strict=True)
        if fine is not None and fine_sd:
            fine.load_state_dict(fine_sd, strict=True)
    if start == 0:
        print("warning: no checkpoint found; meshing a random field")
    renderer = get_renderer(args, ds.bds_dict, device)
    rcfg = renderer.cfg

    # sigma of the model the renderer composites with: fine if the
    # hierarchy is on, else coarse
    model = fine if fine is not None else coarse
    params = {k: v.detach() for k, v in model.params().items()}
    cfg = model.cfg

    lo, hi = mesh_aabb(args, renderer, ds, H, W)
    route = scan_route(native)
    sharded = world if world.launched else None
    print(f"probing sigma on a {args.mesh_res}^3 lattice over "
          f"[{np.asarray(lo).round(2)}, {np.asarray(hi).round(2)}]"
          + (f" on rank {world.rank} of {world.size}" if sharded is not None else "")
          + f"; cell scan: {route}")
    sigma = probe_density_grid(params, cfg, rcfg, lo, hi, resolution=args.mesh_res,
                               block=args.mesh_block, mesh=sharded)
    if not world.is_main:
        return None, None, None
    verts, faces = extract_mesh(params, cfg, rcfg, lo, hi, iso=args.mesh_iso,
                                sigma_grid=sigma, native=native)

    is_ndc = bool(rcfg.ndc)
    if args.mesh_world and not is_ndc:
        print("--mesh_world: scene is not NDC; mesh is already world-space")
    unwarp = args.mesh_world and is_ndc and len(verts) > 0

    # gradient normals are level-set gradients of the density, which lives
    # on NDC coordinates for NDC scenes: compute them in model space
    normals = None
    if len(verts) and args.mesh_normals == "grad":
        normals = density_gradient_normals(params, cfg, rcfg, verts,
                                           block=args.mesh_block)

    # NDC models condition on pre-warp view directions, so colour baking on
    # an NDC scene needs world normals for its viewdirs even without
    # --mesh_world
    world_verts = world_faces = world_normals = None
    if unwarp or (is_ndc and args.mesh_color and len(verts)):
        focal = float(np.asarray(ds.K)[0][0])
        world_verts = ndc_points_to_world(verts, H, W, focal)
        world_faces = faces[:, ::-1].copy()  # the NDC warp flips handedness
        if normals is not None:
            world_normals = ndc_normals_to_world(verts, normals, H, W, focal)
        else:
            world_normals = vertex_normals(world_verts, world_faces)

    colors = None
    if args.mesh_color and len(verts):
        colors = vertex_colors(params, cfg, rcfg, verts, faces, block=args.mesh_block,
                               normals=world_normals if is_ndc else normals)

    if unwarp:
        verts, faces = world_verts, world_faces
        if args.mesh_normals != "none":
            normals = world_normals
        print("unwarped NDC mesh to world coordinates (z' clipped at 0.999)")
    if len(verts) and args.mesh_normals == "face" and normals is None:
        normals = vertex_normals(verts, faces)

    out = args.mesh_out or os.path.join(args.basedir, args.expname, f"mesh_{start:06d}.obj")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    save_mesh(out, verts, faces, colors, normals)
    print(f"wrote {out}: {len(verts)} vertices, {len(faces)} faces "
          f"(iso={args.mesh_iso}"
          + (", colors" if colors is not None else "")
          + (f", {args.mesh_normals} normals" if normals is not None else "")
          + ")")
    return out, verts, faces


def main(argv=None, native: str = "auto"):
    args = extend_parser_for_mesh(config_parser()).parse_args(argv)
    return run_mesh(args, native=native)


if __name__ == "__main__":
    main()
