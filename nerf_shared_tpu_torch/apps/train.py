"""Entry point of the port: training, checkpoint -> render engine, and
``render_only``.

Counterpart of ``run``, ``train`` (the hierarchical trainer),
``EvalEngine``, ``build_eval_engine`` and ``render_only`` in
``nerf_shared_tpu/apps/train.py`` (reference main.py:17-147).

The entry points run on ``--device`` (default ``cuda``) and raise when it
is ``cuda`` and no CUDA device is present. fp32 matmuls and convolutions
are pinned to full fp32 (no TF32): the encoder's sinusoid arguments reach
2^9·|x|. On ``cuda`` a training step runs its networks through kernels B1
(forward) and B2 (backward) and the eval hooks render through B3 and B5;
on the CPU the kernels' plain versions run. The grid families
(``--model_type hashgrid`` / ``triplane``) train and render through the
table kernels P1 (gather) and P2 (its scatter-add backward) and composite
through B5; B1-B4 are the MLP family's. Their box is resolved from the
train cameras in every entry point (``_resolve_triplane_aabb``), a resume
adopts the checkpoint's plane resolution, and ``--triplane_upsample``
grows the planes at its milestones.

Render engines (``EvalEngine.engine_name``): ``dense`` (guided with
``--render_guided``), ``gated`` (``--render_gate``), ``occ-froxel`` and
``occ-grid`` (``--occ_grid`` with ``--occ_mode``; the grid is built from
the checkpoint's fine network through kernel B1, and during training
rebuilt for each render hook).

    python -m nerf_shared_tpu_torch.apps.train --config configs/lego.txt
    python -m nerf_shared_tpu_torch.apps.train --config configs/lego.txt \
        --render_only --render_test
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings

import numpy as np
import torch

from nerf_shared_tpu_torch.config import (
    config_parser,
    recipe_warnings,
    resolve_fused_backward,
    resolved_occ_alpha_thresh,
)
from nerf_shared_tpu_torch.data.datasets import load_datasets
from nerf_shared_tpu_torch.factory import (
    GRID_FAMILIES,
    create_nerf_models,
    get_renderer,
    get_train_state,
    grid_lrate,
    nerf_configs,
)
from nerf_shared_tpu_torch.models.triplane import upsample_triplane
from nerf_shared_tpu_torch.train.pipeline import PixelSamplerSpec
from nerf_shared_tpu_torch.train.state import fresh_state_at, make_model
from nerf_shared_tpu_torch.train.step import make_train_step
from nerf_shared_tpu_torch.utils import checkpoints as ckpt_utils
from nerf_shared_tpu_torch.utils.logging import copy_log_dir, make_tb_writer, print_statistics
from nerf_shared_tpu_torch.utils.metrics import ssim, to8b

# flags whose paths the port does not carry yet: each raises instead of
# being ignored (name -> (is-set test, what it would need))
_NOT_PORTED = {
    "ema_decay": (lambda v: float(v) > 0.0, "EMA eval state (ROADMAP A11)"),
    "barf_anneal": (lambda v: int(v) > 0, "BARF eval annealing (ROADMAP A11)"),
    "proposal": (bool, "the proposal sampler (ROADMAP A11)"),
    "precision": (lambda v: v != "fp32", "bf16 operands in the CUDA kernels"),
    "mesh_shape": (lambda v: bool(v), "multi-GPU renders and training (ROADMAP A16)"),
    "train_occ": (bool, "the occupancy-gated trainer (ROADMAP A14)"),
    "refine_poses": (bool, "pose refinement (ROADMAP A11)"),
    "appearance": (bool, "per-image appearance corrections (ROADMAP A11)"),
    "loss_sampling": (bool, "loss-guided pixel sampling (ROADMAP A11)"),
    "distortion_loss_weight": (lambda v: float(v) > 0.0,
                               "the distortion loss (ROADMAP A11)"),
}


def resolve_device(name: str) -> torch.device:
    """The run's torch device; ``cuda`` without a CUDA device raises (the
    port never carries on on the CPU unless asked to)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA device is available (pass --device cpu "
            "to run the plain PyTorch versions on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {name}: only cuda and cpu are supported")
    return dev


def pin_fp32():
    """No TF32 anywhere on the fp32 path."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def check_ported(args):
    for flag, (is_set, what) in _NOT_PORTED.items():
        value = getattr(args, flag, None)
        if value is not None and is_set(value):
            raise NotImplementedError(
                f"--{flag} {value}: {what} is not ported to "
                "nerf_shared_tpu_torch yet")


def _grid_select(args) -> str:
    """The candidate selection forwarded to occupancy renders: only grid
    mode takes --occ_select (froxel mode raises on anything but 'sort' and
    weights by density itself)."""
    if getattr(args, "occ_mode", "froxel") == "grid":
        return getattr(args, "occ_select", "sort")
    return "sort"


def _occ_aabb(renderer, ds, H, W, K):
    """The occupancy grid's box: the camera-frustum hull of the dataset's
    poses, or for NDC scenes the NDC cube with margins (z' spans [-1, 1])."""
    if renderer.cfg.ndc:
        return (np.array([-1.05, -1.05, -1.001], np.float32),
                np.array([1.05, 1.05, 1.001], np.float32))
    from nerf_shared_tpu_torch.render.occupancy import aabb_from_poses

    return aabb_from_poses(H, W, K, ds.poses, renderer.cfg.near, renderer.cfg.far)


def _build_occ_grid(args, renderer, ds, H, W, K, coarse, fine):
    """The occupancy grid of the checkpoint's density field
    (render/occupancy.py), or None when --occ_grid is off."""
    if getattr(args, "occ_grid", 0) <= 0:
        return None
    from nerf_shared_tpu_torch.render.occupancy import build_occupancy_grid

    lo, hi = _occ_aabb(renderer, ds, H, W, K)
    model = fine if fine is not None else coarse
    params = model.params()
    gen = torch.Generator(device=next(iter(params.values())).device).manual_seed(0)
    grid = build_occupancy_grid(
        params, model.cfg, renderer.cfg, lo, hi, resolution=args.occ_grid,
        alpha_threshold=resolved_occ_alpha_thresh(args), generator=gen)
    print(f"Occupancy grid {args.occ_grid}^3: {grid.occupied_fraction():.1%} occupied")
    return grid


def _occ_render_args(args) -> dict:
    """render_from_batch_poses' occupancy arguments from the flags."""
    return dict(occ_candidates=args.occ_candidates, occ_keep=args.occ_keep,
                occ_mode=args.occ_mode, occ_tile=args.occ_tile,
                occ_select=_grid_select(args), occ_fine=args.occ_fine)


def _resolve_triplane_aabb(args, ds, H, W):
    """Fill args.triplane_aabb (when 0 = auto) the same way in every entry
    point: grid-family parameters are decoded against this box, so
    training, resume and render_only must derive the same value. NDC
    scenes use the NDC box (factory.nerf_configs); otherwise the box bounds
    the train cameras' frustums."""
    if (getattr(args, "model_type", "nerf") not in GRID_FAMILIES
            or getattr(args, "triplane_aabb", 0.0)):
        return
    if args.dataset_type == "llff" and not args.no_ndc:
        print("grid aabb half-extent: NDC cube")
        return
    from nerf_shared_tpu_torch.render.occupancy import aabb_from_poses

    lo, hi = aabb_from_poses(H, W, ds.K, ds.poses[ds.i_train],
                             float(ds.bds_dict["near"]), float(ds.bds_dict["far"]))
    args.triplane_aabb = float(max(np.abs(lo).max(), np.abs(hi).max()))
    print(f"grid aabb half-extent: {args.triplane_aabb:.2f}")


def _sync_triplane_res(args, ccfg, fcfg):
    """Adopt the plane resolution of the checkpoint a run will load (a
    resume after an upsample carries larger planes than --triplane_res, and
    G sets the sampling coordinates). No-op for the other families and for
    matching resolutions. Returns (ccfg, fcfg)."""
    ckpts = ckpt_utils.find_checkpoints(args.basedir, args.expname, args.ft_path)
    if (getattr(ccfg, "G", None) is None or not ckpts or args.no_reload
            or not ckpts[-1].endswith(".npz")):
        return ccfg, fcfg
    with np.load(ckpts[-1]) as z:
        if "params/coarse/planes" not in z.files:
            return ccfg, fcfg
        g = int(z["params/coarse/planes"].shape[1])
    if g == ccfg.G:
        return ccfg, fcfg
    print(f"triplane resolution from checkpoint: {g}^2 planes")
    return (dataclasses.replace(ccfg, G=g),
            dataclasses.replace(fcfg, G=g) if fcfg is not None else None)


def _upsample_milestones(args, start):
    """--triplane_upsample 'step:G,...' -> the sorted milestones not yet
    applied (a milestone fires at steps i > its step, so one at exactly
    ``start`` is kept; the loop skips any that would not grow the planes)."""
    spec = getattr(args, "triplane_upsample", "")
    if not spec or getattr(args, "model_type", "nerf") != "triplane":
        return []
    ms = sorted((int(p.split(":")[0]), int(p.split(":")[1])) for p in spec.split(","))
    return [(s, g) for s, g in ms if s >= start]


def _upsample_state(state, new_G, args):
    """The TrainState with both branches' planes grown to new_G and a fresh
    Adam whose schedule continues at state.step; returns (state, ccfg,
    fcfg)."""
    mods = []
    for _, m in state.branches():
        params, cfg = upsample_triplane(m.params(), m.cfg, new_G)
        new = make_model(cfg, params["planes"].device)
        new.load_state_dict(params, strict=True)
        mods.append(new)
    fine = mods[1] if len(mods) > 1 else None
    new_state = fresh_state_at(mods[0], fine, state.step, lrate=args.lrate,
                               lrate_decay=args.lrate_decay, grid_lrate=grid_lrate(args))
    return new_state, mods[0].cfg, fine.cfg if fine is not None else None


def run(args):
    """render_only, or train (returning its TrainState)."""
    if args.render_only:
        render_only(args)
        return None
    if not args.training:
        print("--training not set; nothing to do (see --render_only)")
        return None
    return train(args)


def collapse_warning(last: int, psnr: float, args, already_warned: bool):
    """The white-background transparency trap: past precrop, training PSNR
    stuck below 10 dB (density frozen in relu's dead zone; nothing
    unfreezes it). Returns a warning string once, or None."""
    if already_warned or not bool(getattr(args, "white_bkgd", False)):
        return None
    precrop_end = int(getattr(args, "precrop_iters", 0))
    if last < precrop_end + 1500 or last > 30_000 or psnr >= 10.0:
        return None
    return (f"training PSNR is stuck at {psnr:.1f} dB well past precrop — "
            "this looks like the white-background transparency trap "
            "(density frozen in the relu dead zone; the run will likely "
            "never recover). Restart with --warmup_noise 2000, a longer "
            "--precrop_iters, or a different --jax_seed.")


def train(args):
    """The hierarchical trainer (reference main.py:55-143): seeded state
    or the newest checkpoint, then one step per iteration with the print,
    checkpoint, test-set, validation-image and render-path hooks, and a
    final checkpoint. Returns the TrainState."""
    check_ported(args)
    device = resolve_device(args.device)
    pin_fp32()
    ds = load_datasets(args)
    H, W, _ = ds.hwf
    for msg in recipe_warnings(args, n_train_views=len(ds.i_train), render_h=H):
        warnings.warn(msg, UserWarning, stacklevel=2)
        print(f"[RECIPE WARNING] {msg}")
    copy_log_dir(args)
    tb_writer = make_tb_writer(args)
    _resolve_triplane_aabb(args, ds, H, W)
    ccfg, fcfg = _sync_triplane_res(args, *nerf_configs(args))
    state = get_train_state(args, device, cfgs=(ccfg, fcfg))
    start = ckpt_utils.restore_train_state(state, args)
    renderer = get_renderer(args, ds.bds_dict, device)
    spec = PixelSamplerSpec.from_K(
        H, W, ds.K, args.N_rand, single_image=args.no_batching,
        precrop_iters=args.precrop_iters, precrop_frac=args.precrop_frac,
        exact_epochs=bool(args.exact_epochs))
    images_tr = torch.as_tensor(ds.images[ds.i_train], device=device)
    poses_tr = torch.as_tensor(ds.poses[ds.i_train][:, :3, :4], device=device)

    fused_bwd = resolve_fused_backward(args, device)
    if fused_bwd:
        print("train path: kernels B1 (forward) + B2 (backward) "
              "(auto; --fused_backward false for autograd of the plain network)")
    # the eval hooks render through renderer.cfg (B3 and B5 on the card);
    # the training step's networks go through fused_train_op or apply_nerf,
    # never B3 or B4, and it composites through raw2outputs, not B5. Guided
    # sampling is a render-time preset: training keeps the full hierarchy
    rcfg = dataclasses.replace(renderer.cfg, use_pallas=False,
                               fused_composite=False, fused_backward=fused_bwd,
                               guided=0)

    def make_steps(ccfg, fcfg):
        """(step, warm-up step or None). --warmup_noise: sigma noise >= 1
        for the first N steps, the escape from the white-background
        transparency trap."""
        kw = dict(acc_reg=args.acc_loss_weight, tv_reg=args.tv_loss_weight)
        warm = None
        if args.warmup_noise > 0:
            warm = make_train_step(
                dataclasses.replace(rcfg, raw_noise_std=max(1.0, rcfg.raw_noise_std)),
                ccfg, fcfg, spec, **kw)
        return make_train_step(rcfg, ccfg, fcfg, spec, **kw), warm

    def make_occ_maint(fcfg):
        """With --occ_grid the render hooks go through a grid rebuilt from
        the current fine network at hook time."""
        if getattr(args, "occ_grid", 0) <= 0 or fcfg is None:
            return None
        from nerf_shared_tpu_torch.render.occupancy import OccupancyMaintainer

        lo, hi = _occ_aabb(renderer, ds, H, W, ds.K)
        return OccupancyMaintainer(
            renderer.cfg, fcfg, lo, hi, resolution=args.occ_grid,
            alpha_threshold=resolved_occ_alpha_thresh(args))

    step_fn, warm_fn = make_steps(ccfg, fcfg)
    occ_maint = make_occ_maint(fcfg)
    upsample_ms = _upsample_milestones(args, start)

    def hook_kw(step):
        if occ_maint is None:
            return {}
        return dict(occ_grid=occ_maint.get(state.fine.params(), step),
                    **_occ_render_args(args))

    generator = torch.Generator()
    N_iters = args.N_iters + 1
    print(f"Begin: {len(ds.i_train)} train views, {len(ds.i_test)} test views, "
          f"device {device}")
    t0 = t_train_start = time.perf_counter()
    rays_done, warned = 0, False
    for i in range(start + 1, N_iters):
        while upsample_ms and i > upsample_ms[0][0]:
            _, new_G = upsample_ms.pop(0)
            if new_G <= ccfg.G:
                print(f"[UPSAMPLE] skip {new_G}^2: planes already {ccfg.G}^2")
                continue
            state, ccfg, fcfg = _upsample_state(state, new_G, args)
            step_fn, warm_fn = make_steps(ccfg, fcfg)
            occ_maint = make_occ_maint(fcfg)
            print(f"[UPSAMPLE] step {i - 1}: planes -> {new_G}^2 "
                  "(optimizer restarted at the continued schedule)")
        # each step's draws depend on (seed, step) only, so a resumed run
        # draws what an uninterrupted one would
        generator.manual_seed((int(args.jax_seed) << 32) + i)
        fn = warm_fn if warm_fn is not None and i <= args.warmup_noise else step_fn
        aux = fn(state, images_tr, poses_tr, generator)
        rays_done += args.N_rand
        hooked = False

        if args.i_print > 0 and i % args.i_print == 0:
            # the fetch waits for the queued steps: read the clock after it
            loss_v, psnr_v = float(aux["loss"]), float(aux["psnr"])
            dt = time.perf_counter() - t0
            print_statistics(loss_v, psnr_v, i, tb_writer, extra={
                "rays/sec": f"{rays_done / dt if dt > 0 else 0.0:,.0f}",
                "elapsed": f"{time.perf_counter() - t_train_start:.0f}s"})
            msg = collapse_warning(i, psnr_v, args, warned)
            if msg:
                warned = True
                warnings.warn(msg, UserWarning, stacklevel=1)
                print(f"[RECIPE WARNING] {msg}")
            t0, rays_done = time.perf_counter(), 0

        if args.i_weights > 0 and i % args.i_weights == 0:
            paths = ckpt_utils.save_checkpoints(args.basedir, args.expname, state, i,
                                                fmt=args.ckpt_format)
            print(f"Saved checkpoints at {paths}")

        if args.i_testset > 0 and i % args.i_testset == 0:
            testsavedir = os.path.join(args.basedir, args.expname, f"testset_{i:06d}")
            renderer.render_from_batch_poses(
                H, W, ds.K, args.chunk, ds.poses[ds.i_test], state.coarse,
                state.fine, retraw=False, save_directory=testsavedir,
                **hook_kw(i))
            print(f"Saved test set renders to {testsavedir}")
            hooked = True

        if args.i_img > 0 and i % args.i_img == 0 and len(ds.i_val):
            val_i = int(ds.i_val[(i // args.i_img) % len(ds.i_val)])
            rgb = renderer.render_from_batch_poses(
                H, W, ds.K, args.chunk, ds.poses[val_i][None, :3, :4], state.coarse,
                state.fine, retraw=False, **hook_kw(i))[0]
            val_mse = float(np.mean((rgb - ds.images[val_i]) ** 2))
            val_psnr = -10.0 * np.log10(val_mse) if val_mse > 0 else np.inf
            val_ssim = float(ssim(rgb, ds.images[val_i]))
            print(f"[VAL] Iter: {i} view {val_i} PSNR: {val_psnr:.3f} "
                  f"SSIM: {val_ssim:.4f} "
                  f"elapsed: {time.perf_counter() - t_train_start:.0f}s", flush=True)
            if tb_writer is not None:
                tb_writer.add_scalar("Val/PSNR", val_psnr, i)
                tb_writer.add_scalar("Val/SSIM", val_ssim, i)
                tb_writer.add_image("Val/rgb", to8b(rgb), i, dataformats="HWC")
            hooked = True

        if args.i_video > 0 and i % args.i_video == 0:
            videodir = os.path.join(args.basedir, args.expname, f"video_{i:06d}")
            rposes = ds.render_poses
            rposes = rposes[:, :3, :4] if rposes.ndim == 3 else rposes
            renderer.render_from_batch_poses(H, W, ds.K, args.chunk, rposes,
                                             state.coarse, state.fine, retraw=False,
                                             save_directory=videodir, **hook_kw(i))
            print(f"Saved render-path frames to {videodir} (PNG; mp4/gif export "
                  "is not ported)")
            hooked = True
        if hooked:
            # rays/sec counts training only: restart its window after the
            # renders (they end in a device -> host copy)
            t0, rays_done = time.perf_counter(), 0

    ckpt_utils.save_checkpoints(args.basedir, args.expname, state, N_iters - 1,
                                fmt=args.ckpt_format)
    return state


class EvalEngine:
    """Everything needed to render novel views from a checkpoint: dataset
    geometry, the restored models, the renderer and the optional occupancy
    grid. Built once and reused across poses by render_only and by
    apps/serve.py."""

    def __init__(self, ds, H, W, K, renderer, ccfg, fcfg, coarse, fine,
                 occ_grid, start, args, device):
        self.ds = ds
        self.H, self.W, self.K = H, W, K
        self.renderer = renderer
        self.ccfg, self.fcfg = ccfg, fcfg
        self.coarse, self.fine = coarse, fine
        self.occ_grid = occ_grid
        self.start = start
        self.args = args
        self.device = device

    def render_poses(self, poses, save_directory=None, generator=None):
        """Render a [N, 3+, 4] pose batch through the engine's path
        (occupancy / gated / dense); returns float rgbs [N, H, W, 3]."""
        a = self.args
        return self.renderer.render_from_batch_poses(
            self.H, self.W, self.K, a.chunk, poses, self.coarse, self.fine,
            retraw=False, save_directory=save_directory, generator=generator,
            save_depth=getattr(a, "render_depth", False),
            gate_threshold=a.render_gate, occ_grid=self.occ_grid,
            **_occ_render_args(a))

    @property
    def engine_name(self):
        if self.occ_grid is not None:
            return "occ-" + self.args.occ_mode
        if self.args.render_gate > 0.0:
            return "gated"
        return "dense"


def build_eval_engine(args, ds=None) -> EvalEngine:
    """Load the newest checkpoint (or seeded init weights when there is
    none) and assemble the render engine on ``--device``: the renderer,
    and with --occ_grid the occupancy grid of the fine network."""
    check_ported(args)
    device = resolve_device(args.device)
    pin_fp32()
    if ds is None:
        ds = load_datasets(args)
    H, W, _ = ds.hwf
    K = ds.K
    if args.render_factor > 0:
        H, W = H // args.render_factor, W // args.render_factor
        K = ds.K.copy()
        K[:2] = K[:2] / args.render_factor

    _resolve_triplane_aabb(args, ds, int(ds.hwf[0]), int(ds.hwf[1]))
    ccfg, fcfg = _sync_triplane_res(args, *nerf_configs(args))
    coarse, fine = create_nerf_models(args, device, cfgs=(ccfg, fcfg))
    coarse_sd, fine_sd, start = ckpt_utils.load_checkpoint(args)
    if coarse_sd is not None:
        coarse.load_state_dict(coarse_sd, strict=True)
        if fine is not None and fine_sd:
            fine.load_state_dict(fine_sd, strict=True)
    coarse.eval()
    if fine is not None:
        fine.eval()
    renderer = get_renderer(args, ds.bds_dict, device)
    occ_grid = _build_occ_grid(args, renderer, ds, H, W, K, coarse, fine)
    return EvalEngine(ds, H, W, K, renderer, ccfg, fcfg, coarse, fine, occ_grid,
                      start, args, device)


def render_only(args, return_rgbs: bool = False, ds=None):
    """Reload the newest weights and render render_poses (or the test set
    with --render_test) to PNGs. Returns the output directory, and with
    ``return_rgbs`` also the float renders."""
    eng = build_eval_engine(args, ds=ds)
    suffix = "test" if args.render_test else "path"
    outdir = os.path.join(args.basedir, args.expname,
                          f"renderonly_{suffix}_{eng.start:06d}")
    poses = eng.ds.render_poses
    poses = poses[:, :3, :4] if poses.ndim == 3 else poses
    rgbs = eng.render_poses(poses, save_directory=outdir)
    print(f"Done rendering {rgbs.shape[0]} views to {outdir}")
    if return_rgbs:
        return outdir, rgbs
    return outdir


def main(argv=None):
    return run(config_parser().parse_args(argv))


if __name__ == "__main__":
    main()
