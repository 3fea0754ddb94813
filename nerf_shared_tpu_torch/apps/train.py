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
grows the planes at its milestones. ``--refine_poses`` and
``--appearance`` train per-image pose twists and exposure corrections with
the field (train/step.py); ``--barf_anneal`` anneals the encoding, and
every eval render mid-anneal (the hooks, ``render_only``, the service)
sees the step's masked encoder (``_eval_models``). ``--proposal`` trains a
density-only proposal MLP as the coarse branch (plain network, never
B1-B4; with a grid ``--model_type`` the mixed hierarchy) through the
interlevel loss, ``--distortion_loss_weight`` adds the distortion loss,
``--loss_sampling`` draws part of each batch from a per-tile error map on
the device, and ``--ema_decay`` keeps an EMA shadow of the fields that
every eval render reads (the hooks from the state, ``render_only``, the
eval CLI and the service from the checkpoint's ``ema/`` sidecar).

``--train_occ`` trains the fine network alone through the occupancy-gated
step (train/occ_train.py: B1 + B2 at K samples a ray, or P1 / P2 for the
grid families) over a density grid refreshed from the live network (4 B1
launches at 64³). The JAX trainer scans gcd(i_print, i_weights,
i_testset, i_img) steps per dispatch (``dispatch_steps``); the port steps
one at a time but makes the per-dispatch decisions on the same steps: the
warm-up and the binary grid at each window's start, the refresh at its
end, and with ``--train_occ_until`` the switch to the hierarchical step
(coarse seeded from fine, ``sync_coarse_from_fine``) at the first window
starting past it. Render hooks go through the training grid until then.

``--model_type mipnerf`` trains mip-NeRF's one network (no fine branch)
through B1 and B2's IPE instantiations at its published recipe's coarse
loss weight and rate schedule (factory.py), and every entry point renders
it densely (render/renderer.py ``render_rays_mip``); config.check_mip_flags
and ``RenderConfig`` name the flags it does not take.

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
from typing import Optional

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
    coarse_loss_weight,
    create_nerf_models,
    get_renderer,
    get_train_state,
    grid_lrate,
    nerf_configs,
)
from nerf_shared_tpu_torch.models.triplane import TriplaneConfig, upsample_triplane
from nerf_shared_tpu_torch.parallel import distributed
from nerf_shared_tpu_torch.parallel.distributed import World
from nerf_shared_tpu_torch.parallel.mesh import make_mesh
from nerf_shared_tpu_torch.render.renderer import _model_parts
from nerf_shared_tpu_torch.train import occ_train
from nerf_shared_tpu_torch.train.loss_sampling import LossSamplingSpec, init_loss_map
from nerf_shared_tpu_torch.train.pipeline import PixelSamplerSpec
from nerf_shared_tpu_torch.train.state import fresh_state_at, make_model, sync_coarse_from_fine
from nerf_shared_tpu_torch.train.step import make_train_step
from nerf_shared_tpu_torch.utils import checkpoints as ckpt_utils
from nerf_shared_tpu_torch.utils.debug import enable_nan_checks
from nerf_shared_tpu_torch.utils.logging import copy_log_dir, make_tb_writer, print_statistics
from nerf_shared_tpu_torch.utils.metrics import ssim, to8b

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
    """No TF32 anywhere outside the kernels. Under --precision bf16 too:
    only the MLP's compute goes to bf16 (the kernels' bf16 instantiations,
    apply_nerf in bf16); products outside it stay fp32, where the JAX
    trainer leaves XLA's default matmul precision (ROADMAP C)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def check_trainer_flags(args):
    """The JAX trainer's guards on --loss_sampling (single-image sampling
    only) and on --proposal, --loss_sampling and --ema_decay with
    --train_occ."""
    train_occ = bool(getattr(args, "train_occ", False))
    if bool(getattr(args, "loss_sampling", False)):
        if not args.no_batching:
            raise SystemExit(
                "--loss_sampling targets single-image sampling: add "
                "--no_batching (the batching pipeline draws across all "
                "images per step)")
        if train_occ:
            raise SystemExit(
                "--loss_sampling targets the hierarchical/proposal "
                "trainer (the occ trainer has its own candidate sampler)")
    if float(getattr(args, "ema_decay", 0.0)) > 0.0 and train_occ:
        raise SystemExit(
            "--ema_decay targets the hierarchical/proposal trainer "
            "(the occ trainer does not maintain the EMA shadow)")
    if bool(getattr(args, "proposal", False)) and train_occ:
        raise SystemExit(
            "--proposal and --train_occ are alternative accelerants: "
            "the occ trainer is fine-only (no coarse branch to "
            "propose for) and the two-phase seed copy assumes "
            "same-shape coarse/fine nets")


def loss_sampling_spec(args) -> Optional[LossSamplingSpec]:
    """--loss_sampling's spec from its flags, or None when it is off."""
    if not bool(getattr(args, "loss_sampling", False)):
        return None
    return LossSamplingSpec(tile=int(args.loss_sampling_tile),
                            frac=float(args.loss_sampling_frac),
                            decay=float(args.loss_sampling_decay))


def check_barf(args):
    """The JAX trainer's guards on --barf_anneal: the MLP family with the
    positional encoding only."""
    if int(getattr(args, "barf_anneal", 0)) <= 0:
        return
    if getattr(args, "model_type", "nerf") != "nerf":
        raise SystemExit("--barf_anneal anneals the positional "
                         "encoding — MLP family only (grid families "
                         "have no frequency bands to anneal)")
    if int(getattr(args, "i_embed", 0)) == -1:
        raise SystemExit("--barf_anneal needs the positional encoding "
                         "(--i_embed 0); identity embedding has no "
                         "frequency bands")


def _barf_progress(args, step):
    """Annealing progress in [0, 1] at ``step``, or None when --barf_anneal
    is off."""
    end = int(getattr(args, "barf_anneal", 0))
    if end <= 0:
        return None
    start = int(getattr(args, "barf_anneal_start", 0))
    return min(1.0, max(0.0, (step - start) / max(1, end - start)))


@torch.no_grad()
def _eval_models(args, step, coarse, fine, ema=None):
    """What the eval renders at ``step`` see: the models as they are, or
    (params, cfg) pairs of the EMA shadow ``ema`` ({"coarse", "fine":
    state dict}, --ema_decay) and then, mid-anneal (--barf_anneal,
    progress < 1), the step's BARF mask, the encoder the training step saw
    (the untrained high-frequency weights, still at their init under the
    mask, would otherwise add noise). Never used for checkpoints."""
    pairs = [None if m is None else (m.params() if ema is None else ema[b], m.cfg)
             for b, m in (("coarse", coarse), ("fine", fine))]
    p = _barf_progress(args, step)
    if p is None or p >= 1.0:
        return (coarse, fine) if ema is None else tuple(pairs)
    from nerf_shared_tpu_torch.models.nerf import anneal_nerf_params

    return tuple(None if pr is None else (anneal_nerf_params(pr[0], pr[1], p), pr[1])
                 for pr in pairs)


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


def _plane_res(ccfg, fcfg) -> Optional[int]:
    """The triplane branches' plane resolution G (the fine's in the mixed
    hierarchy, where the coarse is a proposal MLP), or None."""
    return next((c.G for c in (ccfg, fcfg) if isinstance(c, TriplaneConfig)), None)


def _sync_triplane_res(args, ccfg, fcfg):
    """Adopt the plane resolution of the checkpoint a run will load (a
    resume after an upsample carries larger planes than --triplane_res, and
    G sets the sampling coordinates). No-op for the other families and for
    matching resolutions. Returns (ccfg, fcfg)."""
    ckpts = ckpt_utils.find_checkpoints(args.basedir, args.expname, args.ft_path)
    G = _plane_res(ccfg, fcfg)
    if G is None or not ckpts or args.no_reload or not ckpts[-1].endswith(".npz"):
        return ccfg, fcfg
    branch = "coarse" if isinstance(ccfg, TriplaneConfig) else "fine"
    with np.load(ckpts[-1]) as z:
        if f"params/{branch}/planes" not in z.files:
            return ccfg, fcfg
        g = int(z[f"params/{branch}/planes"].shape[1])
    if g == G:
        return ccfg, fcfg
    print(f"triplane resolution from checkpoint: {g}^2 planes")
    return tuple(dataclasses.replace(c, G=g) if isinstance(c, TriplaneConfig) else c
                 for c in (ccfg, fcfg))


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
    """The TrainState with the triplane branches' planes grown to new_G (a
    proposal coarse stays as it is) and a fresh Adam whose schedule
    continues at state.step; the loss map carries over and an EMA shadow
    restarts at the new parameters. Returns (state, ccfg, fcfg)."""
    mods = []
    for _, m in state.branches():
        if not isinstance(m.cfg, TriplaneConfig):
            mods.append(m)
            continue
        params, cfg = upsample_triplane(m.params(), m.cfg, new_G)
        new = make_model(cfg, params["planes"].device)
        new.load_state_dict(params, strict=True)
        mods.append(new)
    fine = mods[1] if len(mods) > 1 else None
    new_state = fresh_state_at(mods[0], fine, state.step, lrate=args.lrate,
                               lrate_decay=args.lrate_decay, grid_lrate=grid_lrate(args),
                               aux=state.aux, pose_lrate=args.pose_lrate,
                               appearance_lrate=args.appearance_lrate,
                               ema=state.ema is not None, loss_map=state.loss_map)
    return new_state, mods[0].cfg, fine.cfg if fine is not None else None


def dispatch_steps(args) -> int:
    """The JAX trainer's steps per dispatch: the gcd of the positive
    i_print / i_weights / i_testset / i_img cadences (100 when none is set),
    at most N_iters. The port steps one at a time; --train_occ makes its
    per-dispatch decisions (warm-up, the binary grid, the grid refresh, the
    phase switch) on this grid of steps, as the JAX trainer does."""
    cadences = [c for c in (args.i_print, args.i_weights, args.i_testset, args.i_img)
                if c > 0]
    inner = int(np.gcd.reduce(cadences)) if cadences else 100
    return max(1, min(inner, args.N_iters))


class OccTraining:
    """The --train_occ side of a run (train/occ_train.py): the density
    grid over the scene box, the occupancy-gated step and its warm-up
    variant (sigma noise max(raw_noise_std, --train_occ_warmup_noise),
    which breaks the zero-gradient transparency trap of a fine-only start),
    and the binary grid of the current dispatch window."""

    def __init__(self, args, rcfg, fcfg, spec, aabb, device, world=None):
        self.rcfg, self.fcfg = rcfg, fcfg
        self.warmup = int(args.train_occ_warmup)
        self.decay = float(args.train_occ_decay)
        self.alpha = resolved_occ_alpha_thresh(args)
        self.budget = bool(args.train_occ_budget)
        self.max_probes = int(args.train_occ_probe_budget) or None
        kw = dict(n_candidates=args.train_occ_candidates, n_keep=args.train_occ_keep,
                  explore=args.train_occ_explore, tv_reg=args.tv_loss_weight, world=world)
        self.step_fn = occ_train.make_occ_train_step(rcfg, fcfg, spec, **kw)
        warm_noise = max(float(rcfg.raw_noise_std), float(args.train_occ_warmup_noise))
        self.warm_fn = (occ_train.make_occ_train_step(
            dataclasses.replace(rcfg, raw_noise_std=warm_noise), fcfg, spec, **kw)
            if warm_noise != float(rcfg.raw_noise_std) else self.step_fn)
        self.grid = occ_train.init_density_grid(*aabb, args.train_occ_res, device)
        self.warm, self.occ, self.density = True, None, None

    def start_window(self, step: int):
        """The decisions of a dispatch window starting at global step
        ``step``: warm-up or not, the binary grid, the budgeting grid."""
        self.warm = step < self.warmup
        self.occ = occ_train.binarize_density_grid(
            self.grid, alpha_threshold=self.alpha, force_occupied=self.warm)
        self.density = self.grid if (self.budget and not self.warm) else None

    def train_step(self, state, images, poses, generator):
        fn = self.warm_fn if self.warm else self.step_fn
        return fn(state, self.occ, images, poses, generator, density=self.density)

    def refresh(self, params_fine, seed: int):
        """One density-grid update from the live fine network."""
        gen = torch.Generator(device=self.grid.ema.device).manual_seed(seed)
        self.grid = occ_train.update_density_grid(
            self.grid, params_fine, self.fcfg, self.rcfg, gen, decay=self.decay,
            max_probes=self.max_probes)

    def hook_grid(self, step: int):
        """The grid the render hooks see at ``step``: the training grid
        (all occupied during the warm-up), since the coarse net is untrained."""
        return occ_train.binarize_density_grid(
            self.grid, alpha_threshold=self.alpha, force_occupied=step < self.warmup)


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


def join_world(args, device: torch.device) -> World:
    """The run's data-parallel world: with --multihost, under a launcher
    (torchrun's RANK / WORLD_SIZE) or in a process group the caller made,
    ``parallel.distributed.initialize``; else one process. Then
    --mesh_shape is checked against it (``parallel.mesh.make_mesh``)."""
    if (bool(getattr(args, "multihost", False)) or distributed.launched_by_env()
            or (torch.distributed.is_available() and torch.distributed.is_initialized())):
        world = distributed.initialize(str(device))
    else:
        world = World(0, 1, str(device), False)
    try:
        return make_mesh(getattr(args, "mesh_shape", None), world)
    except (ValueError, NotImplementedError):
        distributed.shutdown(world)
        raise


def train(args):
    """The hierarchical trainer (reference main.py:55-143): seeded state
    or the newest checkpoint, then one step per iteration with the print,
    checkpoint, test-set, validation-image and render-path hooks, and a
    final checkpoint. Returns the TrainState.

    --debug_nans turns on the NaN checks (utils/debug.py) for the run and
    off again when it returns. Data parallel (``join_world``): every rank
    loads the dataset and takes rank 0's state after init or resume; each
    step draws ceil(N_rand / n) rays a rank and mean-reduces the gradients
    (train/step.py); rank 0 alone logs and writes checkpoints, TensorBoard
    and the hooks' frames. At more than one rank every rank takes part in
    the test-set, validation-image and video renders, which split each
    frame over the ranks as the JAX trainer's hooks split it over its mesh:
    the sharded froxel frame while there is an occupancy source (--occ_grid,
    or --train_occ until its switch), else the sharded dense frame."""
    check_trainer_flags(args)
    check_barf(args)
    device = resolve_device(args.device)
    pin_fp32()
    debug_nans = bool(getattr(args, "debug_nans", False))
    if debug_nans:
        enable_nan_checks(True)
    world = None
    try:
        world = join_world(args, device)
        return _train(args, torch.device(world.device) if world.launched else device, world)
    finally:
        if debug_nans:
            enable_nan_checks(False)
        distributed.shutdown(world)


def _train(args, device: torch.device, world: World):
    main = world.is_main
    # the step's collectives run whenever a process group exists (one rank
    # too); a plain run steps unsharded
    step_world = world if world.launched else None
    ds = load_datasets(args)
    H, W, _ = ds.hwf
    for msg in recipe_warnings(args, n_train_views=len(ds.i_train), render_h=H):
        warnings.warn(msg, UserWarning, stacklevel=3)
        print(f"[RECIPE WARNING] {msg}")
    tb_writer = None
    if main:
        copy_log_dir(args)
        tb_writer = make_tb_writer(args)
    _resolve_triplane_aabb(args, ds, H, W)
    ccfg, fcfg = _sync_triplane_res(args, *nerf_configs(args))
    if int(getattr(args, "barf_anneal", 0)) > 0:
        print(f"BARF annealing: frequency bands ramp over steps "
              f"[{int(getattr(args, 'barf_anneal_start', 0))}, "
              f"{int(args.barf_anneal)}]")
    ls_spec = loss_sampling_spec(args)
    if ls_spec is not None:
        print(f"loss sampling: {ls_spec.frac:.0%} of rays from the "
              f"per-image {ls_spec.tile}px-tile error map "
              f"(EMA decay {ls_spec.decay})")
    ema_decay = float(getattr(args, "ema_decay", 0.0))
    if ema_decay > 0.0:
        print(f"EMA eval: decay {ema_decay} shadow of the field params "
              "(training uses raw params; eval/render use the average)")
    refine_poses = bool(getattr(args, "refine_poses", False))
    appearance = bool(getattr(args, "appearance", False))
    state = get_train_state(args, device, cfgs=(ccfg, fcfg),
                            n_refine_poses=len(ds.i_train) if refine_poses else 0,
                            n_appearance=len(ds.i_train) if appearance else 0)
    if refine_poses:
        print(f"pose refinement: {len(ds.i_train)} learnable se(3) "
              f"corrections (lr {getattr(args, 'pose_lrate', 1e-3)})")
    if appearance:
        print(f"appearance: {len(ds.i_train)} per-image exposure/WB "
              f"corrections (lr {getattr(args, 'appearance_lrate', 1e-3)}); "
              "eval renders the canonical (uncorrected) radiance")
    if ema_decay > 0.0:
        # restore_train_state fills the shadow from the checkpoint's ema/
        # sidecar, or restarts it at the loaded weights
        state.init_ema()
    start = ckpt_utils.restore_train_state(state, args)
    if ls_spec is not None:
        # not checkpointed: a resume starts the map uniform
        state.loss_map = init_loss_map(len(ds.i_train), H, W, ls_spec.tile, device)
    distributed.broadcast_state(state, world)
    if world.size > 1:
        print(f"data parallel: rank {world.rank} of {world.size}, "
              f"{-(-args.N_rand // world.size)} rays a rank a step")
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
    if rcfg.proposal:
        print(f"proposal sampler: coarse branch is a density-only "
              f"{args.proposal_depth}x{args.proposal_width} MLP "
              f"(interlevel loss weight {args.proposal_loss_weight})")
    inner = dispatch_steps(args)
    train_occ = bool(args.train_occ)
    occ_run = None
    if train_occ:
        # grid-triaged fine-only sampling replaces the coarse + fine
        # hierarchy; the density grid refreshes once per dispatch window
        if fcfg is None:
            raise SystemExit("--train_occ requires N_importance > 0 "
                             "(the fine network is the trained one)")
        occ_run = OccTraining(args, rcfg, fcfg, spec, _occ_aabb(renderer, ds, H, W, ds.K),
                              device, step_world)
        print(f"occupancy-gated training: fine-only, C={args.train_occ_candidates} "
              f"K={args.train_occ_keep}, grid {args.train_occ_res}^3 (refreshed per "
              f"dispatch of {inner} steps)")
    # two-phase schedule (--train_occ_until): occupancy-gated bulk, then the
    # hierarchical trainer, the coarse branch seeded from the fine one
    occ_until = int(args.train_occ_until) if train_occ else 0
    if occ_until > 0:
        print(f"two-phase schedule: occ-gated until step {occ_until}, "
              "hierarchical after")

    def make_steps(ccfg, fcfg):
        """(step, warm-up step or None). --warmup_noise: sigma noise >= 1
        for the first N steps, the escape from the white-background
        transparency trap."""
        kw = dict(acc_reg=args.acc_loss_weight, tv_reg=args.tv_loss_weight,
                  pose_anchor=bool(getattr(args, "pose_anchor", True)),
                  pose_start=int(getattr(args, "refine_poses_from", 500)),
                  barf_end=int(getattr(args, "barf_anneal", 0)),
                  barf_start=int(getattr(args, "barf_anneal_start", 0)),
                  prop_reg=args.proposal_loss_weight,
                  dist_reg=args.distortion_loss_weight, loss_sampling=ls_spec,
                  ema_decay=ema_decay, world=step_world,
                  coarse_weight=coarse_loss_weight(args))
        warm = None
        # the occ trainer has its own warm-up (--train_occ_warmup)
        if args.warmup_noise > 0 and not args.train_occ:
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

    def make_sharded_hook(ccfg, fcfg):
        """At more than one rank, hook(kw, models) -> the hook's pose
        renderer split over the ranks (None: rank 0 renders unsharded), as
        the JAX trainer's sharded hooks: the froxel frame while ``kw``
        (``hook_kw``) holds an occupancy grid, the dense frame otherwise
        (after the --train_occ_until switch, or with no occupancy source).
        Rebuilt at a triplane upsample."""
        if world.size == 1:
            return None
        froxel = dense = None
        box = {}
        if fcfg is not None and (occ_maint is not None or train_occ):
            froxel = sharded_froxel_fn(args, world, renderer.cfg, fcfg, H, W, ds.K,
                                       lambda: box["fine"], lambda: box["occ"])
        if froxel is None or occ_until > 0:
            dense = sharded_dense_fn(args, world, renderer.cfg, ccfg, fcfg, H, W, ds.K,
                                     lambda: (box["coarse"], box["fine"]))

        def hook(kw, models):
            box["coarse"], box["fine"] = (_model_parts(m)[0] for m in models)
            box["occ"] = kw.get("occ_grid")
            return froxel if box["occ"] is not None else dense

        return hook

    step_fn, warm_fn = make_steps(ccfg, fcfg)
    occ_maint = make_occ_maint(fcfg)
    sharded_hook = make_sharded_hook(ccfg, fcfg)
    upsample_ms = _upsample_milestones(args, start)

    if upsample_ms and train_occ:
        raise SystemExit("--triplane_upsample is standard-trainer only; "
                         "combine with --train_occ is not supported")
    switched = False

    def hook_kw(step):
        if occ_maint is not None:
            return dict(occ_grid=occ_maint.get(state.fine.params(), step),
                        **_occ_render_args(args))
        if occ_run is not None and not switched:
            # the coarse net is untrained until the phase switch: the hooks
            # render through the training grid
            return dict(occ_grid=occ_run.hook_grid(step), **_occ_render_args(args))
        return {}

    def hook_render(i):
        """(models, the render_from_batch_poses engine arguments) of the
        hooks at step i, or None on a rank that skips an unsharded
        hook."""
        models = _eval_models(args, i, state.coarse, state.fine, state.ema)
        kw = hook_kw(i)
        rfn = sharded_hook(kw, models) if sharded_hook is not None else None
        if rfn is not None:
            return models, {"render_fn": rfn}
        return (models, kw) if main else None

    generator = torch.Generator()
    N_iters = args.N_iters + 1
    print(f"Begin: {len(ds.i_train)} train views, {len(ds.i_test)} test views, "
          f"device {device}")
    if occ_until > 0 and start - inner + 1 > occ_until:
        # resumed past the switching dispatch: the checkpoint carries the
        # trained coarse net, so no re-sync (a checkpoint at the end of the
        # last occ-gated dispatch switches, and syncs, in the loop)
        switched = True
        print(f"[PHASE] resume at step {start + 1} > {occ_until}: hierarchical phase")
    t0 = t_train_start = time.perf_counter()
    rays_done, warned = 0, False
    for i in range(start + 1, N_iters):
        while upsample_ms and i > upsample_ms[0][0]:
            _, new_G = upsample_ms.pop(0)
            if new_G <= _plane_res(ccfg, fcfg):
                print(f"[UPSAMPLE] skip {new_G}^2: planes already "
                      f"{_plane_res(ccfg, fcfg)}^2")
                continue
            state, ccfg, fcfg = _upsample_state(state, new_G, args)
            step_fn, warm_fn = make_steps(ccfg, fcfg)
            occ_maint = make_occ_maint(fcfg)
            sharded_hook = make_sharded_hook(ccfg, fcfg)
            print(f"[UPSAMPLE] step {i - 1}: planes -> {new_G}^2 "
                  "(optimizer restarted at the continued schedule)")
        window = (i - start - 1) % inner == 0
        if window and occ_until > 0 and not switched and i > occ_until:
            if ccfg == fcfg:
                sync_coarse_from_fine(state)
                seed_msg = "coarse seeded from fine (+Adam moments)"
            else:
                seed_msg = "coarse/fine architectures differ — coarse trains from init"
            switched = True
            print(f"[PHASE] step {i - 1}: occ -> hierarchical; {seed_msg}")
        # each step's draws depend on (seed, step, rank) only, so a resumed
        # run draws what an uninterrupted one would
        generator.manual_seed(distributed.rank_seed((int(args.jax_seed) << 32) + i,
                                                    world.rank))
        if occ_run is not None and not switched:
            if window:
                occ_run.start_window(state.step)
            aux = occ_run.train_step(state, images_tr, poses_tr, generator)
            if (i - start) % inner == 0 or i == N_iters - 1:
                occ_run.refresh(state.fine.params(), (int(args.jax_seed) << 32) + i + (1 << 62))
        else:
            fn = warm_fn if warm_fn is not None and i <= args.warmup_noise else step_fn
            aux = fn(state, images_tr, poses_tr, generator)
        rays_done += args.N_rand
        hooked = False

        if main and args.i_print > 0 and i % args.i_print == 0:
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

        if main and args.i_weights > 0 and i % args.i_weights == 0:
            paths = ckpt_utils.save_checkpoints(args.basedir, args.expname, state, i,
                                                fmt=args.ckpt_format)
            print(f"Saved checkpoints at {paths}")

        if args.i_testset > 0 and i % args.i_testset == 0:
            testsavedir = os.path.join(args.basedir, args.expname, f"testset_{i:06d}")
            hook = hook_render(i)
            if hook is not None:
                renderer.render_from_batch_poses(
                    H, W, ds.K, args.chunk, ds.poses[ds.i_test], *hook[0], retraw=False,
                    save_directory=testsavedir if main else None, **hook[1])
            if main:
                print(f"Saved test set renders to {testsavedir}")
            hooked = True

        if args.i_img > 0 and i % args.i_img == 0 and len(ds.i_val):
            val_i = int(ds.i_val[(i // args.i_img) % len(ds.i_val)])
            hook = hook_render(i)
            if hook is not None:
                rgb = renderer.render_from_batch_poses(
                    H, W, ds.K, args.chunk, ds.poses[val_i][None, :3, :4], *hook[0],
                    retraw=False, **hook[1])[0]
            if main:
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
            hook = hook_render(i)
            if hook is not None:
                renderer.render_from_batch_poses(
                    H, W, ds.K, args.chunk, rposes, *hook[0], retraw=False,
                    save_directory=videodir if main else None,
                    b_combine_as_video=True, **hook[1])
            if main:
                print(f"Saved render-path video to {videodir}")
            hooked = True
        if hooked:
            # rays/sec counts training only: restart its window after the
            # renders (they end in a device -> host copy)
            t0, rays_done = time.perf_counter(), 0
        if _hook_step(args, i, len(ds.i_val)):
            distributed.barrier(world)

    if main:
        ckpt_utils.save_checkpoints(args.basedir, args.expname, state, N_iters - 1,
                                    fmt=args.ckpt_format)
    distributed.barrier(world)
    return state


def _hook_step(args, i: int, n_val: int) -> bool:
    """Whether step ``i`` logs, saves or renders (work on rank 0 that the
    other ranks wait for at a barrier)."""
    return any(c > 0 and i % c == 0 for c in (args.i_print, args.i_weights,
                                              args.i_testset, args.i_video)) or (
        args.i_img > 0 and i % args.i_img == 0 and n_val > 0)


class EvalEngine:
    """Everything needed to render novel views from a checkpoint: dataset
    geometry, the restored models, the renderer, the optional occupancy
    grid and, in a world (``join_world``), the sharded pose renderer
    ``render_fn``. Built once and reused across poses by render_only and by
    apps/serve.py."""

    def __init__(self, ds, H, W, K, renderer, ccfg, fcfg, coarse, fine,
                 occ_grid, start, args, device, render_fn=None, world=None):
        self.ds = ds
        self.H, self.W, self.K = H, W, K
        self.renderer = renderer
        self.ccfg, self.fcfg = ccfg, fcfg
        self.coarse, self.fine = coarse, fine
        self.occ_grid = occ_grid
        self.render_fn = render_fn
        self.start = start
        self.args = args
        self.device = device
        self.world = world if world is not None else World(0, 1, str(device), False)

    def render_poses(self, poses, save_directory=None, generator=None,
                     b_combine_as_video=False):
        """Render a [N, 3+, 4] pose batch through the engine's path
        (sharded / occupancy / gated / dense); returns float rgbs [N, H, W,
        3]. With ``b_combine_as_video`` the frames also go to
        ``save_directory``/video.gif. In a world of several ranks rank 0
        alone writes; a single-card engine (no ``render_fn``) renders on
        rank 0 alone and the other ranks skip the frames (None)."""
        a = self.args
        if not self.world.is_main:
            save_directory = None
            if self.render_fn is None and self.world.size > 1:
                return None
        return self.renderer.render_from_batch_poses(
            self.H, self.W, self.K, a.chunk, poses, self.coarse, self.fine,
            retraw=False, save_directory=save_directory, generator=generator,
            save_depth=getattr(a, "render_depth", False),
            gate_threshold=a.render_gate, occ_grid=self.occ_grid,
            b_combine_as_video=b_combine_as_video, render_fn=self.render_fn,
            **_occ_render_args(a))

    def close(self):
        """Leave the world the engine joined (a no-op for an adopted group
        or one process)."""
        distributed.shutdown(self.world)

    @property
    def engine_name(self):
        if self.render_fn is not None:
            return "sharded-" + ("froxel" if self.occ_grid is not None else "dense")
        if self.occ_grid is not None:
            return "occ-" + self.args.occ_mode
        if self.args.render_gate > 0.0:
            return "gated"
        return "dense"


def sharded_froxel_fn(args, world, rcfg, fcfg, H, W, K, params_of, occ_of):
    """A pose renderer ``fn(c2w, generator) -> maps`` through the sharded
    froxel frame (render/froxels.make_sharded_render_froxel) at eval
    semantics: ``params_of()`` the fine network's parameters and
    ``occ_of()`` the occupancy grid at call time."""
    from nerf_shared_tpu_torch.render.froxels import build_froxels, make_sharded_render_froxel

    eval_rcfg = dataclasses.replace(rcfg, perturb=0.0, raw_noise_std=0.0,
                                    fused_backward=False)
    frame = make_sharded_render_froxel(world, eval_rcfg, fcfg, H, W, tile=args.occ_tile,
                                       n_keep=args.occ_keep, block=args.chunk,
                                       n_fine=args.occ_fine)

    def render_fn(c2w, generator=None):
        params = params_of()
        dev = next(iter(params.values())).device
        c2w = torch.as_tensor(c2w, dtype=torch.float32, device=dev)[:3, :4]
        # the frame's froxels, as render_image_froxels builds them
        fro = build_froxels(occ_of(), H, W, K, c2w, float(eval_rcfg.near),
                            float(eval_rcfg.far), n_depth=args.occ_candidates,
                            tile=args.occ_tile, lindisp=eval_rcfg.lindisp, ndc=eval_rcfg.ndc,
                            n_keep=args.occ_keep)
        return frame(params, fro, K, c2w)

    return render_fn


def sharded_dense_fn(args, world, rcfg, ccfg, fcfg, H, W, K, params_of):
    """A pose renderer ``fn(c2w, generator) -> maps`` through the sharded
    dense frame (parallel/render.make_sharded_pose_render, blocks of
    --chunk rays): ``params_of()`` the (coarse, fine or None) parameters
    at call time."""
    from nerf_shared_tpu_torch.parallel.render import make_sharded_pose_render

    frame = make_sharded_pose_render(world, rcfg, ccfg, fcfg, H, W, block=args.chunk)

    def render_fn(c2w, generator=None):
        pc, pf = params_of()
        return frame(pc, pf, K, c2w)

    return render_fn


def build_eval_engine(args, ds=None) -> EvalEngine:
    """Load the newest checkpoint (or seeded init weights when there is
    none) and assemble the render engine on ``--device``: the renderer,
    and with --occ_grid the occupancy grid of the fine network. With
    --ema_decay the models hold the checkpoint's EMA shadow (its raw
    weights when it has none), as the JAX engine renders them.

    In a world (``join_world``: torchrun, --multihost, or a process group
    the caller made; --mesh_shape checked against it) each pose renders
    split over the ranks, by the JAX engine's policy: the sharded froxel
    frame with an occupancy grid, a fine network and --occ_mode froxel; the
    sharded dense frame with no grid and --render_gate 0; the paths JAX
    keeps on one card (grid-mode occupancy, the gated engine) render on
    rank 0 alone."""
    device = resolve_device(args.device)
    pin_fp32()
    world = join_world(args, device)
    if world.launched:
        device = torch.device(world.device)
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
    coarse_sd, fine_sd, start = ckpt_utils.load_checkpoint(
        args, ema=float(getattr(args, "ema_decay", 0.0)) > 0.0)
    if coarse_sd is not None:
        coarse.load_state_dict(coarse_sd, strict=True)
        if fine is not None and fine_sd:
            fine.load_state_dict(fine_sd, strict=True)
    # mid-anneal (--barf_anneal) the engine renders the checkpoint step's
    # masked encoder, as the training hooks do
    for m, pair in zip((coarse, fine), _eval_models(args, start, coarse, fine)):
        if isinstance(pair, tuple):
            m.load_state_dict(pair[0], strict=True)
    coarse.eval()
    if fine is not None:
        fine.eval()
    renderer = get_renderer(args, ds.bds_dict, device)
    occ_grid = _build_occ_grid(args, renderer, ds, H, W, K, coarse, fine)
    render_fn = None
    if world.launched:
        if (occ_grid is not None and fine is not None
                and getattr(args, "occ_mode", "froxel") == "froxel"):
            render_fn = sharded_froxel_fn(args, world, renderer.cfg, fine.cfg, H, W, K,
                                          fine.params, lambda: occ_grid)
        elif occ_grid is None and args.render_gate <= 0.0:
            render_fn = sharded_dense_fn(
                args, world, renderer.cfg, ccfg, fcfg, H, W, K,
                lambda: (coarse.params(), None if fine is None else fine.params()))
        print(f"render world: rank {world.rank} of {world.size}, "
              + ("sharded frames" if render_fn is not None else "frames on rank 0"))
    return EvalEngine(ds, H, W, K, renderer, ccfg, fcfg, coarse, fine, occ_grid,
                      start, args, device, render_fn=render_fn, world=world)


def render_only(args, return_rgbs: bool = False, ds=None):
    """Reload the newest weights and render render_poses (or the test set
    with --render_test) to PNGs and video.gif (reference utils.py:330-358).
    Returns the output directory, and with ``return_rgbs`` also the float
    renders (apps/eval_cli.py computes its metrics on these). ``ds`` takes a
    dataset its caller has loaded already. In a world every rank walks the
    poses and rank 0 alone writes; the other ranks return None for the
    renders."""
    eng = build_eval_engine(args, ds=ds)
    try:
        suffix = "test" if args.render_test else "path"
        outdir = os.path.join(args.basedir, args.expname,
                              f"renderonly_{suffix}_{eng.start:06d}")
        poses = eng.ds.render_poses
        poses = poses[:, :3, :4] if poses.ndim == 3 else poses
        rgbs = eng.render_poses(poses, save_directory=outdir, b_combine_as_video=True)
        distributed.barrier(eng.world)
        if not eng.world.is_main:
            rgbs = None
        else:
            print(f"Done rendering {rgbs.shape[0]} views to {outdir}")
    finally:
        eng.close()
    if return_rgbs:
        return outdir, rgbs
    return outdir


def main(argv=None):
    return run(config_parser().parse_args(argv))


if __name__ == "__main__":
    main()
