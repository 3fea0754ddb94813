"""Model / renderer / train-state factories — the args -> objects glue.

Counterpart of ``nerf_configs``, ``create_nerf_models``, ``get_renderer``
and ``get_train_state`` in ``nerf_shared_tpu/factory.py`` (reference
utils.py:119-172), for the MLP family and the grid families (hashgrid,
triplane), in the reference hierarchy or under ``--proposal`` with a
density-only proposal MLP as the coarse branch (the fine branch an MLP or,
in the mixed hierarchy, a grid family), and mip-NeRF (``--model_type
mipnerf``: one IPE network for both passes, no fine branch, its render
route and its learning-rate schedule).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from nerf_shared_tpu_torch.config import check_mip_flags, resolved_hash_sigma_bias
from nerf_shared_tpu_torch.models.hashgrid import HashGridConfig
from nerf_shared_tpu_torch.models.nerf import MipNeRFConfig, NeRFConfig
from nerf_shared_tpu_torch.models.triplane import TriplaneConfig
from nerf_shared_tpu_torch.render.renderer import Renderer
from nerf_shared_tpu_torch.train.state import (
    MipSchedule,
    TrainState,
    create_train_state,
    make_model,
)

GRID_FAMILIES = ("triplane", "hashgrid")


def _grid_config(args):
    """The grid family's config from flags; the AABB is the NDC box for
    LLFF scenes in NDC, else the cube of half-extent --triplane_aabb (4.5
    when 0; apps/train resolves 0 from the train cameras first)."""
    if args.dataset_type == "llff" and not args.no_ndc:
        aabb_min, aabb_max = (-1.05, -1.05, -1.001), (1.05, 1.05, 1.001)
    else:
        half = float(getattr(args, "triplane_aabb", 0.0)) or 4.5
        aabb_min, aabb_max = (-half,) * 3, (half,) * 3
    common = dict(use_viewdirs=args.use_viewdirs, multires_views=args.multires_views,
                  i_embed=args.i_embed, aabb_min=aabb_min, aabb_max=aabb_max)
    if args.model_type == "hashgrid":
        return HashGridConfig(
            L=args.hash_levels, log2_T=args.hash_log2_size, F=args.hash_feat,
            base_res=args.hash_base_res, max_res=args.hash_max_res,
            hidden=args.hash_hidden, rgb_depth=args.hash_depth,
            layout=args.hash_layout, sigma_bias=resolved_hash_sigma_bias(args),
            **common)
    return TriplaneConfig(G=args.triplane_res, C=args.triplane_feat,
                          hidden=args.triplane_hidden, depth=args.triplane_depth,
                          layout=args.triplane_layout, **common)


def proposal_config(args) -> NeRFConfig:
    """The --proposal coarse branch: a density-only MLP of --proposal_depth
    x --proposal_width (no viewdirs, output 4); N_importance 0 raises."""
    if args.N_importance <= 0:
        raise ValueError("--proposal replaces the hierarchical coarse branch and "
                         "needs N_importance > 0")
    return NeRFConfig(D=int(args.proposal_depth), W=int(args.proposal_width),
                      output_ch=4, skips=(4,), use_viewdirs=False,
                      multires=args.multires, multires_views=args.multires_views,
                      i_embed=args.i_embed)


def mip_config(args) -> MipNeRFConfig:
    """mip-NeRF's one network (``--model_type mipnerf``): netdepth x
    netwidth, the rest its published recipe (``MipNeRFConfig``). Raises on
    a flag it does not take (config.check_mip_flags)."""
    check_mip_flags(args)
    return MipNeRFConfig(D=args.netdepth, W=args.netwidth)


def nerf_configs(args) -> Tuple[object, Optional[object]]:
    """Coarse + (optional) fine model configs from flags (reference
    utils.py:119-139). Grid families use one config for both branches;
    under --proposal the coarse branch is ``proposal_config``'s MLP. The
    MLP family keeps the output_ch=5 quirk: it only matters when
    use_viewdirs=False (reference nerf.py:94). mip-NeRF has one network:
    (``mip_config``, None)."""
    if getattr(args, "model_type", "nerf") == "mipnerf":
        return mip_config(args), None
    proposal = bool(getattr(args, "proposal", False))
    if getattr(args, "model_type", "nerf") in GRID_FAMILIES:
        gcfg = _grid_config(args)
        if proposal:
            return proposal_config(args), gcfg
        return gcfg, (gcfg if args.N_importance > 0 else None)
    output_ch = 5 if args.N_importance > 0 else 4

    def cfg(D, W):
        return NeRFConfig(D=D, W=W, output_ch=output_ch, skips=(4,),
                          use_viewdirs=args.use_viewdirs,
                          multires=args.multires,
                          multires_views=args.multires_views,
                          i_embed=args.i_embed)

    ccfg = proposal_config(args) if proposal else cfg(args.netdepth, args.netwidth)
    fcfg = (cfg(args.netdepth_fine, args.netwidth_fine)
            if args.N_importance > 0 else None)
    return ccfg, fcfg


def create_nerf_models(args, device, cfgs=None):
    """Coarse + fine field modules (NeRF, HashGrid or Triplane) with seeded
    init (torch.Generator from --jax_seed), on ``device``; ``cfgs`` (coarse,
    fine) overrides the configs built from the flags."""
    g = torch.Generator().manual_seed(int(args.jax_seed))
    ccfg, fcfg = cfgs if cfgs is not None else nerf_configs(args)
    coarse = make_model(ccfg, device, g)
    fine = make_model(fcfg, device, g) if fcfg is not None else None
    return coarse, fine


def get_renderer(args, bds_dict, device) -> Renderer:
    """Renderer from flags + dataset bounds; NDC only for LLFF without
    no_ndc (reference utils.py:141-161). ``--use_pallas`` (the default)
    means the hand-written CUDA kernels; on the CPU their plain versions
    run whatever the flag says. ``--render_guided`` sets the guided fine
    pass (it raises with N_importance 0); ``--proposal`` marks the coarse
    branch as a proposal network; ``--precision`` sets the MLP family's
    compute dtype; ``--model_type mipnerf`` takes mip-NeRF's route."""
    use_kernels = (bool(getattr(args, "use_pallas", True))
                   and torch.device(device).type == "cuda")
    return Renderer(
        perturb=args.perturb,
        N_importance=args.N_importance,
        N_samples=args.N_samples,
        use_viewdirs=args.use_viewdirs,
        white_bkgd=args.white_bkgd,
        raw_noise_std=args.raw_noise_std,
        ndc=args.dataset_type == "llff" and not args.no_ndc,
        lindisp=args.lindisp,
        use_pallas=use_kernels,
        fused_composite=use_kernels
        and bool(getattr(args, "fused_composite", False)),
        guided=int(getattr(args, "render_guided", 0)),
        remat=bool(getattr(args, "remat", False)),
        proposal=bool(getattr(args, "proposal", False)),
        precision=str(getattr(args, "precision", "fp32")),
        mip=getattr(args, "model_type", "nerf") == "mipnerf",
        **bds_dict,
    )


def coarse_loss_weight(args) -> float:
    """The coarse MSE's weight: mip-NeRF's ``coarse_loss_mult`` under
    ``--model_type mipnerf``, else 1."""
    if getattr(args, "model_type", "nerf") != "mipnerf":
        return 1.0
    return MipNeRFConfig.coarse_loss_mult


def grid_lrate(args) -> Optional[float]:
    """--grid_lrate for the grid families (the mixed hierarchy's grid fine
    included), None (one Adam group) for the MLP family."""
    if getattr(args, "model_type", "nerf") in GRID_FAMILIES:
        return float(getattr(args, "grid_lrate", 2e-2))
    return None


def get_train_state(args, device, cfgs=None, n_refine_poses: int = 0,
                    n_appearance: int = 0) -> TrainState:
    """Seeded coarse + fine fields (from --jax_seed) and Adam at --lrate
    (and --grid_lrate for the grid group) with the --lrate_decay schedule
    (reference utils.py:163-172, main.py:107-112); ``cfgs`` as in
    ``create_nerf_models``. ``n_refine_poses`` / ``n_appearance`` add the
    per-image pose twists / appearance corrections at --pose_lrate /
    --appearance_lrate."""
    ccfg, fcfg = cfgs if cfgs is not None else nerf_configs(args)
    return create_train_state(ccfg, fcfg, device, seed=int(args.jax_seed),
                              lrate=args.lrate, lrate_decay=args.lrate_decay,
                              grid_lrate=grid_lrate(args),
                              n_refine_poses=n_refine_poses,
                              pose_lrate=float(getattr(args, "pose_lrate", 1e-3)),
                              n_appearance=n_appearance,
                              appearance_lrate=float(getattr(args, "appearance_lrate", 1e-3)),
                              schedule=MipSchedule() if getattr(
                                  args, "model_type", "nerf") == "mipnerf" else None)
