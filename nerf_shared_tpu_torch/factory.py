"""Model / renderer / train-state factories — the args -> objects glue.

Counterpart of ``nerf_configs``, ``get_renderer`` and ``get_train_state``
in ``nerf_shared_tpu/factory.py`` (reference utils.py:119-172), for the MLP
family.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from nerf_shared_tpu_torch.models.nerf import NeRF, NeRFConfig
from nerf_shared_tpu_torch.render.renderer import Renderer
from nerf_shared_tpu_torch.train.state import TrainState, create_train_state


def nerf_configs(args) -> Tuple[NeRFConfig, Optional[NeRFConfig]]:
    """Coarse + (optional) fine model configs from flags (reference
    utils.py:119-139). The output_ch=5 quirk is kept: it only matters when
    use_viewdirs=False (reference nerf.py:94)."""
    output_ch = 5 if args.N_importance > 0 else 4

    def cfg(D, W):
        return NeRFConfig(D=D, W=W, output_ch=output_ch, skips=(4,),
                          use_viewdirs=args.use_viewdirs,
                          multires=args.multires,
                          multires_views=args.multires_views,
                          i_embed=args.i_embed)

    ccfg = cfg(args.netdepth, args.netwidth)
    fcfg = (cfg(args.netdepth_fine, args.netwidth_fine)
            if args.N_importance > 0 else None)
    return ccfg, fcfg


def create_nerf_models(args, device) -> Tuple[NeRF, Optional[NeRF]]:
    """Coarse + fine models with seeded init (torch.Generator from
    --jax_seed), on ``device``."""
    g = torch.Generator().manual_seed(int(args.jax_seed))
    ccfg, fcfg = nerf_configs(args)
    coarse = NeRF(ccfg, device=device, generator=g)
    fine = NeRF(fcfg, device=device, generator=g) if fcfg is not None else None
    return coarse, fine


def get_renderer(args, bds_dict, device) -> Renderer:
    """Renderer from flags + dataset bounds; NDC only for LLFF without
    no_ndc (reference utils.py:141-161). ``--use_pallas`` (the default)
    means the hand-written CUDA kernels; on the CPU their plain versions
    run whatever the flag says. ``--render_guided`` sets the guided fine
    pass (it raises with N_importance 0)."""
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
        **bds_dict,
    )


def get_train_state(args, device) -> TrainState:
    """Seeded coarse + fine networks (from --jax_seed) and one Adam over
    them at --lrate with the --lrate_decay schedule (reference
    utils.py:163-172, main.py:107-112)."""
    ccfg, fcfg = nerf_configs(args)
    return create_train_state(ccfg, fcfg, device, seed=int(args.jax_seed),
                              lrate=args.lrate, lrate_decay=args.lrate_decay)
