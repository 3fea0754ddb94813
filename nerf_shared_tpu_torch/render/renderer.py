"""The volume-rendering engine of the port: dense hierarchical rendering,
the guided fine pass, and the facade over the fast engines.

Counterpart of ``nerf_shared_tpu/render/renderer.py`` (reference
render_utils.py:13-319), with the same return keys (rgb_map / disp_map /
acc_map / raw / weights / z_vals / rgb0 / disp0 / acc0 / z_std) and the same
dispatch seams:

- ``_apply_model``: the network on sample points. It dispatches on the
  config type first: a grid family (``HashGridConfig``, ``TriplaneConfig``)
  runs ``apply_hashgrid`` / ``apply_triplane``, whose table reads are
  kernel P1 (backward P2) on CUDA tensors, under ``torch.utils.checkpoint``
  with ``remat``; it never reaches B1-B4. For the MLP family, under
  ``fused_backward`` (the training path) this is ``fused_train_op``: kernel
  B1 forward, kernel B2 backward (ops/cuda/fused_mlp_bwd.py); under
  ``use_pallas`` it is ``fused_nerf_forward`` (kernel B1: the gated
  renderer and the occupancy grid's probe come through here); otherwise
  the plain ``apply_nerf``.
- ``_apply_model_rays``: the network on (o, d, z). For the MLP family under
  ``use_pallas`` this is kernel B3 (ops/cuda/fused_mlp.py), which builds
  the sample points itself, unless ``fused_backward`` sends the network
  through B1 / B2 (the pose app's step composites through B5 that way);
  otherwise ``_apply_model`` on o + z·d.
- ``_composite``: raw -> pixel maps, for every render path (dense, guided,
  gated, occupancy grid, froxels). Under ``use_pallas`` without sigma noise
  this is kernel B5 (ops/cuda/composite.py), which reads B3's ray-major raw
  as it is; otherwise ``raw2outputs``.
- ``_fused_render_eligible`` / ``_apply_render_fused``: kernel B4
  (ops/cuda/fused_render.py), network + composite in one launch, when
  ``fused_composite`` is on, the network is the MLP family and nothing
  downstream needs per-sample raw values or sigma noise. The CUDA kernels
  take any sample count, so the JAX package's S % 8 condition is gone.

The trainer keeps B3, B4 and B5 off its step by clearing ``use_pallas`` and
``fused_composite`` in the step's config (``apps/train.py``).

``RenderConfig.precision`` ("fp32" or "bf16", ``--precision``) is the MLP
family's compute dtype at all three seams, as the JAX seams read it: under
"bf16" B1-B4 launch their bf16 instantiations and the plain network is
``apply_nerf`` in bf16 (the proposal network's route included). The grid
families ignore it, as in JAX; the composite stays fp32.

Under ``RenderConfig.proposal`` the coarse branch is a density-only
proposal MLP (factory.proposal_config): it runs through the plain network
on every route, as the JAX package runs it through XLA, never B1-B4 (they
target the 8x256 family); its composite still goes through ``_composite``
(B5 under ``use_pallas``). Its weights only place the fine samples: it
returns no ``rgb0`` / ``disp0`` / ``acc0``, and with ``retweights`` hands
its histogram out as ``weights0`` / ``z_vals0`` for the interlevel loss.

Under ``RenderConfig.mip`` (``--model_type mipnerf``) ``render_rays``
takes mip-NeRF's route, ``render_rays_mip``: cones (the ray batch carries
each ray's base radius, column 8: [o, d, near, far, radius, viewdirs]),
N_samples intervals between N_samples + 1 stratified edges, each a
Gaussian (ops/mip.py), one network for both passes (the coarse one:
there is no fine network), its fine edges resampled from the blurred
coarse weights under stop-gradient and not merged with the coarse ones,
and the interval composite (ops/compositing.composite_intervals). The
network runs through ``_apply_model`` on the Gaussian records: kernels B1
and B2 with their IPE encoder on the training step, B1 for frames (B3,
B4 and B5 take no intervals). Under a profiler the Gaussians, the blur
and the resampling are ``train_step.gauss`` spans.

Models are passed into every call (a field module: ``NeRF``, ``HashGrid``
or ``Triplane``; a (params, cfg) tuple; or None). A full image is rendered
by a plain Python loop over ray blocks of ``chunk`` rays; no padding is
needed. Random draws come from an
optional ``torch.Generator`` on the rays' device; ``overrides`` pins them
(``t_rand``, ``u``, ``noise_coarse``, ``noise_fine``) for tests. The fast
engines live in render/gated.py, render/occupancy.py and render/froxels.py;
``Renderer.render_image_gated``, ``render_image_occ`` and the engine
arguments of ``render_from_batch_poses`` reach them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from nerf_shared_tpu_torch.data.images import gif_encode, imwrite_u8
from nerf_shared_tpu_torch.models.hashgrid import HashGrid, HashGridConfig, apply_hashgrid
from nerf_shared_tpu_torch.models.nerf import NeRF, NeRFConfig, apply_nerf
from nerf_shared_tpu_torch.models.triplane import Triplane, TriplaneConfig, apply_triplane
from nerf_shared_tpu_torch.ops.compositing import composite_intervals, raw2outputs
from nerf_shared_tpu_torch.ops.cuda.composite import composite_fused
from nerf_shared_tpu_torch.ops.cuda.fused_mlp import (
    fused_nerf_forward,
    fused_nerf_forward_rays,
)
from nerf_shared_tpu_torch.ops.cuda.fused_mlp_bwd import fused_train_op
from nerf_shared_tpu_torch.ops.cuda.fused_render import fused_render_rays
from nerf_shared_tpu_torch.ops.mip import cast_rays
from nerf_shared_tpu_torch.ops.rays import frame_radii, get_rays, ndc_rays
from nerf_shared_tpu_torch.ops.sampling import (
    resample_intervals,
    sample_along_rays,
    sample_pdf,
)
from nerf_shared_tpu_torch.utils.metrics import to8b
from nerf_shared_tpu_torch.utils.profiling import span


def _apply_model(params, mcfg, pts, viewdirs, rcfg):
    """The network on points [N, S, 3] -> raw [N, S, C]."""
    if not isinstance(mcfg, NeRFConfig):
        if isinstance(mcfg, HashGridConfig):
            apply = apply_hashgrid
        elif isinstance(mcfg, TriplaneConfig):
            apply = apply_triplane
        else:
            raise TypeError(f"unknown model config type {type(mcfg).__name__}")
        if rcfg.remat and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(
                lambda p, x, d: apply(p, mcfg, x, d), params, pts, viewdirs,
                use_reentrant=False)
        return apply(params, mcfg, pts, viewdirs)
    dtype = rcfg.compute_dtype
    if rcfg.fused_backward:
        return fused_train_op(params, mcfg, pts, viewdirs, dtype)
    if rcfg.use_pallas:
        return fused_nerf_forward(
            params, mcfg, pts.contiguous(),
            None if viewdirs is None else viewdirs.contiguous(), dtype)
    return apply_nerf(params, mcfg, pts, viewdirs, dtype)


def _apply_model_rays(params, mcfg, rays_o, rays_d, z_vals, viewdirs, rcfg):
    """The network on the samples o + z·d of each ray -> raw [N, S, C]."""
    if rcfg.use_pallas and not rcfg.fused_backward and isinstance(mcfg, NeRFConfig):
        return fused_nerf_forward_rays(params, mcfg, rays_o, rays_d, z_vals,
                                       viewdirs, rcfg.compute_dtype)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    return _apply_model(params, mcfg, pts, viewdirs, rcfg)


def split_rays(ray_batch):
    """(rays_o, rays_d, viewdirs or None), contiguous, of a packed
    [N, 8 | 11] ray batch (o, d, near, far[, viewdirs])."""
    rays_o, rays_d = ray_batch[:, 0:3].contiguous(), ray_batch[:, 3:6].contiguous()
    viewdirs = ray_batch[:, -3:].contiguous() if ray_batch.shape[-1] > 8 else None
    return rays_o, rays_d, viewdirs


def _fused_render_eligible(rcfg, mcfg, noise, need_raw):
    """Network + composite as one kernel launch (B4) applies on the kernel
    render path to the MLP family when nothing downstream needs per-sample
    raw values or sigma noise (any sample count)."""
    return (rcfg.use_pallas and rcfg.fused_composite and not rcfg.fused_backward
            and isinstance(mcfg, NeRFConfig)
            and rcfg.raw_noise_std == 0.0 and noise is None
            and not need_raw)


def _apply_render_fused(params, mcfg, rays_o, rays_d, z_vals, viewdirs, rcfg,
                        want_weights):
    return fused_render_rays(params, mcfg, rays_o, rays_d, z_vals, viewdirs,
                             white_bkgd=rcfg.white_bkgd,
                             want_weights=want_weights,
                             compute_dtype=rcfg.compute_dtype)


def _composite(raw, z_vals, rays_d, rcfg, noise=None, generator=None):
    """raw -> (rgb, disp, acc, weights, depth), the one compositing seam of
    every render path: kernel B5 under ``use_pallas`` when no sigma noise
    is drawn or given, ``raw2outputs`` otherwise (the trainer's step clears
    ``use_pallas``, so training composites through the plain version)."""
    if rcfg.use_pallas and rcfg.raw_noise_std == 0.0 and noise is None:
        return composite_fused(raw.contiguous(), z_vals.contiguous(),
                               rays_d.contiguous(), white_bkgd=rcfg.white_bkgd)
    return raw2outputs(raw, z_vals, rays_d, raw_noise_std=rcfg.raw_noise_std,
                       white_bkgd=rcfg.white_bkgd, noise=noise,
                       generator=generator)


_COMPUTE_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Render hyperparameters (reference render_utils.py:14-30)."""

    perturb: float = 1.0
    N_importance: int = 128
    N_samples: int = 64
    use_viewdirs: bool = True
    white_bkgd: bool = True
    raw_noise_std: float = 0.0
    ndc: bool = False
    lindisp: bool = False
    near: float = 0.0
    far: float = 1.0
    # evaluate the network and the composite with the hand-written CUDA
    # kernels (B1 on points, B3 on rays, B5 composite; B4 instead of B3 + B5
    # under fused_composite). On CPU tensors the kernels' plain versions run
    use_pallas: bool = False
    fused_composite: bool = False
    # train through fused_train_op: kernel B1 forward + kernel B2 backward
    # (on CPU tensors apply_nerf and autograd); it takes the MLP off B3 and
    # B4 whatever use_pallas says (B5 still composites under use_pallas)
    fused_backward: bool = False
    # render-time guided sampling: when > 0 the fine pass evaluates only
    # this many samples placed by the coarse histogram, not the dense
    # N_samples + N_importance union. Needs the hierarchy: N_importance > 0
    guided: int = 0
    # recompute the grid families' apply in backward (torch.utils.checkpoint)
    remat: bool = False
    # the coarse branch is a density-only proposal MLP (mip-NeRF 360): its
    # weights drive sample_pdf, it renders no rgb, and it runs through the
    # plain network whatever the kernel flags say. Needs N_importance > 0
    proposal: bool = False
    # the MLP family's compute dtype: "fp32", or "bf16" (bf16 operands, fp32
    # accumulation; the kernels' bf16 instantiations, apply_nerf in bf16)
    precision: str = "fp32"
    # mip-NeRF's cone-traced intervals (render_rays_mip): the ray batch
    # carries each ray's radius; N_importance is 0 or N_samples (its fine
    # pass resamples as many edges as the coarse pass has)
    mip: bool = False

    def __post_init__(self):
        if self.precision not in _COMPUTE_DTYPES:
            raise ValueError(f"precision {self.precision!r}: fp32 or bf16")
        if self.mip:
            bad = [name for name, on in (
                ("bf16 (--precision)", self.precision != "fp32"),
                ("guided sampling (--render_guided)", self.guided > 0),
                ("the proposal sampler (--proposal)", self.proposal),
                ("NDC rays", self.ndc), ("lindisp", self.lindisp),
                ("no view directions (--use_viewdirs False)", not self.use_viewdirs),
                ("sigma noise (--raw_noise_std)", self.raw_noise_std != 0.0),
                ("the fused composite (--fused_composite, kernel B4)",
                 self.fused_composite)) if on]
            if bad:
                raise ValueError("mip-NeRF's route (--model_type mipnerf) runs fp32 "
                                 "cone-traced intervals through kernels B1 / B2; it "
                                 f"does not take {', '.join(bad)}")
            if self.N_importance not in (0, self.N_samples):
                raise ValueError(
                    f"mip-NeRF (--model_type mipnerf) resamples as many intervals as "
                    f"its coarse pass has: "
                    f"N_importance must be 0 or N_samples ({self.N_samples}), got "
                    f"{self.N_importance}")
        if self.guided > 0 and self.N_importance <= 0:
            raise ValueError(
                f"guided={self.guided} places the fine samples by the coarse "
                "histogram and needs N_importance > 0 (with N_importance 0 "
                "there is no fine pass to guide)")

    @property
    def compute_dtype(self) -> torch.dtype:
        """``precision`` as the torch dtype the MLP seams take."""
        return _COMPUTE_DTYPES[self.precision]


def render_rays(
    params_coarse,
    params_fine,                 # None -> the coarse model is reused
    ray_batch: torch.Tensor,     # [N, 8] or [N, 11] (with viewdirs)
    rcfg: RenderConfig,
    ccfg,
    fcfg,
    retraw: bool = False,
    retweights: bool = False,
    overrides: Optional[Dict[str, torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
    retraw_coarse: bool = False,
) -> Dict[str, torch.Tensor]:
    """Render a flat ray batch (reference render_utils.py:67-174).
    ``retraw_coarse`` also returns the coarse pass's raw outputs as 'raw0'
    (the density-sparsity regularizer reads them). Under ``rcfg.proposal``
    the coarse pass is the proposal network's, under ``rcfg.mip`` this is
    ``render_rays_mip`` (module docstring)."""
    if rcfg.mip:
        return render_rays_mip(params_coarse, ray_batch, rcfg, ccfg, retraw=retraw,
                               retweights=retweights, overrides=overrides,
                               generator=generator)
    overrides = overrides or {}
    rays_o, rays_d, viewdirs = split_rays(ray_batch)
    near, far = ray_batch[:, 6:7], ray_batch[:, 7:8]

    z_vals = sample_along_rays(
        near, far, rcfg.N_samples, lindisp=rcfg.lindisp, perturb=rcfg.perturb,
        t_rand=overrides.get("t_rand"), generator=generator,
    ).contiguous()

    ret: Dict[str, torch.Tensor] = {}
    # with N_importance == 0 the coarse pass is the final pass and owns the
    # retraw / 'raw' contract
    coarse_needs_raw = retraw_coarse or (retraw and rcfg.N_importance == 0)
    raw = None
    proposal = rcfg.proposal and rcfg.N_importance > 0
    if proposal:
        prop_rcfg = dataclasses.replace(rcfg, use_pallas=False, fused_backward=False,
                                        fused_composite=False)
        raw = _apply_model_rays(params_coarse, ccfg, rays_o, rays_d, z_vals, None,
                                prop_rcfg)
        rgb_map, disp_map, acc_map, weights, _ = _composite(
            raw, z_vals, rays_d, rcfg, overrides.get("noise_coarse"), generator)
        if retraw_coarse:
            ret["raw0"] = raw
    elif rcfg.N_importance == 0 and _fused_render_eligible(
            rcfg, ccfg, overrides.get("noise_coarse"), coarse_needs_raw):
        rgb_map, disp_map, acc_map, weights, _ = _apply_render_fused(
            params_coarse, ccfg, rays_o, rays_d, z_vals, viewdirs, rcfg,
            want_weights=True)
    else:
        raw = _apply_model_rays(params_coarse, ccfg, rays_o, rays_d, z_vals,
                                viewdirs, rcfg)
        rgb_map, disp_map, acc_map, weights, _ = _composite(
            raw, z_vals, rays_d, rcfg, overrides.get("noise_coarse"), generator)
        if retraw_coarse:
            ret["raw0"] = raw

    if rcfg.N_importance > 0:
        rgb_map_0, disp_map_0, acc_map_0 = rgb_map, disp_map, acc_map
        if proposal and retweights:
            ret["weights0"] = weights
            ret["z_vals0"] = z_vals
        z_vals_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        z_samples = sample_pdf(
            z_vals_mid, weights[..., 1:-1],
            rcfg.guided if rcfg.guided > 0 else rcfg.N_importance,
            det=(rcfg.perturb == 0.0), u=overrides.get("u"),
            generator=generator,
        ).detach()  # reference render_utils.py:145
        if rcfg.guided > 0:
            # guided: the fine set is the histogram-placed samples alone
            z_vals = torch.sort(z_samples, dim=-1).values.contiguous()
        else:
            z_vals = torch.sort(torch.cat([z_vals, z_samples], dim=-1),
                                dim=-1).values.contiguous()

        fine_params = params_coarse if params_fine is None else params_fine
        fine_cfg = ccfg if fcfg is None else fcfg
        if _fused_render_eligible(rcfg, fine_cfg, overrides.get("noise_fine"),
                                  need_raw=retraw):
            rgb_map, disp_map, acc_map, weights, _ = _apply_render_fused(
                fine_params, fine_cfg, rays_o, rays_d, z_vals, viewdirs, rcfg,
                want_weights=retweights)
        else:
            raw = _apply_model_rays(fine_params, fine_cfg, rays_o, rays_d,
                                    z_vals, viewdirs, rcfg)
            rgb_map, disp_map, acc_map, weights, _ = _composite(
                raw, z_vals, rays_d, rcfg, overrides.get("noise_fine"),
                generator)
        if not proposal:
            ret["rgb0"] = rgb_map_0
            ret["disp0"] = disp_map_0
            ret["acc0"] = acc_map_0
        ret["z_std"] = torch.std(z_samples, dim=-1, correction=0)

    ret["rgb_map"] = rgb_map
    ret["disp_map"] = disp_map
    ret["acc_map"] = acc_map
    if retraw:
        ret["raw"] = raw
    if retweights:
        ret["weights"] = weights
        ret["z_vals"] = z_vals
    return ret


def render_rays_mip(params, ray_batch: torch.Tensor, rcfg: RenderConfig, cfg,
                    retraw: bool = False, retweights: bool = False,
                    overrides: Optional[Dict[str, torch.Tensor]] = None,
                    generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """mip-NeRF's two levels over a ray batch [N, 12] ([o, d, near, far,
    radius, viewdirs]) with one network ``params`` / ``cfg`` (an IPE
    NeRFConfig): the keys of ``render_rays`` ('z_vals' holds the final
    pass's edges, [N, N_samples + 1]; 'z_std' the spread of the fine
    edges). Draws from ``generator``: the stratified jitter, then the
    resampling positions; ``overrides`` pins them (``t_rand``, ``u``)."""
    if not (isinstance(cfg, NeRFConfig) and cfg.ipe):
        raise TypeError("RenderConfig.mip renders mip-NeRF's network (an IPE NeRFConfig)")
    if ray_batch.shape[-1] != 12:
        raise ValueError(f"mip-NeRF's ray batch is [N, 12] (o, d, near, far, radius, "
                         f"viewdirs), got {tuple(ray_batch.shape)}")
    overrides = overrides or {}
    rays_o, rays_d, viewdirs = split_rays(ray_batch)
    near, far, radii = ray_batch[:, 6:7], ray_batch[:, 7:8], ray_batch[:, 8:9]
    ret: Dict[str, torch.Tensor] = {}
    for level in range(2 if rcfg.N_importance > 0 else 1):
        with span("train_step.gauss"):
            if level == 0:
                t_vals = sample_along_rays(near, far, rcfg.N_samples + 1, perturb=rcfg.perturb,
                                           t_rand=overrides.get("t_rand"), generator=generator)
            else:
                t_vals = resample_intervals(t_vals, weights, cfg.resample_padding,
                                            det=rcfg.perturb == 0.0, u=overrides.get("u"),
                                            generator=generator).detach()
            t_vals = t_vals.contiguous()
            gauss = cast_rays(t_vals, rays_o, rays_d, radii)
        raw = _apply_model(params, cfg, gauss, viewdirs, rcfg)
        rgb_map, disp_map, acc_map, weights, _ = composite_intervals(
            raw, t_vals, rays_d, cfg.density_bias, cfg.rgb_padding, rcfg.white_bkgd)
        if level == 0 and rcfg.N_importance > 0:
            ret.update(rgb0=rgb_map, disp0=disp_map, acc0=acc_map)
        elif level == 1:
            ret["z_std"] = torch.std(t_vals, dim=-1, correction=0)
    ret.update(rgb_map=rgb_map, disp_map=disp_map, acc_map=acc_map)
    if retraw:
        ret["raw"] = raw
    if retweights:
        ret["weights"] = weights
        ret["z_vals"] = t_vals
    return ret


def _model_parts(model):
    """(params, cfg) of a field module, a (params, cfg) tuple, or None."""
    if model is None:
        return None, None
    if isinstance(model, tuple):
        return model
    if isinstance(model, (NeRF, HashGrid, Triplane)):
        return model.params(), model.cfg
    raise TypeError(f"not a model: {type(model).__name__}")


def _model_device(model) -> torch.device:
    params, _ = _model_parts(model)
    return next(iter(params.values())).device


class Renderer:
    """Facade holding render hyperparameters over the pure ``render_rays``
    (reference render_utils.py:13-319)."""

    def __init__(self, **kwargs):
        self.cfg = RenderConfig(**kwargs)

    def _pack_rays(self, H, W, K, rays, c2w, device=None):
        """The flat [N, 8|11] ray tensor from a pose or from (rays_o,
        rays_d) (reference render_utils.py:198-226)."""
        if c2w is not None:
            rays_o, rays_d = get_rays(H, W, K, c2w)
        else:
            rays_o, rays_d = rays[0], rays[1]
        if device is not None:
            rays_o, rays_d = rays_o.to(device), rays_d.to(device)
        radii = None
        if self.cfg.mip:
            if rays_d.dim() != 3:
                raise ValueError("mip-NeRF's cone radii come from a frame's rays "
                                 "[H, W, 3]")
            radii = frame_radii(rays_d.float()).reshape(-1, 1)
        if self.cfg.use_viewdirs:
            viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
            viewdirs = viewdirs.reshape(-1, 3).float()

        sh = rays_d.shape
        if self.cfg.ndc:
            focal = float(np.asarray(K)[0][0])
            rays_o, rays_d = ndc_rays(H, W, focal, 1.0, rays_o, rays_d)

        rays_o = rays_o.reshape(-1, 3).float()
        rays_d = rays_d.reshape(-1, 3).float()
        near = self.cfg.near * torch.ones_like(rays_d[..., :1])
        far = self.cfg.far * torch.ones_like(rays_d[..., :1])
        packed = torch.cat([rays_o, rays_d, near, far]
                           + ([radii] if radii is not None else []), dim=-1)
        if self.cfg.use_viewdirs:
            packed = torch.cat([packed, viewdirs], dim=-1)
        return packed, sh

    def render_flat_rays(self, rays_flat, coarse_model, fine_model,
                         chunk: int = 1024 * 32, retraw: bool = False,
                         retweights: bool = False,
                         generator: Optional[torch.Generator] = None):
        """Render [N, 8|11] rays in blocks of ``chunk`` (reference
        render_utils.py:51-65)."""
        pc, ccfg = _model_parts(coarse_model)
        pf, fcfg = _model_parts(fine_model)
        outs: Dict[str, list] = {}
        for i in range(0, rays_flat.shape[0], chunk):
            ret = render_rays(pc, pf, rays_flat[i:i + chunk], self.cfg, ccfg,
                              fcfg, retraw=retraw, retweights=retweights,
                              generator=generator)
            for k, v in ret.items():
                outs.setdefault(k, []).append(v)
        return {k: torch.cat(v, dim=0) for k, v in outs.items()}

    def render(self, H, W, K, coarse_model, fine_model, chunk: int = 1024 * 32,
               rays=None, retraw: bool = True, c2w=None,
               generator: Optional[torch.Generator] = None,
               retweights: bool = False):
        """Render a ray batch or a full image pose; returns
        [rgb, disp, acc, extras] (reference render_utils.py:176-238)."""
        device = _model_device(coarse_model)
        if c2w is not None:
            c2w = torch.as_tensor(c2w, dtype=torch.float32, device=device)
        rays_flat, sh = self._pack_rays(H, W, K, rays, c2w, device)
        all_ret = self.render_flat_rays(
            rays_flat, coarse_model, fine_model, chunk=chunk, retraw=retraw,
            retweights=retweights, generator=generator)
        out = {k: v.reshape(list(sh[:-1]) + list(v.shape[1:]))
               for k, v in all_ret.items()}
        k_extract = ["rgb_map", "disp_map", "acc_map"]
        return [out[k] for k in k_extract] + [
            {k: v for k, v in out.items() if k not in k_extract}]

    def render_from_pose(self, H, W, K, chunk, c2w, coarse_model, fine_model,
                         retraw=True, generator=None):
        return self.render(H, W, K, coarse_model, fine_model, chunk=chunk,
                           c2w=c2w, retraw=retraw, generator=generator)

    def _pose(self, c2w, model):
        """c2w as a float32 [3, 4] tensor on ``model``'s device."""
        return torch.as_tensor(np.asarray(c2w, np.float32)[:3, :4],
                               device=_model_device(model))

    def render_image_gated(self, H, W, K, c2w, coarse_model, fine_model,
                           chunk: int = 1024 * 32,
                           generator: Optional[torch.Generator] = None,
                           threshold: float = 1e-3):
        """Full-image render that skips the fine pass of rays whose coarse
        opacity is below ``threshold`` (render/gated.py): returns
        (rgb [H,W,3], extras dict with [H,W] maps and active_fraction).
        Raises under ``proposal``: the proposal network renders no colour
        for the rays it would keep."""
        if self.cfg.proposal:
            raise ValueError(
                "the gated renderer keeps the coarse rgb for sub-threshold "
                "rays; under --proposal the coarse branch is density-only "
                "(its rgb head is untrained) — use the dense or occ/froxel "
                "render paths instead")
        from nerf_shared_tpu_torch.render.gated import render_flat_rays_gated

        pc, ccfg = _model_parts(coarse_model)
        pf, fcfg = _model_parts(fine_model)
        c2w = self._pose(c2w, coarse_model)
        rays_flat, sh = self._pack_rays(H, W, K, None, c2w, c2w.device)
        ret = render_flat_rays_gated(
            rays_flat, (pc, ccfg), (pf, fcfg) if pf is not None else None,
            self.cfg, ccfg, fcfg, chunk=chunk, generator=generator,
            threshold=threshold)
        out = {k: v.reshape(list(sh[:-1]) + list(v.shape[1:]))
               for k, v in ret.items() if k != "active_fraction"}
        out["active_fraction"] = ret["active_fraction"]
        return out["rgb_map"], out

    def render_image_occ(self, H, W, K, c2w, fine_model, occ_grid,
                         chunk: int = 1024 * 32,
                         generator: Optional[torch.Generator] = None,
                         n_candidates: int = 128, n_keep: int = 64,
                         select: str = "sort", gate_rays: bool = False,
                         mode: str = "froxel", tile: int = 8, n_fine: int = 0):
        """Full-image render through an occupancy grid: only the n_keep
        chosen grid-occupied candidate depths per ray reach the network;
        ``n_fine > 0`` adds a hierarchical refinement pass on top
        (occupancy.refine_hierarchical).

        ``mode``: 'froxel' (default) resamples the grid once per frame into
        camera froxels (render/froxels.py); 'grid' looks every candidate up
        in the world grid (render/occupancy.py) and alone takes ``select``
        and ``gate_rays``. Returns (rgb [H,W,3], extras dict)."""
        c2w = self._pose(c2w, fine_model)
        if mode == "froxel":
            if select != "sort" or gate_rays:
                raise ValueError(
                    "select/gate_rays only apply to mode='grid'; "
                    "mode='froxel' (the default) ignores them — pass "
                    "mode='grid' to keep the gated world-grid semantics. "
                    "(froxel bin selection is contribution-weighted "
                    "automatically when the grid carries density)")
            from nerf_shared_tpu_torch.render.froxels import render_image_froxels

            out = render_image_froxels(
                fine_model, occ_grid, self.cfg, H, W, K, c2w,
                generator=generator, n_depth=n_candidates, n_keep=n_keep,
                tile=tile, chunk=chunk, n_fine=n_fine)
            return out["rgb_map"], out
        if mode != "grid":
            raise ValueError(f"occupancy mode {mode!r}: use 'froxel' or 'grid'")
        from nerf_shared_tpu_torch.render.occupancy import render_flat_rays_occ

        rays_flat, sh = self._pack_rays(H, W, K, None, c2w, c2w.device)
        ret = render_flat_rays_occ(
            rays_flat, fine_model, occ_grid, self.cfg, chunk=chunk,
            generator=generator, n_candidates=n_candidates, n_keep=n_keep,
            select=select, gate_rays=gate_rays, n_fine=n_fine)
        out = {k: (v.reshape(list(sh[:-1]) + list(v.shape[1:]))
                   if torch.is_tensor(v) else v) for k, v in ret.items()}
        return out["rgb_map"], out

    @torch.no_grad()
    def render_from_batch_poses(self, H, W, K, chunk, batch_c2w, coarse_model,
                                fine_model, retraw=True,
                                save_directory: Optional[str] = None,
                                generator=None, save_depth: bool = False,
                                gate_threshold: float = 0.0, occ_grid=None,
                                occ_candidates: int = 128, occ_keep: int = 64,
                                occ_mode: str = "froxel", occ_tile: int = 8,
                                occ_select: str = "sort", occ_fine: int = 0,
                                b_combine_as_video: bool = False, render_fn=None):
        """Render poses at perturb 0 without sigma noise; PNGs (and with
        ``save_depth`` NNN_disp.png + disp.npy) go to ``save_directory``,
        and with ``b_combine_as_video`` the frames as video.gif at 30 fps
        (data/images.gif_encode; the JAX package writes video.mp4 when
        imageio has an ffmpeg backend, else video.gif). Returns float rgbs
        [N, H, W, 3] as numpy (reference render_utils.py:293-319).

        The engine: a caller's pose renderer ``render_fn(c2w [3, 4],
        generator)`` when given (the sharded renders of apps/train.py),
        returning the rgb map or a map dict whose ``disp_map``
        ``save_depth`` reads; else with ``occ_grid`` the occupancy render
        (``render_image_occ`` with the ``occ_*`` arguments, through the
        fine model), else with ``gate_threshold > 0`` the gated render,
        else the dense hierarchical render (guided when the config says).

        Under a profiler each pose's render and host copy is a ``frame``
        span, the copy a ``frame.copy`` child (utils/profiling.py)."""
        eval_renderer = Renderer(**{**dataclasses.asdict(self.cfg),
                                    "perturb": 0.0, "raw_noise_std": 0.0})
        if save_directory is not None:
            os.makedirs(save_directory, exist_ok=True)
        rgbs, disps = [], []
        for i, c2w in enumerate(np.asarray(batch_c2w)):
            with span("frame"):
                disp = None
                if render_fn is not None:
                    rgb = render_fn(c2w[:3, :4], generator)
                    if isinstance(rgb, dict):
                        disp = rgb.get("disp_map")
                        rgb = rgb["rgb_map"]
                elif occ_grid is not None:
                    rgb, out = eval_renderer.render_image_occ(
                        H, W, K, c2w,
                        fine_model if fine_model is not None else coarse_model,
                        occ_grid, chunk=chunk, generator=generator,
                        n_candidates=occ_candidates, n_keep=occ_keep,
                        mode=occ_mode, tile=occ_tile, select=occ_select,
                        n_fine=occ_fine)
                    disp = out["disp_map"]
                elif gate_threshold > 0.0:
                    rgb, out = eval_renderer.render_image_gated(
                        H, W, K, c2w, coarse_model, fine_model, chunk=chunk,
                        generator=generator, threshold=gate_threshold)
                    disp = out["disp_map"]
                else:
                    rgb, disp, _, _ = eval_renderer.render_from_pose(
                        H, W, K, chunk=chunk, c2w=c2w[:3, :4],
                        coarse_model=coarse_model, fine_model=fine_model,
                        retraw=retraw, generator=generator)
                with span("frame.copy"):
                    rgbs.append(rgb.float().cpu().numpy())
            if save_directory is not None:
                imwrite_u8(os.path.join(save_directory, f"{i:03d}.png"),
                           to8b(rgbs[-1]))
            if save_depth and disp is not None:
                d = disp.float().cpu().numpy().reshape(rgbs[-1].shape[:2])
                disps.append(d)
                if save_directory is not None:
                    viz = np.where(d < 1e9, d, 0.0)
                    dmax = float(viz.max())
                    imwrite_u8(os.path.join(save_directory, f"{i:03d}_disp.png"),
                               to8b(viz / dmax if dmax > 0 else viz))
        if save_depth and disps and save_directory is not None:
            np.save(os.path.join(save_directory, "disp.npy"), np.stack(disps))
        if b_combine_as_video and rgbs and save_directory is not None:
            with open(os.path.join(save_directory, "video.gif"), "wb") as f:
                f.write(gif_encode(to8b(np.stack(rgbs)), fps=30))
        return np.stack(rgbs) if rgbs else np.zeros((0, H, W, 3), np.float32)
