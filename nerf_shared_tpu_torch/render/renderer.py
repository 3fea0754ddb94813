"""The volume-rendering engine of the port: dense hierarchical rendering.

Counterpart of ``nerf_shared_tpu/render/renderer.py`` (reference
render_utils.py:13-319), with the same return keys (rgb_map / disp_map /
acc_map / raw / weights / z_vals / rgb0 / disp0 / acc0 / z_std) and the same
dispatch seams:

- ``_apply_model``: the network on sample points. Under ``fused_backward``
  (the training path) this is ``fused_train_op``: kernel B1 forward, kernel
  B2 backward (ops/cuda/fused_mlp_bwd.py); otherwise the plain
  ``apply_nerf``.
- ``_apply_model_rays``: the network on (o, d, z). Under ``use_pallas``
  this is kernel B3 (ops/cuda/fused_mlp.py), which builds the sample
  points itself; otherwise ``_apply_model`` on o + z·d.
- ``_fused_render_eligible`` / ``_apply_render_fused``: kernel B4
  (ops/cuda/fused_render.py), network + composite in one launch, when
  ``fused_composite`` is on and nothing downstream needs per-sample raw
  values or sigma noise. The CUDA kernels take any sample count, so the
  JAX package's S % 8 condition is gone.

The trainer keeps B3 and B4 off its step by clearing ``use_pallas`` and
``fused_composite`` in the step's config (``apps/train.py``).

Models are passed into every call (a ``NeRF`` module, a (params, cfg)
tuple, or None). A full image is rendered by a plain Python loop over ray
blocks of ``chunk`` rays; no padding is needed. Random draws come from an
optional ``torch.Generator``; ``overrides`` pins them (``t_rand``, ``u``,
``noise_coarse``, ``noise_fine``) for tests.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch

from nerf_shared_tpu_torch.data.images import imwrite_u8
from nerf_shared_tpu_torch.models.nerf import NeRF, apply_nerf
from nerf_shared_tpu_torch.ops.compositing import raw2outputs
from nerf_shared_tpu_torch.ops.cuda.fused_mlp import fused_nerf_forward_rays
from nerf_shared_tpu_torch.ops.cuda.fused_mlp_bwd import fused_train_op
from nerf_shared_tpu_torch.ops.cuda.fused_render import fused_render_rays
from nerf_shared_tpu_torch.ops.rays import get_rays, ndc_rays
from nerf_shared_tpu_torch.ops.sampling import sample_along_rays, sample_pdf
from nerf_shared_tpu_torch.utils.metrics import to8b


def _apply_model(params, mcfg, pts, viewdirs, rcfg):
    """The network on points [N, S, 3] -> raw [N, S, C]."""
    if rcfg.fused_backward:
        return fused_train_op(params, mcfg, pts, viewdirs)
    return apply_nerf(params, mcfg, pts, viewdirs)


def _apply_model_rays(params, mcfg, rays_o, rays_d, z_vals, viewdirs, rcfg):
    """The network on the samples o + z·d of each ray -> raw [N, S, C]."""
    if rcfg.use_pallas:
        return fused_nerf_forward_rays(params, mcfg, rays_o, rays_d, z_vals,
                                       viewdirs)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    return _apply_model(params, mcfg, pts, viewdirs, rcfg)


def _fused_render_eligible(rcfg, noise, need_raw):
    """Network + composite as one kernel launch applies on the kernel
    render path when nothing downstream needs per-sample raw values or
    sigma noise (any sample count)."""
    return (rcfg.use_pallas and rcfg.fused_composite
            and rcfg.raw_noise_std == 0.0 and noise is None
            and not need_raw)


def _apply_render_fused(params, mcfg, rays_o, rays_d, z_vals, viewdirs, rcfg,
                        want_weights):
    return fused_render_rays(params, mcfg, rays_o, rays_d, z_vals, viewdirs,
                             white_bkgd=rcfg.white_bkgd,
                             want_weights=want_weights)


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
    # evaluate the network with the hand-written CUDA kernels (B3; B4 too
    # under fused_composite). On CPU tensors the kernels' plain versions run
    use_pallas: bool = False
    fused_composite: bool = False
    # train through fused_train_op: kernel B1 forward + kernel B2 backward
    # (on CPU tensors apply_nerf and autograd)
    fused_backward: bool = False


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
    (the density-sparsity regularizer reads them)."""
    overrides = overrides or {}
    rays_o, rays_d = ray_batch[:, 0:3], ray_batch[:, 3:6]
    viewdirs = ray_batch[:, -3:] if ray_batch.shape[-1] > 8 else None
    near, far = ray_batch[:, 6:7], ray_batch[:, 7:8]
    rays_o, rays_d = rays_o.contiguous(), rays_d.contiguous()
    if viewdirs is not None:
        viewdirs = viewdirs.contiguous()

    z_vals = sample_along_rays(
        near, far, rcfg.N_samples, lindisp=rcfg.lindisp, perturb=rcfg.perturb,
        t_rand=overrides.get("t_rand"), generator=generator,
    ).contiguous()

    ret: Dict[str, torch.Tensor] = {}
    # with N_importance == 0 the coarse pass is the final pass and owns the
    # retraw / 'raw' contract
    coarse_needs_raw = retraw_coarse or (retraw and rcfg.N_importance == 0)
    raw = None
    if rcfg.N_importance == 0 and _fused_render_eligible(
            rcfg, overrides.get("noise_coarse"), coarse_needs_raw):
        rgb_map, disp_map, acc_map, weights, _ = _apply_render_fused(
            params_coarse, ccfg, rays_o, rays_d, z_vals, viewdirs, rcfg,
            want_weights=True)
    else:
        raw = _apply_model_rays(params_coarse, ccfg, rays_o, rays_d, z_vals,
                                viewdirs, rcfg)
        rgb_map, disp_map, acc_map, weights, _ = raw2outputs(
            raw, z_vals, rays_d, raw_noise_std=rcfg.raw_noise_std,
            white_bkgd=rcfg.white_bkgd, noise=overrides.get("noise_coarse"),
            generator=generator)
        if retraw_coarse:
            ret["raw0"] = raw

    if rcfg.N_importance > 0:
        rgb_map_0, disp_map_0, acc_map_0 = rgb_map, disp_map, acc_map
        z_vals_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        z_samples = sample_pdf(
            z_vals_mid, weights[..., 1:-1], rcfg.N_importance,
            det=(rcfg.perturb == 0.0), u=overrides.get("u"),
            generator=generator,
        ).detach()  # reference render_utils.py:145
        z_vals, _ = torch.sort(torch.cat([z_vals, z_samples], dim=-1), dim=-1)
        z_vals = z_vals.contiguous()

        fine_params = params_coarse if params_fine is None else params_fine
        fine_cfg = ccfg if fcfg is None else fcfg
        if _fused_render_eligible(rcfg, overrides.get("noise_fine"),
                                  need_raw=retraw):
            rgb_map, disp_map, acc_map, weights, _ = _apply_render_fused(
                fine_params, fine_cfg, rays_o, rays_d, z_vals, viewdirs, rcfg,
                want_weights=retweights)
        else:
            raw = _apply_model_rays(fine_params, fine_cfg, rays_o, rays_d,
                                    z_vals, viewdirs, rcfg)
            rgb_map, disp_map, acc_map, weights, _ = raw2outputs(
                raw, z_vals, rays_d, raw_noise_std=rcfg.raw_noise_std,
                white_bkgd=rcfg.white_bkgd, noise=overrides.get("noise_fine"),
                generator=generator)
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


def _model_parts(model):
    """(params, cfg) of a NeRF module, a (params, cfg) tuple, or None."""
    if model is None:
        return None, None
    if isinstance(model, tuple):
        return model
    if isinstance(model, NeRF):
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
        packed = torch.cat([rays_o, rays_d, near, far], dim=-1)
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

    @torch.no_grad()
    def render_from_batch_poses(self, H, W, K, chunk, batch_c2w, coarse_model,
                                fine_model, retraw=True,
                                save_directory: Optional[str] = None,
                                generator=None, save_depth: bool = False):
        """Render poses at perturb 0 without sigma noise; PNGs (and with
        ``save_depth`` NNN_disp.png + disp.npy) go to ``save_directory``.
        Returns float rgbs [N, H, W, 3] as numpy (reference
        render_utils.py:293-319; video export is not ported)."""
        eval_renderer = Renderer(**{**dataclasses.asdict(self.cfg),
                                    "perturb": 0.0, "raw_noise_std": 0.0})
        if save_directory is not None:
            os.makedirs(save_directory, exist_ok=True)
        rgbs, disps = [], []
        for i, c2w in enumerate(np.asarray(batch_c2w)):
            rgb, disp, _, _ = eval_renderer.render_from_pose(
                H, W, K, chunk=chunk, c2w=c2w[:3, :4],
                coarse_model=coarse_model, fine_model=fine_model,
                retraw=retraw, generator=generator)
            rgbs.append(rgb.float().cpu().numpy())
            if save_directory is not None:
                imwrite_u8(os.path.join(save_directory, f"{i:03d}.png"),
                           to8b(rgbs[-1]))
            if save_depth:
                d = disp.float().cpu().numpy().reshape(rgbs[-1].shape[:2])
                disps.append(d)
                if save_directory is not None:
                    viz = np.where(d < 1e9, d, 0.0)
                    dmax = float(viz.max())
                    imwrite_u8(os.path.join(save_directory, f"{i:03d}_disp.png"),
                               to8b(viz / dmax if dmax > 0 else viz))
        if save_depth and disps and save_directory is not None:
            np.save(os.path.join(save_directory, "disp.npy"), np.stack(disps))
        return np.stack(rgbs) if rgbs else np.zeros((0, H, W, 3), np.float32)
