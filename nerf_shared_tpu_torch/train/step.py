"""The training step: sample, render, loss, backward, Adam.

Counterpart of ``pack_ray_batch``, ``nerf_loss`` and the single-device
path of ``make_fused_train_step`` in ``nerf_shared_tpu/train/step.py``.
Loss semantics are the reference's (main.py:85-104): MSE of the fine render
against the target pixels plus the coarse render's MSE when the hierarchy
is on, and ``acc_reg`` > 0 adds acc_reg * mean(log(1 + 2 sigma^2)) over the
sampled densities of both passes. ``tv_reg`` > 0 adds the total variation
of the triplane feature planes of both branches (a no-op for the other
families).

PyTorch runs eagerly, so a step is a sequence of launches, not one compiled
program: there is no superstep scan and no sharded variant (ROADMAP A16).
Under ``RenderConfig.fused_backward`` the networks run through
``fused_train_op`` (kernel B1 forward, kernel B2 backward). The loss and
the aux values stay on the device; the caller fetches them when it logs.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from nerf_shared_tpu_torch.ops.rays import ndc_rays
from nerf_shared_tpu_torch.render.renderer import RenderConfig, render_rays
from nerf_shared_tpu_torch.train.pipeline import PixelSamplerSpec, sample_ray_batch
from nerf_shared_tpu_torch.train.state import TrainState
from nerf_shared_tpu_torch.utils.metrics import img2mse, mse2psnr


def pack_ray_batch(rays_o, rays_d, rcfg: RenderConfig, H: int, W: int,
                   focal: float) -> torch.Tensor:
    """Flat [N, 8|11] ray tensor [o, d, near, far(, viewdirs)] (reference
    render_utils.py:205-226)."""
    if rcfg.use_viewdirs:
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    if rcfg.ndc:
        rays_o, rays_d = ndc_rays(H, W, focal, 1.0, rays_o, rays_d)
    near = torch.full_like(rays_d[..., :1], rcfg.near)
    far = torch.full_like(rays_d[..., :1], rcfg.far)
    parts = [rays_o, rays_d, near, far]
    if rcfg.use_viewdirs:
        parts.append(viewdirs)
    return torch.cat(parts, dim=-1)


def nerf_loss(params: Dict, ray_batch, target, rcfg: RenderConfig, ccfg, fcfg,
              acc_reg: float = 0.0, dist_reg: float = 0.0, tv_reg: float = 0.0,
              overrides: Optional[Dict[str, torch.Tensor]] = None,
              generator: Optional[torch.Generator] = None):
    """(loss, aux): loss = mse(fine, target) [+ mse(coarse, target)]
    [+ acc_reg * sparsity] [+ tv_reg * tv]; ``params`` is {"coarse": state
    dict, "fine": state dict or absent}; ``overrides`` pins the render's
    draws."""
    if dist_reg > 0.0:
        raise NotImplementedError(
            "the distortion loss is not ported to nerf_shared_tpu_torch yet: "
            "ROADMAP A11")
    ret = render_rays(params["coarse"], params.get("fine"), ray_batch, rcfg, ccfg,
                      fcfg, retraw=acc_reg > 0.0, retraw_coarse=acc_reg > 0.0,
                      overrides=overrides, generator=generator)
    img_loss = img2mse(ret["rgb_map"], target)
    loss = img_loss
    aux = {"img_loss": img_loss, "psnr": mse2psnr(img_loss)}
    if "rgb0" in ret:
        img_loss0 = img2mse(ret["rgb0"], target)
        loss = loss + img_loss0
        aux["img_loss0"] = img_loss0
        aux["psnr0"] = mse2psnr(img_loss0)
    if acc_reg > 0.0:
        sparsity = torch.mean(torch.log1p(2.0 * F.relu(ret["raw"][..., 3]) ** 2))
        if "raw0" in ret:
            sparsity = sparsity + torch.mean(
                torch.log1p(2.0 * F.relu(ret["raw0"][..., 3]) ** 2))
        loss = loss + acc_reg * sparsity
        aux["acc_mean"] = torch.mean(ret["acc_map"])
    if tv_reg > 0.0:
        # total variation over the feature planes [3, G, G, W] (TensoRF /
        # DVGO practice against floaters)
        tv = 0.0
        for branch in ("coarse", "fine"):
            pl = (params.get(branch) or {}).get("planes")
            if pl is not None:
                tv = tv + torch.mean((pl[:, 1:] - pl[:, :-1]) ** 2) \
                    + torch.mean((pl[:, :, 1:] - pl[:, :, :-1]) ** 2)
        loss = loss + tv_reg * tv
        aux["tv"] = torch.as_tensor(tv)
    aux["loss"] = loss
    return loss, aux


# trainer options of the JAX step that this port does not carry yet
_STEP_NOT_PORTED = {
    "dist_reg": "the distortion loss (ROADMAP A11)",
    "barf_end": "BARF annealing (ROADMAP A11)",
    "pose_twists": "pose refinement (ROADMAP A11)",
    "appearance": "per-image appearance (ROADMAP A11)",
    "loss_sampling": "loss-guided sampling (ROADMAP A11)",
}


def make_train_step(rcfg: RenderConfig, ccfg, fcfg, spec: PixelSamplerSpec,
                    acc_reg: float = 0.0, tv_reg: float = 0.0, **not_ported):
    """``train_step(state, images, poses, generator, draws=None,
    overrides=None) -> aux``: one iteration on ``state`` in place.

    ``generator`` is the run's CPU torch.Generator: it draws the step's
    pixels (train/pipeline.py) and the seed of the render's device-side
    draws (stratified jitter, inverse-CDF u, sigma noise). ``draws`` /
    ``overrides`` pin them for tests."""
    for name, value in not_ported.items():
        if name not in _STEP_NOT_PORTED:
            raise TypeError(f"make_train_step: unknown option {name}")
        if value:
            raise NotImplementedError(
                f"{_STEP_NOT_PORTED[name]} is not ported to nerf_shared_tpu_torch yet")

    def train_step(state: TrainState, images, poses, generator: torch.Generator,
                   draws: Optional[Dict] = None,
                   overrides: Optional[Dict[str, torch.Tensor]] = None):
        rays_o, rays_d, target = sample_ray_batch(generator, images, poses,
                                                  state.step, spec, draws)
        ray_batch = pack_ray_batch(rays_o, rays_d, rcfg, spec.H, spec.W, spec.fx)
        render_gen = torch.Generator(device=images.device)
        render_gen.manual_seed(int(torch.randint(0, 1 << 62, (), generator=generator)))
        params = {b: m.params() for b, m in state.branches()}
        loss, aux = nerf_loss(params, ray_batch, target, rcfg, ccfg, fcfg,
                              acc_reg=acc_reg, tv_reg=tv_reg, overrides=overrides,
                              generator=render_gen)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.apply_gradients()
        return {k: v.detach() for k, v in aux.items()}

    return train_step
