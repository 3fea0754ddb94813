"""The training step: sample, render, loss, backward, Adam.

Counterpart of ``pack_ray_batch``, ``nerf_loss`` and the single-device
path of ``make_fused_train_step`` in ``nerf_shared_tpu/train/step.py``.
Loss semantics are the reference's (main.py:85-104): MSE of the fine render
against the target pixels plus the coarse render's MSE when the hierarchy
is on, and ``acc_reg`` > 0 adds acc_reg * mean(log(1 + 2 sigma^2)) over the
sampled densities of both passes. ``tv_reg`` > 0 adds the total variation
of the triplane feature planes of both branches (a no-op for the other
families). Under ``RenderConfig.proposal`` there is no coarse MSE: the
interlevel loss (ops/compositing.py), weighted by ``prop_reg``, trains the
proposal network to bound the fine histogram; ``dist_reg`` > 0 adds the
distortion loss over the final pass's weights. ``coarse_weight`` scales
the coarse MSE: 1 in the reference, mip-NeRF's ``coarse_loss_mult`` 0.1
under ``--model_type mipnerf``, whose rays also carry their cone radii
(``pack_ray_batch``; ops/rays.cone_radii, from each pixel's direction and
the direction of the pixel one row below).

PyTorch runs eagerly, so a step is a sequence of launches, not one compiled
program: there is no superstep scan. Under ``RenderConfig.fused_backward``
the networks run through
``fused_train_op`` (kernel B1 forward, kernel B2 backward). The loss and
the aux values stay on the device; the caller fetches them when it logs.

The per-image groups of the state (train/state.py) and BARF:

- pose twists (--refine_poses): the step builds its rays from
  ``apply_pose_twists(twists, poses)`` inside autograd, the twists gated
  to zero before ``pose_start`` and image 0's pinned by ``pose_anchor``,
  so the loss reaches them through rays_o / rays_d (and, on the card,
  through B2's point and direction gradients). Without twists the rays
  are built as before, from the same draws.
- appearance (--appearance): ``nerf_loss`` maps every pass's composited
  colour through the drawn image's correction, image 0's pinned to the
  identity (the JAX step's ``appearance_anchor`` default, which its
  trainer never changes).
- BARF (``barf_end`` > 0): the networks render with the weights annealed
  at progress clip((step - barf_start) / max(1, barf_end - barf_start),
  0, 1) (models/nerf.anneal_nerf_params).

Two more options of the JAX step, both on the device with no host read:

- ``loss_sampling`` (a LossSamplingSpec, --loss_sampling): the tail of the
  batch is drawn from ``state.loss_map`` (train/loss_sampling.py) with the
  render's device generator, and after the backward the step's per-ray
  errors are blended into the map.
- ``ema_decay`` > 0 (--ema_decay): after Adam, ``state.update_ema``.

Data-parallel (``world``, parallel/distributed.py: the counterpart of
``make_fused_train_step(mesh=)``): each rank draws ceil(N_rand / n) rays
from its own generator (the trainer seeds rank r's from (seed, r)), the
gradients of every group are mean-reduced before Adam, the aux values are
mean-reduced with ``psnr`` / ``psnr0`` recomputed from the mean MSE, the
loss map adds the sum of the ranks' deltas, and the EMA needs no
collective (the parameters are equal on every rank after Adam). With one
rank the step is the unsharded step bit for bit.

Under a profiler the step records a ``train_step`` span (unit: the step)
around four phases, ``train_step.draw`` (pixels, rays, parameters),
``.forward`` (``nerf_loss``), ``.backward`` (autograd and the loss map)
and ``.adam`` (the gradient all-reduce under ``world``, Adam, the EMA;
utils/profiling.py).
"""

from __future__ import annotations

from typing import Dict, Optional

import dataclasses

import torch
import torch.nn.functional as F

from nerf_shared_tpu_torch.models.nerf import anneal_nerf_params
from nerf_shared_tpu_torch.ops.compositing import distortion_loss, interlevel_loss
from nerf_shared_tpu_torch.ops.rays import cone_radii, ndc_rays
from nerf_shared_tpu_torch.parallel.distributed import (
    World,
    all_reduce_grads,
    all_reduce_mean,
    all_reduce_sum,
)
from nerf_shared_tpu_torch.render.renderer import RenderConfig, render_rays
from nerf_shared_tpu_torch.train.appearance import anchor_appearance, apply_appearance
from nerf_shared_tpu_torch.train.loss_sampling import (
    LossSamplingSpec,
    update_loss_map,
    weighted_tail,
)
from nerf_shared_tpu_torch.train.pipeline import (
    PixelSamplerSpec,
    pixel_dirs,
    pixel_rays,
    sample_pixels,
)
from nerf_shared_tpu_torch.train.pose_refine import apply_pose_twists
from nerf_shared_tpu_torch.train.state import TrainState
from nerf_shared_tpu_torch.utils.metrics import img2mse, mse2psnr
from nerf_shared_tpu_torch.utils.profiling import span


def pack_ray_batch(rays_o, rays_d, rcfg: RenderConfig, H: int, W: int,
                   focal: float, radii: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flat [N, 8|11] ray tensor [o, d, near, far(, viewdirs)] (reference
    render_utils.py:205-226); under ``rcfg.mip`` [N, 12], the cone
    ``radii`` [N, 1] after far."""
    if rcfg.mip and radii is None:
        raise ValueError("mip-NeRF's rays carry their cone radii")
    if rcfg.use_viewdirs:
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    if rcfg.ndc:
        rays_o, rays_d = ndc_rays(H, W, focal, 1.0, rays_o, rays_d)
    near = torch.full_like(rays_d[..., :1], rcfg.near)
    far = torch.full_like(rays_d[..., :1], rcfg.far)
    parts = [rays_o, rays_d, near, far] + ([radii] if rcfg.mip else [])
    if rcfg.use_viewdirs:
        parts.append(viewdirs)
    return torch.cat(parts, dim=-1)


def nerf_loss(params: Dict, ray_batch, target, rcfg: RenderConfig, ccfg, fcfg,
              acc_reg: float = 0.0, dist_reg: float = 0.0, tv_reg: float = 0.0,
              overrides: Optional[Dict[str, torch.Tensor]] = None,
              generator: Optional[torch.Generator] = None,
              appearance: Optional[Dict[str, torch.Tensor]] = None,
              img_idx: Optional[torch.Tensor] = None, prop_reg: float = 1.0,
              return_ray_err: bool = False, coarse_weight: float = 1.0):
    """(loss, aux): loss = mse(fine, target) [+ coarse_weight * mse(coarse, target)]
    [+ prop_reg * interlevel] [+ dist_reg * distortion] [+ acc_reg *
    sparsity] [+ tv_reg * tv]; ``params`` is {"coarse": state dict, "fine":
    state dict or absent}; ``overrides`` pins the render's draws.
    ``appearance`` ({"gain", "offset"}) with ``img_idx`` (each ray's train
    image) corrects every pass's colour before its mse. ``return_ray_err``
    adds aux["ray_err"], each ray's squared error (detached) for the loss
    map."""
    ret = render_rays(params["coarse"], params.get("fine"), ray_batch, rcfg, ccfg,
                      fcfg, retraw=acc_reg > 0.0, retraw_coarse=acc_reg > 0.0,
                      retweights=rcfg.proposal or dist_reg > 0.0,
                      overrides=overrides, generator=generator)
    if appearance is not None:
        ret["rgb_map"] = apply_appearance(appearance, img_idx, ret["rgb_map"])
        if "rgb0" in ret:
            ret["rgb0"] = apply_appearance(appearance, img_idx, ret["rgb0"])
    img_loss = img2mse(ret["rgb_map"], target)
    loss = img_loss
    aux = {"img_loss": img_loss, "psnr": mse2psnr(img_loss)}
    if return_ray_err:
        aux["ray_err"] = torch.mean((ret["rgb_map"] - target) ** 2, dim=-1).detach()
    if "weights0" in ret:
        prop_loss = interlevel_loss(ret["z_vals0"], ret["weights0"], ret["z_vals"],
                                    ret["weights"])
        loss = loss + prop_reg * prop_loss
        aux["prop_loss"] = prop_loss
    if dist_reg > 0.0:
        dist_loss = distortion_loss(ret["z_vals"], ret["weights"], rcfg.near, rcfg.far)
        loss = loss + dist_reg * dist_loss
        aux["dist_loss"] = dist_loss
    if "rgb0" in ret:
        img_loss0 = img2mse(ret["rgb0"], target)
        loss = loss + coarse_weight * img_loss0
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


def barf_progress(step: int, barf_start: int, barf_end: int) -> torch.Tensor:
    """BARF's progress at ``step`` as the JAX step computes it: the float32
    quotient (step - start) / max(1, end - start), clipped to [0, 1]."""
    denom = float(max(1, barf_end - barf_start))
    q = torch.tensor(float(step - barf_start), dtype=torch.float32) / denom
    return torch.clamp(q, 0.0, 1.0)


def anneal_branches(params: Dict, ccfg, fcfg, progress) -> Dict:
    """{"coarse", "fine"} state dicts with the BARF mask of ``progress``."""
    out = dict(params)
    out["coarse"] = anneal_nerf_params(params["coarse"], ccfg, progress)
    if fcfg is not None and "fine" in params:
        out["fine"] = anneal_nerf_params(params["fine"], fcfg, progress)
    return out


def refined_poses(twists: torch.Tensor, poses: torch.Tensor, step: int,
                  pose_start: int = 0, pose_anchor: bool = True) -> torch.Tensor:
    """The poses the step's rays come from under --refine_poses: the twists
    gated to zero while step < ``pose_start`` and, with ``pose_anchor``,
    image 0's pinned to identity (both by masks, so their gradient is 0),
    applied to ``poses``."""
    if pose_start > 0:
        twists = twists * float(step >= pose_start)
    if pose_anchor:
        mask = torch.ones((twists.shape[0], 1), dtype=twists.dtype, device=twists.device)
        mask[0, 0] = 0.0
        twists = twists * mask
    return apply_pose_twists(twists, poses)


def make_train_step(rcfg: RenderConfig, ccfg, fcfg, spec: PixelSamplerSpec,
                    acc_reg: float = 0.0, tv_reg: float = 0.0,
                    pose_anchor: bool = True, pose_start: int = 0,
                    barf_end: int = 0, barf_start: int = 0, prop_reg: float = 1.0,
                    dist_reg: float = 0.0,
                    loss_sampling: Optional[LossSamplingSpec] = None,
                    ema_decay: float = 0.0, world: Optional[World] = None,
                    coarse_weight: float = 1.0):
    """``train_step(state, images, poses, generator, draws=None,
    overrides=None) -> aux``: one iteration on ``state`` in place.

    ``generator`` is the run's CPU torch.Generator: it draws the step's
    pixels (train/pipeline.py) and the seed of the render's device-side
    draws (stratified jitter, inverse-CDF u, sigma noise; under
    ``loss_sampling`` first the weighted tail's tile uniforms and jitter).
    ``draws`` / ``overrides`` pin them for tests. The state's pose twists
    and appearance corrections, when it has them, and ``barf_end`` > 0 act
    as the module docstring says; aux then carries ``twist_norm`` /
    ``gain_norm`` (the RMS of the raw twists / gains). ``loss_sampling``
    needs ``state.loss_map`` and ``ema_decay`` > 0 ``state.ema``. With
    ``world`` the step is data-parallel (module docstring);
    ``coarse_weight`` scales the coarse MSE."""
    if loss_sampling is not None and not spec.single_image:
        raise ValueError(
            "--loss_sampling targets single-image sampling (no_batching); "
            "the batching pipeline draws across all images per step and "
            "would need a per-ray CDF per image")
    spec = local_spec(spec, world)
    rank, n_ranks = (0, 1) if world is None else (world.rank, world.size)

    def train_step(state: TrainState, images, poses, generator: torch.Generator,
                   draws: Optional[Dict] = None,
                   overrides: Optional[Dict[str, torch.Tensor]] = None):
        with span("train_step", state.step):
            with span("train_step.draw"):
                img_idx, y, x = sample_pixels(generator, images.shape[0], state.step, spec,
                                              draws, rank, n_ranks)
                render_gen = torch.Generator(device=images.device)
                render_gen.manual_seed(int(torch.randint(0, 1 << 62, (), generator=generator)))
                if loss_sampling is not None:
                    y, x = weighted_tail(img_idx, y, x, state.step, spec, state.loss_map,
                                         loss_sampling, render_gen, draws)
                if state.pose_twists is not None:
                    poses = refined_poses(state.pose_twists, poses, state.step,
                                          pose_start, pose_anchor)
                rays_o, rays_d, target = pixel_rays(images, poses, spec, img_idx, y, x)
                radii = None
                if rcfg.mip:
                    radii = cone_radii(rays_d, pixel_dirs(poses, spec, img_idx, y + 1, x))
                ray_batch = pack_ray_batch(rays_o, rays_d, rcfg, spec.H, spec.W, spec.fx,
                                           radii)
                params = {b: m.params() for b, m in state.branches()}
                if barf_end > 0:
                    params = anneal_branches(params, ccfg, fcfg,
                                             barf_progress(state.step, barf_start, barf_end))
                app = state.appearance
                if app is not None:
                    app = anchor_appearance(app)
            with span("train_step.forward"):
                loss, aux = nerf_loss(params, ray_batch, target, rcfg, ccfg, fcfg,
                                      acc_reg=acc_reg, tv_reg=tv_reg, prop_reg=prop_reg,
                                      dist_reg=dist_reg, overrides=overrides,
                                      generator=render_gen, appearance=app,
                                      img_idx=None if app is None else img_idx.to(images.device),
                                      return_ray_err=loss_sampling is not None,
                                      coarse_weight=coarse_weight)
                if state.appearance is not None:
                    aux["gain_norm"] = torch.sqrt(torch.mean(state.appearance["gain"] ** 2))
                if state.pose_twists is not None:
                    aux["twist_norm"] = torch.sqrt(torch.mean(state.pose_twists ** 2))
            with span("train_step.backward"):
                state.optimizer.zero_grad(set_to_none=True)
                loss.backward()
                if loss_sampling is not None:
                    before = state.loss_map.clone() if n_ranks > 1 else None
                    update_loss_map(state.loss_map, int(img_idx), y, x, aux.pop("ray_err"),
                                    loss_sampling.tile, loss_sampling.decay)
                    if before is not None:
                        # each rank updated its own image's row: add the sum of
                        # the ranks' deltas (rows two ranks drew add both)
                        state.loss_map.copy_(
                            before + all_reduce_sum(state.loss_map - before, world))
            with span("train_step.adam"):
                if world is not None:
                    all_reduce_grads(state, world)
                state.apply_gradients()
                if ema_decay > 0.0:
                    state.update_ema(ema_decay)
                aux = {k: v.detach() for k, v in aux.items()}
        return aux if world is None else reduce_aux(aux, world)

    return train_step


def local_spec(spec: PixelSamplerSpec, world: Optional[World]) -> PixelSamplerSpec:
    """The rank's share of the batch: ceil(N_rand / n) rays (a global
    N_rand the world does not divide trains the next multiple, as the JAX
    sharded step does)."""
    if world is None or world.size == 1:
        return spec
    return dataclasses.replace(spec, N_rand=-(-spec.N_rand // world.size))


def reduce_aux(aux: Dict[str, torch.Tensor], world: World) -> Dict[str, torch.Tensor]:
    """The ranks' mean of each aux value; PSNR is not linear in the MSE, so
    ``psnr`` / ``psnr0`` come from the mean ``img_loss`` / ``img_loss0``."""
    aux = all_reduce_mean(aux, world)
    aux["psnr"] = mse2psnr(aux["img_loss"])
    if "img_loss0" in aux:
        aux["psnr0"] = mse2psnr(aux["img_loss0"])
    return aux
