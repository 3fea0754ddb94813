"""Fused ray-major MLP + alpha composite (kernel B4) and its plain version.

Counterpart of ``fused_render_rays`` in
``nerf_shared_tpu/ops/pallas/fused_render.py``: the B3 network followed by
``raw2outputs`` without sigma noise, in one launch
(``csrc/fused_render.cu``: B3's split-fp32 tensor-core tile, then the
cumprod composite with the transmittance carried across tiles), so only
per-ray maps and, when asked, the compositing weights reach device memory. Returns the raw2outputs tuple
(rgb [N,3], disp [N], acc [N], weights [N,S] or a zero-width placeholder,
depth [N]).

Under ``compute_dtype`` bfloat16 the network is B3's bf16 tile
(``csrc/mlp_tile_bf16.cuh``, ``fused_mlp.plain_mlp_bf16``'s arithmetic) and
the composite stays fp32;
the backward differentiates the JAX package's plain bf16 twin
(``apply_nerf`` in bf16, then ``raw2outputs``), as fused_render.py's
``_fused_render_bwd`` does.

Comparing it with the plain version at random weights: mask rays whose
last-sample |sigma| < 1e-2. The last interval is the 1e10 sentinel, so
relu(sigma_last)·1e10 flips alpha between 0 and 1 under any two fp32-valid
evaluations of the network.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from nerf_shared_tpu_torch.models.nerf import NeRFConfig, torch_param_order
from nerf_shared_tpu_torch.ops.compositing import raw2outputs
from nerf_shared_tpu_torch.ops.cuda import common
from nerf_shared_tpu_torch.ops.cuda.fused_mlp import (
    _check_rays,
    check_in,
    check_out,
    check_ray_config,
    entry_sizes,
    is_bf16,
    pack_network_tc,
    plain_nerf_forward_rays,
    ray_encoder_args,
    twin_nerf_forward_rays,
)

LAUNCHES = 0  # kernel launches made by fused_render_rays
LAUNCHES_BF16 = 0  # the same for the bf16 instantiation


def plain_render_rays(params, cfg: NeRFConfig, rays_o, rays_d, z, viewdirs,
                      white_bkgd: bool = False, compute_dtype=torch.float32):
    """The plain PyTorch version: plain B3 (at ``compute_dtype``), then
    raw2outputs in fp32."""
    raw = plain_nerf_forward_rays(params, cfg, rays_o, rays_d, z, viewdirs, compute_dtype)
    return raw2outputs(raw, z, rays_d, white_bkgd=white_bkgd)


def twin_render_rays(params, cfg: NeRFConfig, rays_o, rays_d, z, viewdirs,
                     white_bkgd: bool = False, compute_dtype=torch.float32):
    """What B4's backward differentiates: ``apply_nerf`` at the compute
    dtype, then raw2outputs (in fp32 it is B4's plain version)."""
    raw = twin_nerf_forward_rays(params, cfg, rays_o, rays_d, z, viewdirs, compute_dtype)
    return raw2outputs(raw, z, rays_d, white_bkgd=white_bkgd)


_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _launch(params, cfg, rays_o, rays_d, z, viewdirs, white_bkgd, want_weights,
            compute_dtype=torch.float32):
    global LAUNCHES, LAUNCHES_BF16
    n, S = _check_rays(cfg, rays_o, rays_d, z, viewdirs)
    if not cfg.use_viewdirs and cfg.output_ch < 4:
        raise ValueError("compositing needs >= 4 raw channels (rgb, sigma)")
    out8 = torch.empty((n, 8), dtype=torch.float32, device=z.device)
    weights = torch.empty((n, S if want_weights else 0), dtype=torch.float32,
                          device=z.device)
    if n == 0 or S == 0:
        return out8, weights
    check_in("B4", compute_dtype, "fused_render_rays", params, rays_o=rays_o, rays_d=rays_d,
             z=z, viewdirs=viewdirs)
    bf16 = is_bf16(compute_dtype)
    fn = common.load("fused_render", _ARGS,
                     "nstt_render_rays_bf16" if bf16 else "nstt_render_rays_tc")
    with torch.cuda.device(z.device):
        wbuf, desc, HS, SLOT = pack_network_tc(params, cfg, z.device, compute_dtype)
        A, B = ray_encoder_args(cfg, rays_o, rays_d, viewdirs)
        stream = torch.cuda.current_stream(z.device).cuda_stream
        rc = fn(desc.data_ptr(), *entry_sizes(cfg, bf16, HS, SLOT), wbuf.data_ptr(),
                A.data_ptr(), B.data_ptr(), z.data_ptr(), rays_d.data_ptr(), out8.data_ptr(),
                weights.data_ptr() if want_weights else 0, n, S,
                int(white_bkgd), stream)
    common.check_launch(rc, "fused_render (B4 bf16)" if bf16 else "fused_render (B4)")
    if bf16:
        LAUNCHES_BF16 += 1
    else:
        LAUNCHES += 1
    check_out("B4", compute_dtype, "fused_render_rays", out8=out8, weights=weights)
    return out8, weights


def _plain_render(params, cfg, rays_o, rays_d, z, viewdirs, white_bkgd, compute_dtype):
    """B4's plain version between its --debug_nans checks (a CPU tensor)."""
    check_in("B4", compute_dtype, "fused_render_rays", params, rays_o=rays_o, rays_d=rays_d,
             z=z, viewdirs=viewdirs)
    rgb, disp, acc, w, depth = plain_render_rays(params, cfg, rays_o, rays_d, z, viewdirs,
                                                 white_bkgd, compute_dtype)
    check_out("B4", compute_dtype, "fused_render_rays", rgb=rgb, disp=disp, acc=acc,
              weights=w, depth=depth)
    return rgb, disp, acc, w, depth


class _RenderFn(torch.autograd.Function):
    """B4 forward (on the CPU, under bf16, its plain version), backward
    through ``twin_render_rays`` at the compute dtype."""

    @staticmethod
    def forward(ctx, cfg, names, white_bkgd, want_weights, dtype, rays_o, rays_d, z,
                viewdirs, *weights):
        ctx.cfg, ctx.names, ctx.dtype, ctx.n_lead = cfg, names, dtype, 5
        ctx.white_bkgd, ctx.want_weights = white_bkgd, want_weights
        ctx.save_for_backward(rays_o, rays_d, z, viewdirs, *weights)
        params = dict(zip(names, weights))
        if rays_o.device.type == "cpu":
            rgb, disp, acc, w, depth = _plain_render(params, cfg, rays_o, rays_d, z, viewdirs,
                                                     white_bkgd, dtype)
            return common.pack8(rgb, disp, acc, depth), (w if want_weights else w[:, :0])
        return _launch(params, cfg, rays_o, rays_d, z, viewdirs, white_bkgd,
                       want_weights, dtype)

    @staticmethod
    def backward(ctx, g_out8, g_w):
        cfg, names = ctx.cfg, ctx.names

        def twin(ro, rd, zz, vd, *w):
            rgb, disp, acc, wts, depth = twin_render_rays(
                dict(zip(names, w)), cfg, ro, rd, zz, vd, ctx.white_bkgd, ctx.dtype)
            return (common.pack8(rgb, disp, acc, depth),
                    wts if ctx.want_weights else wts[:, :0])

        grads = common.remat_grads(ctx, twin, ctx.saved_tensors, (g_out8, g_w))
        return (None, None, None, None, None, *grads)


def fused_render_rays(params, cfg: NeRFConfig, rays_o, rays_d, z,
                      viewdirs: Optional[torch.Tensor], white_bkgd: bool = False,
                      want_weights: bool = True, compute_dtype=torch.float32):
    """(rgb, disp, acc, weights, depth) of the noise-free composite: the
    plain version for CPU tensors, kernel B4 (its bf16 instantiation under
    ``compute_dtype`` bfloat16) for CUDA tensors; an IPE config raises."""
    check_ray_config(cfg, "B4")
    if rays_o.device.type == "cpu" and not is_bf16(compute_dtype):
        rgb, disp, acc, w, depth = _plain_render(params, cfg, rays_o, rays_d, z, viewdirs,
                                                 white_bkgd, compute_dtype)
        return rgb, disp, acc, (w if want_weights else w[:, :0]), depth
    if rays_o.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_render_rays: no kernel for {rays_o.device}")
    names = tuple(torch_param_order(cfg))
    out8, w = _RenderFn.apply(cfg, names, bool(white_bkgd), bool(want_weights), compute_dtype,
                              rays_o, rays_d, z, viewdirs,
                              *[params[k] for k in names])
    return out8[:, 0:3], out8[:, 3], out8[:, 4], w, out8[:, 5]
