"""Fused backward of the NeRF MLP (kernel B2), its plain version, and the
trainable op that pairs it with the forward kernel B1.

Counterpart of ``nerf_shared_tpu/ops/pallas/fused_mlp_bwd.py``:

- ``fused_mlp_backward(params, cfg, pts, viewdirs, g)``: the gradient of
  ``sum(apply_nerf(params, cfg, pts, viewdirs) * g)`` with respect to every
  parameter (a name -> tensor dict in the state-dict layout), the points
  (``dpts`` [..., S, 3]) and the view directions (``ddirs`` [..., 3],
  summed over the samples of each ray; None without a viewdir head). On a
  CUDA tensor it launches ``csrc/fused_mlp_bwd.cu``, which rematerialises
  the forward per tile and sums the weight gradients over tiles in fp32; on
  a CPU tensor it is ``plain_mlp_backward``, autograd of ``apply_nerf``.
- ``fused_train_op(params, cfg, pts, viewdirs)``: an ``autograd.Function``
  whose forward launches B1 and whose backward launches B2, the training
  path's network evaluation (``render/renderer.py`` under
  ``RenderConfig.fused_backward``). On CPU tensors it is ``apply_nerf``.

The wrapper packs a second copy of the weights in PyTorch's [out, in]
layout for the input-gradient products, split where the network
concatenates (the skip input, the view-direction input), and allocates the
kernel's scratch: a private partial copy of all gradients per block and a
per-block store of one tile's activations.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from nerf_shared_tpu_torch.models.nerf import NeRFConfig, apply_nerf, torch_param_order
from nerf_shared_tpu_torch.ops.cuda import common
from nerf_shared_tpu_torch.ops.cuda.fused_mlp import (
    MAX_LAYERS,
    _round4,
    check_points,
    encoder_buffer,
    flops_per_point,
    launch_points,
    out_channels,
    pack_network,
    packed_layout,
)

LAUNCHES = 0      # B2 launches made by fused_mlp_backward and fused_train_op
TILE_P = 64       # points per tile (csrc/mlp_tile.cuh)
MAX_SMEM = 232448  # shared memory one block may use on sm_90
BW_ALPHA, BW_FEATURE, BW_VIEWS_F, BW_VIEWS_D, BW_RGB, BW_OUTPUT = range(6)


def plain_mlp_backward(params, cfg: NeRFConfig, pts, viewdirs, g):
    """The plain version: autograd of ``apply_nerf`` -> (grads, dpts,
    ddirs)."""
    names = torch_param_order(cfg)
    with torch.enable_grad():
        w = [params[k].detach().requires_grad_(True) for k in names]
        pt = pts.detach().requires_grad_(True)
        vd = None if viewdirs is None else viewdirs.detach().requires_grad_(True)
        raw = apply_nerf(dict(zip(names, w)), cfg, pt, vd)
        ins = w + [pt] + ([vd] if vd is not None else [])
        gs = torch.autograd.grad(raw, ins, g)
    n = len(names)
    return dict(zip(names, gs[:n])), gs[n], (gs[n + 1] if vd is not None else None)


def pack_backward(params, cfg: NeRFConfig, device):
    """(wbt, bdesc): the weights in PyTorch's [out, in] layout, split where
    the input is a concatenation, each segment's rows padded to a multiple
    of 4 floats; bdesc is the int64 BwdDesc of csrc/fused_mlp_bwd.cu
    ({offset, row stride} per segment, -1 where there is none)."""
    P, W = cfg.input_ch, cfg.W
    seg = np.full((MAX_LAYERS, 2, 2), -1, np.int64)
    head = np.full((6, 2), -1, np.int64)
    pieces, off = [], 0

    def add(t):
        nonlocal off
        t = t.detach()
        ld = _round4(t.shape[1])
        pieces.append(F.pad(t, (0, ld - t.shape[1])).reshape(-1))
        start, off = off, off + pieces[-1].numel()
        return start, ld

    for i in range(cfg.D):
        w = params[f"pts_linears.{i}.weight"]
        if i == 0:
            seg[0, 0] = add(w)
        elif (i - 1) in cfg.skips:
            seg[i, 0], seg[i, 1] = add(w[:, :P]), add(w[:, P:])
        else:
            seg[i, 1] = add(w)
    if cfg.use_viewdirs:
        wv = params["views_linears.0.weight"]
        head[BW_ALPHA] = add(params["alpha_linear.weight"])
        head[BW_FEATURE] = add(params["feature_linear.weight"])
        head[BW_VIEWS_F], head[BW_VIEWS_D] = add(wv[:, :W]), add(wv[:, W:])
        head[BW_RGB] = add(params["rgb_linear.weight"])
    else:
        head[BW_OUTPUT] = add(params["output_linear.weight"])
    bdesc = np.concatenate([seg.reshape(-1), head.reshape(-1)])
    return torch.cat(pieces).contiguous(), common.upload(bdesc, device)


def unpack_grads(grads: torch.Tensor, cfg: NeRFConfig) -> Dict[str, torch.Tensor]:
    """The kernel's packed [in, ld] gradient buffer -> state-dict layout."""
    layout, _ = packed_layout(cfg)
    out = {}
    for name, (off, rows, cols, ld) in layout.items():
        t = grads[off:off + rows * ld].view(rows, ld)[:, :cols]
        out[name] = t.t().contiguous() if name.endswith(".weight") else t[0].contiguous()
    return out


def smem_bytes(cfg: NeRFConfig) -> int:
    """Shared memory of one B2 block: csrc/fused_mlp_bwd.cu bwd_smem_floats
    plus the NetDesc and BwdDesc it keeps in static shared memory."""
    HS = _round4(cfg.W)
    ES = _round4(cfg.input_ch) + _round4(cfg.input_ch_views)
    floats = 16 * 256 + 2 * TILE_P * HS + 2 * TILE_P * ES + TILE_P * 8
    desc_bytes = 8 * (16 + MAX_LAYERS * 4 + 20) + 256 + 8 * (MAX_LAYERS * 4 + 12)
    return 4 * floats + desc_bytes


_ARGS = ([ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 2
         + [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 4
         + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p])


def launch_backward(params, cfg: NeRFConfig, pts, viewdirs, g):
    """Kernel B2 on CUDA tensors -> (grads, dpts, ddirs)."""
    global LAUNCHES
    dev = pts.device
    n, S = check_points(cfg, pts, viewdirs)
    common.check_tensor(g, "g", tuple(pts.shape[:-1]) + (out_channels(cfg),), dev)
    if smem_bytes(cfg) > MAX_SMEM:
        raise ValueError(f"B2 needs {smem_bytes(cfg)} bytes of shared memory "
                         f"per block at this width, more than {MAX_SMEM}")
    layout, wsize = packed_layout(cfg)
    dx = torch.empty((n, 6), dtype=torch.float32, device=dev)
    if n == 0:
        return ({k: torch.zeros_like(params[k]) for k in layout}, pts.new_zeros(pts.shape),
                None if viewdirs is None else torch.zeros_like(viewdirs))
    fn = common.load("fused_mlp_bwd", _ARGS, "nstt_mlp_backward")
    with torch.cuda.device(dev):
        wbuf, desc, HS, ES = pack_network(params, cfg, dev)
        wbt, bdesc = pack_backward(params, cfg, dev)
        enc = encoder_buffer(cfg, dev)
        n_tiles = -(-n // TILE_P)
        grid = min(n_tiles, torch.cuda.get_device_properties(dev).multi_processor_count)
        part = torch.empty(grid * wsize, dtype=torch.float32, device=dev)
        act = torch.empty(grid * (cfg.D + 2) * TILE_P * HS, dtype=torch.float32,
                          device=dev)
        grads = torch.empty(wsize, dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(desc.data_ptr(), bdesc.data_ptr(), HS, ES, wbuf.data_ptr(),
                wbt.data_ptr(), enc.data_ptr(), pts.data_ptr(),
                viewdirs.data_ptr() if viewdirs is not None else 0,
                g.data_ptr(), out_channels(cfg), dx.data_ptr(), part.data_ptr(),
                act.data_ptr(), grads.data_ptr(), wsize, n, S, grid, stream)
    common.check_launch(rc, "fused_mlp_bwd (B2)")
    LAUNCHES += 1
    dpts = dx[:, :3].reshape(pts.shape)
    ddirs = None
    if viewdirs is not None:
        ddirs = dx[:, 3:].reshape(pts.shape).sum(dim=-2)
    return unpack_grads(grads, cfg), dpts, ddirs


def fused_mlp_backward(params, cfg: NeRFConfig, pts, viewdirs: Optional[torch.Tensor], g):
    """(grads, dpts, ddirs) of sum(raw * g): the plain version for CPU
    tensors, kernel B2 for CUDA tensors."""
    if pts.device.type == "cpu":
        return plain_mlp_backward(params, cfg, pts, viewdirs, g)
    if pts.device.type != "cuda":
        raise ValueError(f"fused_mlp_backward: no kernel for {pts.device}")
    return launch_backward(params, cfg, pts.contiguous(),
                           None if viewdirs is None else viewdirs.contiguous(),
                           g.contiguous())


class _TrainFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, names, pts, viewdirs, *weights):
        ctx.cfg, ctx.names = cfg, names
        ctx.save_for_backward(pts, viewdirs, *weights)
        return launch_points(dict(zip(names, weights)), cfg, pts, viewdirs)

    @staticmethod
    def backward(ctx, g):
        pts, viewdirs, *weights = ctx.saved_tensors
        grads, dpts, ddirs = launch_backward(dict(zip(ctx.names, weights)), ctx.cfg,
                                             pts, viewdirs, g.contiguous())
        need = ctx.needs_input_grad
        return (None, None, dpts if need[2] else None,
                ddirs if need[3] else None, *[grads[k] for k in ctx.names])


def fused_train_op(params, cfg: NeRFConfig, pts, viewdirs: Optional[torch.Tensor]):
    """raw [..., S, C] whose forward is B1 and whose backward is B2 on CUDA
    tensors; ``apply_nerf`` (forward and autograd backward) on CPU
    tensors."""
    if pts.device.type == "cpu":
        return apply_nerf(params, cfg, pts, viewdirs)
    if pts.device.type != "cuda":
        raise ValueError(f"fused_train_op: no kernel for {pts.device}")
    names = tuple(torch_param_order(cfg))
    return _TrainFn.apply(cfg, names, pts.contiguous(),
                          None if viewdirs is None else viewdirs.contiguous(),
                          *[params[k] for k in names])


def flops_per_point_bwd(cfg: NeRFConfig) -> int:
    """Multiply-adds x 2 of B2 for one point, counted from the layer shapes:
    the forward again without the narrow output layers (their outputs are
    not needed), the input-gradient product of every layer and the
    weight-gradient product of every layer."""
    W = cfg.W
    narrow = W * 1 + (W // 2) * 3 if cfg.use_viewdirs else W * cfg.output_ch
    macs = flops_per_point(cfg) // 2
    return 2 * (3 * macs - narrow)
