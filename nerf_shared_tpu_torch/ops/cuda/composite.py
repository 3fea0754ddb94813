"""Alpha compositing of raw network outputs (kernel B5) and its plain version.

Counterpart of ``composite_fused`` in ``nerf_shared_tpu/ops/pallas/composite.py``:
``raw2outputs`` without sigma noise. The kernel (``csrc/composite.cu``) reads
the ray-major raw [N, S, C] that B3 writes, with no transpose, and writes the
per-ray maps and, when asked, the compositing weights. Returns the
raw2outputs tuple (rgb [N,3], disp [N], acc [N], weights [N,S] or a
zero-width placeholder, depth [N]).

On a CPU tensor ``composite_fused`` is the plain version; on a CUDA tensor it
launches B5 or raises. The gradient recomputes through the plain version
(remat), as the JAX custom_vjp does.
"""

from __future__ import annotations

import ctypes

import torch

from nerf_shared_tpu_torch.ops.compositing import raw2outputs
from nerf_shared_tpu_torch.ops.cuda import common

LAUNCHES = 0  # kernel launches made by composite_fused


def plain_composite(raw, z_vals, rays_d, white_bkgd: bool = False):
    """The plain PyTorch version: raw2outputs without sigma noise."""
    return raw2outputs(raw, z_vals, rays_d, white_bkgd=white_bkgd)


def _check(raw, z_vals, rays_d):
    dev = raw.device
    if z_vals.dim() != 2:
        raise ValueError(f"z_vals has shape {tuple(z_vals.shape)}, expected [N, S]")
    n, S = z_vals.shape
    if S < 1:
        raise ValueError("compositing needs at least one sample per ray")
    if raw.dim() != 3 or raw.shape[2] < 4:
        raise ValueError(f"raw has shape {tuple(raw.shape)}, expected [N, S, >=4]")
    common.check_tensor(raw, "raw", (n, S, None), dev)
    common.check_tensor(z_vals, "z_vals", (n, S), dev)
    common.check_tensor(rays_d, "rays_d", (n, 3), dev)
    return n, S


_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_void_p]


def _launch(raw, z_vals, rays_d, white_bkgd, want_weights):
    global LAUNCHES
    n, S = _check(raw, z_vals, rays_d)
    out8 = torch.empty((n, 8), dtype=torch.float32, device=raw.device)
    weights = torch.empty((n, S if want_weights else 0), dtype=torch.float32,
                          device=raw.device)
    if n == 0:
        return out8, weights
    fn = common.load("composite", _ARGS, "nstt_composite")
    with torch.cuda.device(raw.device):
        stream = torch.cuda.current_stream(raw.device).cuda_stream
        rc = fn(raw.data_ptr(), z_vals.data_ptr(), rays_d.data_ptr(),
                out8.data_ptr(), weights.data_ptr() if want_weights else 0, n, S,
                raw.shape[2], int(white_bkgd), stream)
    common.check_launch(rc, "composite (B5)")
    LAUNCHES += 1
    common.check_finite("B5", "composite_fused", "output", out8=out8, weights=weights)
    return out8, weights


class _CompositeFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, white_bkgd, want_weights, raw, z_vals, rays_d):
        ctx.n_lead = 2
        ctx.white_bkgd, ctx.want_weights = white_bkgd, want_weights
        ctx.save_for_backward(raw, z_vals, rays_d)
        return _launch(raw, z_vals, rays_d, white_bkgd, want_weights)

    @staticmethod
    def backward(ctx, g_out8, g_w):
        def plain(raw, z_vals, rays_d):
            rgb, disp, acc, w, depth = plain_composite(raw, z_vals, rays_d,
                                                       ctx.white_bkgd)
            return (common.pack8(rgb, disp, acc, depth),
                    w if ctx.want_weights else w[:, :0])

        grads = common.remat_grads(ctx, plain, ctx.saved_tensors, (g_out8, g_w))
        return (None, None, *grads)


def composite_fused(raw, z_vals, rays_d, white_bkgd: bool = False,
                    want_weights: bool = True):
    """(rgb, disp, acc, weights, depth) of the noise-free composite: the
    plain version for CPU tensors, kernel B5 for CUDA tensors (contiguous
    float32 raw [N, S, >=4], z_vals [N, S], rays_d [N, 3])."""
    common.check_finite("B5", "composite_fused", "input", raw=raw, z_vals=z_vals,
                        rays_d=rays_d)
    if raw.device.type == "cpu":
        rgb, disp, acc, w, depth = plain_composite(raw, z_vals, rays_d, white_bkgd)
        common.check_finite("B5", "composite_fused", "output", rgb=rgb, disp=disp, acc=acc,
                            weights=w, depth=depth)
        return rgb, disp, acc, (w if want_weights else w[:, :0]), depth
    if raw.device.type != "cuda":
        raise ValueError(f"composite_fused: no kernel for {raw.device}")
    out8, w = _CompositeFn.apply(bool(white_bkgd), bool(want_weights), raw,
                                 z_vals, rays_d)
    return out8[:, 0:3], out8[:, 3], out8[:, 4], w, out8[:, 5]


def bytes_moved(n_rays: int, S: int) -> int:
    """Bytes B5 must move: raw (4 channels), z and the weights per sample;
    rays_d in and the six per-ray maps out per ray."""
    return n_rays * S * (16 + 4 + 4) + n_rays * (12 + 24)
