"""Fused encoder + NeRF MLP forward: point-major (kernel B1) and ray-major
(kernel B3), their plain versions, and the packing shared with B2 and B4.

B1 (``fused_nerf_forward``) is the counterpart of ``fused_nerf_forward`` in
``nerf_shared_tpu/ops/pallas/fused_mlp.py`` and the forward of every
training step: points [..., S, 3] and view directions [..., 3] in, raw
[..., S, C] out. The kernel encodes each point itself (f·x, rounded as the
plain ``embed`` rounds it, from ``encoder_buffer``'s table) and broadcasts
the directions per ray, so no [N, 8] input is built.

B3 (``fused_nerf_forward_rays``) is the counterpart of
``fused_nerf_forward_rays``. The kernel (``csrc/fused_mlp.cu``) takes
per-ray encoder coefficients and depths and builds the sample points
itself: for embedding column c, ``arg = A[r, c] + z[r, s] * B[r, c]`` with
``A = [o, dir][src] * f`` and ``B = [d, 0][src] * f``, then identity, sin or
cos. For power-of-two frequencies this is exactly ``f * (o + z * d)``, the
plain version's argument. A and B are computed here in PyTorch (exact: one
product per entry).

Both run the network only in the kernel, on the tensor cores in split fp32
(``csrc/mlp_tile_tc.cuh``, one tile with a point-major and a ray-major
encoder) over the weights that ``pack_network_tc`` lays out. B2 reads
``pack_network``'s layout.

Both entries dispatch on the tensors' device: on the CPU they are the plain
version, on a CUDA device they launch the kernel or raise. B1's gradient is
kernel B2 (``fused_mlp_bwd.fused_train_op``); B3's backward recomputes
through the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
import torch

from nerf_shared_tpu_torch.models.nerf import NeRFConfig, apply_nerf, torch_param_order
from nerf_shared_tpu_torch.ops.cuda import common

MAX_LAYERS, MAX_W, MAX_EMB, MAX_OUT = 32, 256, 256, 8
_DESC_WORDS = 16 + MAX_LAYERS * 4 + 5 * 4 + MAX_EMB // 8

LAUNCHES = 0        # B3 launches made by fused_nerf_forward_rays
POINT_LAUNCHES = 0  # B1 launches made by fused_nerf_forward and fused_train_op


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def out_channels(cfg: NeRFConfig) -> int:
    return 4 if cfg.use_viewdirs else cfg.output_ch


def encoder_tables(cfg: NeRFConfig):
    """Per embedding column (the layout of [γ(pts), γ(dirs)]): the input it
    reads (0-2 ray, 3-5 view direction), its frequency, and its kind
    (0 identity, 1 sin, 2 cos)."""
    src, scale, kind = [], [], []
    specs = [(0, cfg.pts_embedder)]
    if cfg.use_viewdirs:
        specs.append((3, cfg.views_embedder))
    for row0, ecfg in specs:
        for d in range(3):
            src.append(row0 + d), scale.append(1.0), kind.append(0)
        if ecfg.i_embed == -1:
            continue
        for freq in ecfg.freq_bands():
            for k in (1, 2):
                for d in range(3):
                    src.append(row0 + d), scale.append(float(freq)), kind.append(k)
    return (np.asarray(src, np.int64), np.asarray(scale, np.float32),
            np.asarray(kind, np.int8))


def ray_encoder_args(cfg: NeRFConfig, rays_o, rays_d, viewdirs):
    """A, B [N, EMB] fp32: the pre-sine argument of sample z on ray r is
    A[r] + z * B[r]."""
    src, scale, _ = encoder_tables(cfg)
    n = rays_o.shape[0]
    zeros = torch.zeros((n, 3), dtype=torch.float32, device=rays_o.device)
    vd = viewdirs if viewdirs is not None else zeros
    x_o = torch.cat([rays_o.float(), vd.float()], dim=-1)
    x_d = torch.cat([rays_d.float(), zeros], dim=-1)
    idx = common.upload(src, rays_o.device)
    sc = common.upload(scale, rays_o.device)
    return ((x_o[:, idx] * sc).contiguous(), (x_d[:, idx] * sc).contiguous())


def check_config(cfg: NeRFConfig):
    """Raise on an architecture the kernels do not take."""
    P, V = cfg.input_ch, cfg.input_ch_views
    if not 1 <= cfg.D <= MAX_LAYERS:
        raise ValueError(f"kernel takes 1..{MAX_LAYERS} layers, got D={cfg.D}")
    if not 2 <= cfg.W <= MAX_W:
        raise ValueError(f"kernel takes widths 2..{MAX_W}, got W={cfg.W}")
    if _round4(P) + _round4(V) > MAX_EMB:
        raise ValueError(f"kernel takes <= {MAX_EMB} embedding columns, "
                         f"got {P} + {V}")
    if out_channels(cfg) > MAX_OUT:
        raise ValueError(f"kernel writes <= {MAX_OUT} output channels")
    if (cfg.D - 1) in cfg.skips:
        raise ValueError("a skip after the last layer has no head to feed")


def packed_layout(cfg: NeRFConfig):
    """(layout, size): where ``pack_network`` puts each parameter. layout
    maps a state-dict name to (float offset, rows, cols, row stride): a
    weight [out, in] is stored transposed as rows = in, cols = out; a bias
    as one row. Row strides are cols rounded up to 4, so every matrix
    starts 16-byte aligned. B2 writes its gradients in the same layout."""
    names = [f"pts_linears.{i}" for i in range(cfg.D)]
    names += (["alpha_linear", "feature_linear", "views_linears.0", "rgb_linear"]
              if cfg.use_viewdirs else ["output_linear"])
    shapes = param_shapes(cfg)
    layout, off = {}, 0
    for name in names:
        out_ch, in_ch = shapes[name + ".weight"]
        for key, rows in ((name + ".weight", in_ch), (name + ".bias", 1)):
            layout[key] = (off, rows, out_ch, _round4(out_ch))
            off += rows * _round4(out_ch)
    return layout, off


def pack_network(params: Dict[str, torch.Tensor], cfg: NeRFConfig, device):
    """(weights, desc, HS, ES) for kernel B2: every matrix transposed to
    [in, out] with its row stride rounded up to 4 floats, concatenated into
    one fp32 buffer (``packed_layout``); ``desc`` is the int64 NetDesc of
    ``csrc/mlp_tile.cuh`` on ``device``."""
    device = torch.device(device)
    check_config(cfg)
    check_params(params, cfg, device)
    layout, size = packed_layout(cfg)
    wbuf = torch.zeros(size, dtype=torch.float32, device=device)
    for name, (off, rows, cols, ld) in layout.items():
        t = params[name].detach()
        t = t.t() if t.dim() == 2 else t[None]
        wbuf[off:off + rows * ld].view(rows, ld)[:, :cols] = t

    desc = np.zeros(_DESC_WORDS, np.int64)
    hdr = desc[:16]
    layers = desc[16:16 + MAX_LAYERS * 4].reshape(MAX_LAYERS, 4)
    heads = desc[16 + MAX_LAYERS * 4:16 + MAX_LAYERS * 4 + 20].reshape(5, 4)
    kind = desc[16 + MAX_LAYERS * 4 + 20:].view(np.int8)

    def matrix(name):
        w, k, _, ld = layout[name + ".weight"]
        return (w, layout[name + ".bias"][0], k, ld)

    for i in range(cfg.D):
        layers[i] = matrix(f"pts_linears.{i}")
    # head rows: HEAD_ALPHA, HEAD_FEATURE, HEAD_VIEWS, HEAD_RGB, HEAD_OUTPUT
    if cfg.use_viewdirs:
        for row, name in enumerate(("alpha_linear", "feature_linear",
                                    "views_linears.0", "rgb_linear")):
            heads[row] = matrix(name)
    else:
        heads[4] = matrix("output_linear")

    P, V = cfg.input_ch, cfg.input_ch_views
    skips = sum(1 << (i + 1) for i in cfg.skips if 0 <= i < cfg.D - 1)
    HS = _round4(cfg.W)
    hdr[:11] = (cfg.D, cfg.W, P, V, P + V, out_channels(cfg),
                int(cfg.use_viewdirs), _round4(P), _round4(V), skips, HS)
    k = encoder_tables(cfg)[2]
    kind[:k.size] = k
    return wbuf, common.upload(desc, device), HS, _round4(P) + _round4(V)


# --- the tensor-core kernels' pack (B1, B3, B4: csrc/mlp_tile_tc.cuh) --------

MAX_GEMMS, SLICE_K = MAX_LAYERS + 2, 8
SRC_PTS, SRC_H, SRC_DIRS = 0, 1, 2
_TC_DESC_WORDS = 16 + MAX_GEMMS * 8 + 3 * 4 + MAX_EMB // 8


def _round(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def padded_width(n: int) -> int:
    """A GEMM's padded output width: a power of two >= 32, so that each of
    the two warpgroups runs one wgmma of N = 16, 32, 64 or 128."""
    return max(32, 1 << (n - 1).bit_length())


def tf32_split(w: torch.Tensor):
    """(big, small): big = w rounded to TF32 (10 mantissa bits, to nearest,
    ties away from zero, as cvt.rna.tf32.f32), small = w - big rounded the
    same way. big + small is w within ~2^-22 |w|."""
    def rna(x):
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    big = rna(w)
    return big, rna(w - big)


def tc_gemms(cfg: NeRFConfig):
    """The tensor-core GEMMs in the kernel's order: (name, segments, N,
    relu). Segments are (source, K) in the order of the weight's input
    columns: SRC_PTS the embedded points, SRC_H the previous activations,
    SRC_DIRS the embedded view directions."""
    P, V, W = cfg.input_ch, cfg.input_ch_views, cfg.W
    gemms = []
    for i in range(cfg.D):
        segs = [(SRC_PTS, P)] if i == 0 or (i - 1) in cfg.skips else []
        segs += [(SRC_H, W)] if i > 0 else []
        gemms.append((f"pts_linears.{i}", segs, W, True))
    if cfg.use_viewdirs:
        gemms += [("feature_linear", [(SRC_H, W)], W, False),
                  ("views_linears.0", [(SRC_H, W), (SRC_DIRS, V)], W // 2, True)]
    return gemms


def tc_narrow_heads(cfg: NeRFConfig):
    """The narrow heads, run in fp32 on the CUDA cores: (descriptor row,
    name, K, N)."""
    if cfg.use_viewdirs:
        return [(0, "alpha_linear", cfg.W, 1), (1, "rgb_linear", cfg.W // 2, 3)]
    return [(2, "output_linear", cfg.W, cfg.output_ch)]


def slice_floats(Np: int) -> int:
    """Floats of one 8-row weight slice of an Np-wide GEMM: its big plane,
    then its small plane, each 8 x Np."""
    return 16 * Np


def slice_index(Np: int) -> torch.Tensor:
    """int64 [8, Np]: where weight (row k, column n) of a slice sits in one
    plane: wgmma's K-major layout without swizzle, core matrices of 8
    columns x 4 rows (a column's 4 k-values contiguous), the two k-halves
    of a column group 32 floats apart, column groups 64 floats apart."""
    k = torch.arange(SLICE_K)[:, None]
    n = torch.arange(Np)[None, :]
    return (n // 8) * 64 + (k // 4) * 32 + (n % 8) * 4 + k % 4


def tc_layout(cfg: NeRFConfig):
    """(layout, size): where ``pack_network_tc`` puts each matrix. A GEMM
    maps to (weight offset, bias offset, Kp, Np): its [Kp, Np] weight (each
    input segment's rows padded to a multiple of 8, N padded by
    ``padded_width``) as Kp / 8 consecutive slices of ``slice_floats(Np)``,
    its bias as Np floats; a narrow head to (weight offset, bias offset, K,
    N), its weight [N, K] as torch stores it. Every block starts 64-byte
    aligned; padding is zero."""
    layout, off = {}, 0

    def take(n):
        nonlocal off
        start, off = off, off + _round(n, 16)
        return start

    for name, segs, N, _ in tc_gemms(cfg):
        Kp, Np = sum(_round(k, SLICE_K) for _, k in segs), padded_width(N)
        layout[name] = (take(Kp // SLICE_K * slice_floats(Np)), take(Np), Kp, Np)
    for _, name, K, N in tc_narrow_heads(cfg):
        layout[name] = (take(N * K), take(N), K, N)
    return layout, off


def tc_strides(cfg: NeRFConfig):
    """(HS, SLOT): the shared-memory row stride in floats of the
    activations, 4 mod 8 so that a warp's A-fragment loads touch 32
    distinct banks, and the floats of a weight ring slot (the widest
    GEMM's slice)."""
    wn = padded_width(cfg.W)
    return wn + 4, slice_floats(wn)


def tc_sources(cfg: NeRFConfig):
    """(src, plane, desc): where each float of ``pack_network_tc``'s buffer
    comes from, which depends on the architecture alone. src [size] int64
    is 1 + the entry's index in the parameters flattened in
    ``torch_param_order`` (0: padding, zero); plane [size] int8 is 1 for
    a GEMM weight's big plane, 2 for its small plane, 0 for a value kept
    as it is (biases, narrow heads); desc is the int64 ``Desc`` of
    ``csrc/mlp_tile_tc.cuh``."""
    layout, size = tc_layout(cfg)
    shapes = param_shapes(cfg)
    start, off = {}, 1
    for name in torch_param_order(cfg):
        start[name] = off
        off += int(np.prod(shapes[name]))
    src = np.zeros(size, np.int64)
    plane = np.zeros(size, np.int8)
    desc = np.zeros(_TC_DESC_WORDS, np.int64)
    hdr = desc[:16]
    gemm = desc[16:16 + MAX_GEMMS * 8].reshape(MAX_GEMMS, 8)
    narrow = desc[16 + MAX_GEMMS * 8:16 + MAX_GEMMS * 8 + 12].reshape(3, 4)
    kind = desc[16 + MAX_GEMMS * 8 + 12:].view(np.int8)

    for g, (name, segs, N, relu) in enumerate(tc_gemms(cfg)):
        w_off, b_off, Kp, Np = layout[name]
        n_in = shapes[name + ".weight"][1]
        # block [Kp, Np]: row k of segment (row0, col0) is input column
        # col0 + k of the weight [N, n_in]
        block = np.zeros((Kp, Np), np.int64)
        row = col = 0
        for _, k in segs:
            block[row:row + k, :N] = (start[name + ".weight"] + col
                                      + np.arange(k)[:, None] + n_in * np.arange(N)[None, :])
            row, col = row + _round(k, SLICE_K), col + k
        at = slice_index(Np).reshape(-1).numpy()
        n_sl = Kp // SLICE_K
        for pl in (1, 2):
            dst = (w_off + np.arange(n_sl)[:, None] * slice_floats(Np)
                   + (pl - 1) * 8 * Np + at[None, :])
            src[dst] = block.reshape(n_sl, 8 * Np)
            plane[dst] = pl
        src[b_off:b_off + N] = start[name + ".bias"] + np.arange(N)
        seg_src = [s for s, _ in segs] + [-1]
        ns = [_round(k, SLICE_K) // SLICE_K for _, k in segs] + [0]
        gemm[g] = (w_off, b_off, Np, ns[0], seg_src[0], ns[1], seg_src[1], int(relu))
    for row, name, K, N in tc_narrow_heads(cfg):
        w_off, b_off, _, _ = layout[name]
        src[w_off:w_off + N * K] = start[name + ".weight"] + np.arange(N * K)
        src[b_off:b_off + N] = start[name + ".bias"] + np.arange(N)
        narrow[row] = (w_off, b_off, K, N)
    HS, SLOT = tc_strides(cfg)
    hdr[:9] = (cfg.D, cfg.W, cfg.input_ch, cfg.input_ch_views, out_channels(cfg),
               int(cfg.use_viewdirs), HS, SLOT, len(tc_gemms(cfg)))
    k = encoder_tables(cfg)[2]
    kind[:k.size] = k
    return src, plane, desc


_TC_STATIC: Dict[tuple, tuple] = {}


def _tc_static(cfg: NeRFConfig, device: torch.device):
    """``tc_sources`` on ``device``, made once per architecture and device
    (it holds no parameter value)."""
    key = (cfg, str(device))
    if key not in _TC_STATIC:
        src, plane, desc = tc_sources(cfg)
        _TC_STATIC[key] = (torch.from_numpy(src).to(device),
                           torch.from_numpy(plane).to(device), common.upload(desc, device))
    return _TC_STATIC[key]


def pack_network_tc(params: Dict[str, torch.Tensor], cfg: NeRFConfig, device):
    """(weights, desc, HS, SLOT) for the tensor-core kernels B1, B3 and B4:
    the fp32 buffer laid out by ``tc_layout`` (GEMM weights split by
    ``tf32_split`` into their two planes), the int64 ``Desc`` of
    ``csrc/mlp_tile_tc.cuh`` on ``device`` and the strides of
    ``tc_strides``. The buffer is made from the parameters on every call,
    in a few launches: one gather by ``tc_sources`` and the split."""
    device = torch.device(device)
    check_config(cfg)
    check_params(params, cfg, device)
    src, plane, desc = _tc_static(cfg, device)
    flat = torch.cat([torch.zeros(1, dtype=torch.float32, device=device)]
                     + [params[k].detach().reshape(-1) for k in torch_param_order(cfg)])
    v = flat[src]
    big, small = tf32_split(v)
    wbuf = torch.where(plane == 1, big, torch.where(plane == 2, small, v))
    HS, SLOT = tc_strides(cfg)
    return wbuf, desc, HS, SLOT


def encoder_buffer(cfg: NeRFConfig, device) -> torch.Tensor:
    """The point-major encoder table of B1 and B2, float32 [2 * MAX_EMB]:
    per compact embedding column its frequency, then its input (0-2 the
    point, 3-5 the view direction)."""
    src, scale, _ = encoder_tables(cfg)
    buf = np.zeros(2 * MAX_EMB, np.float32)
    buf[:scale.size] = scale
    buf[MAX_EMB:MAX_EMB + src.size] = src
    return common.upload(buf, device)


def plain_nerf_forward_rays(params, cfg: NeRFConfig, rays_o, rays_d, z, viewdirs):
    """The plain PyTorch version: apply_nerf on o + z·d -> raw [N, S, C]."""
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z[..., None]
    return apply_nerf(params, cfg, pts, viewdirs)


def param_shapes(cfg: NeRFConfig) -> Dict[str, tuple]:
    """State-dict name -> shape of every parameter of ``cfg``'s network."""
    W, V = cfg.W, cfg.input_ch_views
    lin = {f"pts_linears.{i}": (W, cfg.layer_in(i)) for i in range(cfg.D)}
    if cfg.use_viewdirs:
        lin.update({"views_linears.0": (W // 2, W + V),
                    "feature_linear": (W, W), "alpha_linear": (1, W),
                    "rgb_linear": (3, W // 2)})
    else:
        lin["output_linear"] = (cfg.output_ch, W)
    out = {}
    for name, (o, i) in lin.items():
        out[name + ".weight"], out[name + ".bias"] = (o, i), (o,)
    return out


def check_params(params, cfg: NeRFConfig, device):
    """Raise unless every parameter the kernels read is a float32 tensor of
    the right shape on ``device`` (the kernels index by cfg's widths)."""
    for name, shape in param_shapes(cfg).items():
        if name not in params:
            raise ValueError(f"missing parameter {name}")
        t = params[name]
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != device:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on {t.device}, "
                             f"expected {shape} float32 on {device}")


def _check_rays(cfg, rays_o, rays_d, z, viewdirs):
    dev = rays_o.device
    n, S = z.shape
    common.check_tensor(rays_o, "rays_o", (n, 3), dev)
    common.check_tensor(rays_d, "rays_d", (n, 3), dev)
    common.check_tensor(z, "z", (n, S), dev)
    if cfg.use_viewdirs:
        if viewdirs is None:
            raise ValueError("cfg.use_viewdirs needs viewdirs")
        common.check_tensor(viewdirs, "viewdirs", (n, 3), dev)
    elif viewdirs is not None:
        raise ValueError("viewdirs given to a network without a viewdir head")
    return n, S


_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def _launch(params, cfg, rays_o, rays_d, z, viewdirs) -> torch.Tensor:
    global LAUNCHES
    n, S = _check_rays(cfg, rays_o, rays_d, z, viewdirs)
    C = out_channels(cfg)
    out = torch.empty((n, S, C), dtype=torch.float32, device=z.device)
    if n * S == 0:
        return out
    fn = common.load("fused_mlp", _ARGS, "nstt_rays_forward_tc")
    with torch.cuda.device(z.device):
        wbuf, desc, HS, SLOT = pack_network_tc(params, cfg, z.device)
        A, B = ray_encoder_args(cfg, rays_o, rays_d, viewdirs)
        stream = torch.cuda.current_stream(z.device).cuda_stream
        rc = fn(desc.data_ptr(), HS, SLOT, wbuf.data_ptr(), A.data_ptr(),
                B.data_ptr(), z.data_ptr(), out.data_ptr(), n, S, stream)
    common.check_launch(rc, "fused_mlp (B3)")
    LAUNCHES += 1
    return out


class _RaysFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, names, rays_o, rays_d, z, viewdirs, *weights):
        ctx.cfg, ctx.names, ctx.n_lead = cfg, names, 2
        ctx.save_for_backward(rays_o, rays_d, z, viewdirs, *weights)
        return _launch(dict(zip(names, weights)), cfg, rays_o, rays_d, z,
                       viewdirs)

    @staticmethod
    def backward(ctx, g):
        cfg, names = ctx.cfg, ctx.names

        def plain(ro, rd, zz, vd, *w):
            return plain_nerf_forward_rays(dict(zip(names, w)), cfg, ro, rd,
                                           zz, vd)

        grads = common.remat_grads(ctx, plain, ctx.saved_tensors, (g,))
        return (None, None, *grads)


def fused_nerf_forward_rays(params, cfg: NeRFConfig, rays_o, rays_d, z,
                            viewdirs: Optional[torch.Tensor]) -> torch.Tensor:
    """raw [N, S, 4 | output_ch] of the network at pts = o + z·d: the plain
    version for CPU tensors, kernel B3 for CUDA tensors."""
    if rays_o.device.type == "cpu":
        return plain_nerf_forward_rays(params, cfg, rays_o, rays_d, z, viewdirs)
    if rays_o.device.type != "cuda":
        raise ValueError(f"fused_nerf_forward_rays: no kernel for {rays_o.device}")
    names = tuple(torch_param_order(cfg))
    return _RaysFn.apply(cfg, names, rays_o, rays_d, z, viewdirs,
                         *[params[k] for k in names])


def check_points(cfg: NeRFConfig, pts, viewdirs):
    """(N, S): raise unless pts is a contiguous float32 [..., S, 3] and
    viewdirs (with a viewdir head) a contiguous float32 [..., 3] on the
    same device, one direction per ray of S samples."""
    dev = pts.device
    if pts.dim() < 2 or pts.shape[-1] != 3:
        raise ValueError(f"pts has shape {tuple(pts.shape)}, expected [..., S, 3]")
    common.check_tensor(pts, "pts", tuple(pts.shape), dev)
    if cfg.use_viewdirs:
        if viewdirs is None:
            raise ValueError("cfg.use_viewdirs needs viewdirs")
        common.check_tensor(viewdirs, "viewdirs", tuple(pts.shape[:-2]) + (3,), dev)
    elif viewdirs is not None:
        raise ValueError("viewdirs given to a network without a viewdir head")
    S = pts.shape[-2]
    return pts.numel() // 3, S


_POINT_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def launch_points(params, cfg: NeRFConfig, pts, viewdirs) -> torch.Tensor:
    """Kernel B1 on CUDA tensors -> raw [..., S, C]; no autograd."""
    global POINT_LAUNCHES
    n, S = check_points(cfg, pts, viewdirs)
    C = out_channels(cfg)
    out = torch.empty(pts.shape[:-1] + (C,), dtype=torch.float32, device=pts.device)
    if n == 0:
        return out
    fn = common.load("fused_mlp", _POINT_ARGS, "nstt_points_forward_tc")
    with torch.cuda.device(pts.device):
        wbuf, desc, HS, SLOT = pack_network_tc(params, cfg, pts.device)
        enc = encoder_buffer(cfg, pts.device)
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        rc = fn(desc.data_ptr(), HS, SLOT, wbuf.data_ptr(), enc.data_ptr(),
                pts.data_ptr(), viewdirs.data_ptr() if viewdirs is not None else 0,
                out.data_ptr(), n, S, stream)
    common.check_launch(rc, "fused_mlp points (B1)")
    POINT_LAUNCHES += 1
    return out


def fused_nerf_forward(params, cfg: NeRFConfig, pts,
                       viewdirs: Optional[torch.Tensor]) -> torch.Tensor:
    """raw [..., S, 4 | output_ch] of the network at pts [..., S, 3] with
    view directions [..., 3]: ``apply_nerf`` (the plain version) for CPU
    tensors, kernel B1 for CUDA tensors, differentiated by kernel B2
    (``fused_mlp_bwd.fused_train_op``)."""
    if pts.device.type == "cpu":
        return apply_nerf(params, cfg, pts, viewdirs)
    if pts.device.type != "cuda":
        raise ValueError(f"fused_nerf_forward: no kernel for {pts.device}")
    from nerf_shared_tpu_torch.ops.cuda.fused_mlp_bwd import fused_train_op
    return fused_train_op(params, cfg, pts, viewdirs)


def flops_per_point(cfg: NeRFConfig) -> int:
    """Multiply-adds x 2 of the network for one sample point."""
    W, V = cfg.W, cfg.input_ch_views
    macs = sum(cfg.layer_in(i) * W for i in range(cfg.D))
    if cfg.use_viewdirs:
        macs += W * 1 + W * W + (W + V) * (W // 2) + (W // 2) * 3
    else:
        macs += W * cfg.output_ch
    return 2 * macs


def network_bytes(params, cfg: NeRFConfig) -> int:
    return 4 * sum(params[k].numel() for k in torch_param_order(cfg))
