"""Fused backward of the NeRF MLP (kernel B2), its plain version, and the
trainable op that pairs it with the forward kernel B1.

Counterpart of ``nerf_shared_tpu/ops/pallas/fused_mlp_bwd.py``:

- ``fused_mlp_backward(params, cfg, pts, viewdirs, g)``: the gradient of
  ``sum(apply_nerf(params, cfg, pts, viewdirs) * g)`` with respect to every
  parameter (a name -> tensor dict in the state-dict layout), the points
  (``dpts`` [..., S, 3]) and the view directions (``ddirs`` [..., 3],
  summed over the samples of each ray; None without a viewdir head). On a
  CUDA tensor it launches ``csrc/fused_mlp_bwd.cu``; on a CPU tensor it is
  ``plain_mlp_backward``, autograd of ``apply_nerf``.
- ``fused_train_op(params, cfg, pts, viewdirs)``: an ``autograd.Function``
  whose forward launches B1 and whose backward launches B2, the training
  path's network evaluation (``render/renderer.py`` under
  ``RenderConfig.fused_backward``). On CPU tensors it is ``apply_nerf``.

B2 is two kernels and a reduction, launched by one C entry:

1. the tile kernel rematerialises the forward per 64-point tile, takes the
   input gradients through every layer down to dx, and writes each weight
   matrix's layer input H and post-mask cotangent dZ to two device buffers
   (``act_layout``: one point-major segment per activation);
2. ``nerf_dw_kernel`` forms every dW = H^T·dZ on the tensor cores in split
   fp32 and every db = sum dZ in fp32, one output tile (``dw_tiles``) over
   one range of points (``split_ranges``) a block;
3. a fixed-order sum of the ranges' partial gradients.

The wrapper packs the forward weights (``fused_mlp.pack_network``) and a
second copy in PyTorch's [out, in] layout for the input-gradient products,
split where the network concatenates (the skip input, the view-direction
input), both by one gather through a source map made once per
architecture, and allocates the H, dZ and partial buffers.

Under ``compute_dtype`` bfloat16 B2 has a second instantiation with the
JAX kernel's roundings (fused_mlp_bwd.py ``_make_bwd_kernel_closed``):
the rematerialised activations, the weights and the cotangent g are bf16;
each dz is rounded (dz_c) before it enters a weight gradient or dh =
dz_c·Wᵀ; the ReLU masks read the bf16 activations; the bias gradients sum
the fp32 dz (dbout the rounded g); demb and dx stay fp32. The tile kernel
keeps its fp32 CUDA-core arithmetic on bf16-rounded operands (their
products are exact in fp32) and writes dZ in fp32; ``nerf_dw_kernel``
rounds dZ as it loads it and forms dW with one ``mma.sync.m16n8k16`` bf16
product a 16-point step. ``plain_mlp_backward_bf16`` is that arithmetic
in plain PyTorch.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from nerf_shared_tpu_torch.models.nerf import (
    NeRFConfig,
    apply_nerf,
    embed_inputs,
    torch_param_order,
)
from nerf_shared_tpu_torch.ops.cuda import common
from nerf_shared_tpu_torch.ops.cuda.fused_mlp import (
    MAX_LAYERS,
    _round4,
    bf16_round,
    check_points,
    encoder_buffer,
    flat_params,
    flops_per_point,
    check_in,
    check_out,
    is_bf16,
    launch_points,
    out_channels,
    pack_network,
    packed_layout,
    param_shapes,
    param_starts,
    plain_nerf_forward,
)

LAUNCHES = 0      # B2 launches made by fused_mlp_backward and fused_train_op
LAUNCHES_BF16 = 0  # the same for the bf16 instantiation
TILE_P = 64       # points per tile of the tile kernel (csrc/mlp_tile.cuh)
MAX_SMEM = 232448  # shared memory one block may use on sm_90
BW_ALPHA, BW_FEATURE, BW_VIEWS_F, BW_VIEWS_D, BW_RGB, BW_OUTPUT = range(6)
G_LD = 8          # cotangent tile row: rgb 0-2, alpha 3, alpha 4 (csrc G_LD)

# Activation segments (csrc/fused_mlp_bwd.cu BwdDesc hseg / zseg): H slots are the
# embedding [emb_pts, emb_dirs], h_l at 1 + l, the feature and hv; dZ slots
# are dz_l at l, dfeature, dhv and the cotangent tile.
N_SEG = MAX_LAYERS + 3
H_EMB, H_FEATURE, H_HV = 0, MAX_LAYERS + 1, MAX_LAYERS + 2
Z_DFEATURE, Z_DHV, Z_GR = MAX_LAYERS, MAX_LAYERS + 1, MAX_LAYERS + 2

# nerf_dw_kernel: output tile rows (of the input width) x columns (of the
# output width), points a staged chunk, chunks in flight, blocks an SM
DW_BM, DW_BN, DW_KC, DW_STAGES, DW_BLOCKS_PER_SM = 128, 128, 32, 3, 2
DW_LD = DW_BM + 8  # staged row stride, 8 mod 32 floats: conflict-free fragments
DW_WIDE, DW_NARROW = 0, 1
# job fields (csrc J_*): kind, H slot, H column, rows M, dZ slot, dZ column,
# columns N, float offset of row 0 of dW in the packed gradients, its row
# stride, offset of db (-1: another job of the matrix writes it)
J_WORDS, T_WORDS = 10, 3


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


def plain_mlp_backward_bf16(params, cfg: NeRFConfig, pts, viewdirs, g):
    """The plain version of B2's bf16 instantiation -> (grads, dpts,
    ddirs): the JAX kernel's roundings (fused_mlp_bwd.py:176-300) in plain
    PyTorch, fp32 arithmetic on bf16-rounded operands. The forward is
    ``fused_mlp.plain_mlp_bf16``'s; the ReLU masks read the bf16
    activations (hv's its fp32 pre-activation, as JAX's does); every dz is
    rounded before it enters a weight gradient or the next dh; the bias
    gradients sum the fp32 dz, the output biases the rounded g; demb and
    dx are fp32 (dx through the encoder by autograd of ``embed_inputs``)."""
    P, V, W = cfg.input_ch, cfg.input_ch_views, cfg.W
    C = g.shape[-1]
    with torch.enable_grad():
        pt = pts.detach().requires_grad_(True)
        vd = None if viewdirs is None else viewdirs.detach().requires_grad_(True)
        emb32 = embed_inputs(cfg, pt, vd)
    e = bf16_round(emb32.detach().reshape(-1, P + V))
    wt = {k: bf16_round(params[k + ".weight"]) for k in param_names_linear(cfg)}
    b = {k: params[k + ".bias"] for k in param_names_linear(cfg)}
    grads = {}

    def dense_grads(name, dz, dz_c, x):
        grads[name + ".weight"] = dz_c.t() @ x
        grads[name + ".bias"] = dz.sum(0)

    ins, hs, x = [], [], e[:, :P]
    for i in range(cfg.D):
        name = f"pts_linears.{i}"
        ins.append(x)
        hs.append(bf16_round(torch.relu(x @ wt[name].t() + b[name])))
        x = torch.cat([e[:, :P], hs[-1]], -1) if i in cfg.skips else hs[-1]
    h = hs[-1]
    gc = bf16_round(g.reshape(-1, C))
    demb = torch.zeros_like(e)
    if cfg.use_viewdirs:
        feature = bf16_round(h @ wt["feature_linear"].t() + b["feature_linear"])
        vin = torch.cat([feature, e[:, P:P + V]], -1)
        hv_pre = vin @ wt["views_linears.0"].t() + b["views_linears.0"]
        hv = bf16_round(torch.relu(hv_pre))
        g_rgb, g_alpha = gc[:, :3], gc[:, 3:4]
        dense_grads("rgb_linear", g_rgb, g_rgb, hv)
        dense_grads("alpha_linear", g_alpha, g_alpha, h)
        dhv = (g_rgb @ wt["rgb_linear"]) * (hv_pre > 0)
        dhv_c = bf16_round(dhv)
        dense_grads("views_linears.0", dhv, dhv_c, vin)
        dvin = dhv_c @ wt["views_linears.0"]
        dfeature = dvin[:, :W]
        demb[:, P:P + V] += dvin[:, W:]
        dfeature_c = bf16_round(dfeature)
        dense_grads("feature_linear", dfeature, dfeature_c, h)
        dh = g_alpha @ wt["alpha_linear"] + dfeature_c @ wt["feature_linear"]
    else:
        dense_grads("output_linear", gc, gc, h)
        dh = gc @ wt["output_linear"]
    for i in reversed(range(cfg.D)):
        name = f"pts_linears.{i}"
        dz = dh * (hs[i] > 0)
        dz_c = bf16_round(dz)
        dense_grads(name, dz, dz_c, ins[i])
        dx_in = dz_c @ wt[name]
        if i == 0:
            demb[:, :P] += dx_in
        elif (i - 1) in cfg.skips:
            demb[:, :P] += dx_in[:, :P]
            dh = dx_in[:, P:]
        else:
            dh = dx_in
    ins_ = [pt] + ([vd] if vd is not None else [])
    d_in = torch.autograd.grad(emb32, ins_, demb.reshape(emb32.shape))
    grads = {k: grads[k] for k in torch_param_order(cfg)}
    return grads, d_in[0], (d_in[1] if vd is not None else None)


def param_names_linear(cfg: NeRFConfig) -> List[str]:
    """The network's linear layers by state-dict prefix."""
    return [k[:-len(".weight")] for k in torch_param_order(cfg) if k.endswith(".weight")]


def act_layout(cfg: NeRFConfig):
    """(hseg, zseg, h_floats, z_floats): the H and dZ buffers the tile
    kernel writes and nerf_dw_kernel reads. Each is a run of point-major
    segments; slot s of hseg / zseg is {floats a point before it, its row
    stride} (-1, -1 where the network has none), so for n_pad points the
    segment starts at float n_pad * hseg[s, 0] and point p's row at
    + p * hseg[s, 1]. h_floats / z_floats: floats a point of each buffer.
    Strides are multiples of 4 floats, so every row is 16-byte aligned."""
    W = cfg.W
    HS = _round4(W)
    W2S = _round4(W // 2)
    ES = _round4(cfg.input_ch) + _round4(cfg.input_ch_views)
    hseg = np.full((N_SEG, 2), -1, np.int64)
    zseg = np.full((N_SEG, 2), -1, np.int64)
    h_list = [(H_EMB, ES)] + [(1 + l, HS) for l in range(cfg.D)]
    z_list = [(l, HS) for l in range(cfg.D)]
    if cfg.use_viewdirs:
        h_list += [(H_FEATURE, HS), (H_HV, W2S)]
        z_list += [(Z_DFEATURE, HS), (Z_DHV, W2S)]
    z_list.append((Z_GR, G_LD))
    sizes = []
    for table, entries in ((hseg, h_list), (zseg, z_list)):
        off = 0
        for slot, ld in entries:
            table[slot] = (off, ld)
            off += ld
        sizes.append(off)
    return hseg, zseg, sizes[0], sizes[1]


def dw_jobs(cfg: NeRFConfig) -> np.ndarray:
    """int64 [jobs, J_WORDS]: the weight-gradient products, one for each
    input segment of each matrix (the skip layer's and the views layer's
    weights are two), dW rows = that segment's columns of H, dW columns =
    the matrix's dZ. Wide products run on the tensor cores; the narrow
    heads (alpha, rgb, output: N <= 8) on the CUDA cores. The first
    product of a matrix also sums its bias gradient."""
    layout, _ = packed_layout(cfg)
    P, V, W, D = cfg.input_ch, cfg.input_ch_views, cfg.W, cfg.D
    P4 = _round4(P)
    jobs = []

    def add(kind, hslot, hcol, M, zslot, zcol, N, name, row0, bias):
        w_off, _, _, ld = layout[name + ".weight"]
        b_off = layout[name + ".bias"][0] if bias else -1
        jobs.append((kind, hslot, hcol, M, zslot, zcol, N, w_off + row0 * ld, ld, b_off))

    for l in range(D):
        name = f"pts_linears.{l}"
        from_emb = l == 0 or (l - 1) in cfg.skips
        if from_emb:
            add(DW_WIDE, H_EMB, 0, P, l, 0, W, name, 0, True)
        if l > 0:
            add(DW_WIDE, 1 + (l - 1), 0, W, l, 0, W, name, P if from_emb else 0,
                not from_emb)
    last = 1 + (D - 1)
    if cfg.use_viewdirs:
        add(DW_WIDE, last, 0, W, Z_DFEATURE, 0, W, "feature_linear", 0, True)
        add(DW_NARROW, last, 0, W, Z_GR, 4, 1, "alpha_linear", 0, True)
        add(DW_WIDE, H_FEATURE, 0, W, Z_DHV, 0, W // 2, "views_linears.0", 0, True)
        add(DW_WIDE, H_EMB, P4, V, Z_DHV, 0, W // 2, "views_linears.0", W, False)
        add(DW_NARROW, H_HV, 0, W // 2, Z_GR, 0, 3, "rgb_linear", 0, True)
    else:
        add(DW_NARROW, last, 0, W, Z_GR, 0, cfg.output_ch, "output_linear", 0, True)
    return np.asarray(jobs, np.int64)


def dw_tiles(jobs: np.ndarray) -> np.ndarray:
    """int64 [tiles, T_WORDS]: (job, m0, n0) of every output tile of
    nerf_dw_kernel, DW_BM rows x DW_BN columns (a narrow job: DW_BM rows x
    all its columns), in job order."""
    tiles = []
    for j, (kind, _, _, M, _, _, N, *_) in enumerate(jobs):
        n_step = DW_BN if kind == DW_WIDE else max(int(N), 1)
        for m0 in range(0, int(M), DW_BM):
            for n0 in range(0, int(N), n_step):
                tiles.append((j, m0, n0))
    return np.asarray(tiles, np.int64)


def dw_splits(n_pad: int, n_tiles: int, sms: int) -> int:
    """How many point ranges nerf_dw_kernel splits the sum over points
    into: about DW_BLOCKS_PER_SM x 2 blocks an SM over all tiles, at most
    one range a staged chunk."""
    want = max(1, (2 * DW_BLOCKS_PER_SM * sms) // max(1, n_tiles))
    return max(1, min(want, n_pad // DW_KC))


def split_ranges(n_pad: int, splits: int) -> List[Tuple[int, int]]:
    """[start, end) points of each range, in DW_KC-point chunks: range s
    holds chunks [s * C // splits, (s + 1) * C // splits) of the C =
    n_pad / DW_KC (csrc nerf_dw_kernel)."""
    C = n_pad // DW_KC
    return [(s * C // splits * DW_KC, (s + 1) * C // splits * DW_KC)
            for s in range(splits)]


def dw_smem_bytes() -> int:
    """Shared memory of one nerf_dw_kernel block: DW_STAGES chunks of H
    and dZ, DW_KC rows of DW_LD floats each."""
    return 4 * DW_STAGES * 2 * DW_KC * DW_LD


def reduce_partials(part: torch.Tensor, splits: int) -> torch.Tensor:
    """The plain version of csrc grad_reduce_kernel: out[i] = sum over
    ranges s = 0, 1, ... in that order of part[s, i], in fp32."""
    part = part.reshape(splits, -1)
    out = part[0].clone()
    for s in range(1, splits):
        out = out + part[s]
    return out


def bwd_sources(cfg: NeRFConfig):
    """(src, bdesc): where each float of ``pack_backward``'s buffer comes
    from, by ``fused_mlp.param_starts``' numbering (0: padding, zero), and
    the int64 BwdDesc of csrc/fused_mlp_bwd.cu ({offset, row stride} of
    each weight segment, -1 where there is none; then ``act_layout``'s
    segments). Both depend on the architecture alone."""
    P, W = cfg.input_ch, cfg.W
    shapes = param_shapes(cfg)
    start = param_starts(cfg)
    seg = np.full((MAX_LAYERS, 2, 2), -1, np.int64)
    head = np.full((6, 2), -1, np.int64)
    pieces, off = [], 0

    def add(name, col0, k):
        """Columns col0 .. col0 + k of weight ``name`` [out, in], each row
        padded to a multiple of 4."""
        nonlocal off
        n_out, n_in = shapes[name]
        ld = _round4(k)
        block = np.zeros((n_out, ld), np.int64)
        block[:, :k] = (start[name] + col0 + np.arange(k)[None, :]
                        + n_in * np.arange(n_out)[:, None])
        pieces.append(block.reshape(-1))
        begin, off = off, off + block.size
        return begin, ld

    for i in range(cfg.D):
        name = f"pts_linears.{i}.weight"
        if i == 0:
            seg[0, 0] = add(name, 0, P)
        elif (i - 1) in cfg.skips:
            seg[i, 0], seg[i, 1] = add(name, 0, P), add(name, P, W)
        else:
            seg[i, 1] = add(name, 0, W)
    if cfg.use_viewdirs:
        head[BW_ALPHA] = add("alpha_linear.weight", 0, W)
        head[BW_FEATURE] = add("feature_linear.weight", 0, W)
        head[BW_VIEWS_F] = add("views_linears.0.weight", 0, W)
        head[BW_VIEWS_D] = add("views_linears.0.weight", W, cfg.input_ch_views)
        head[BW_RGB] = add("rgb_linear.weight", 0, W // 2)
    else:
        head[BW_OUTPUT] = add("output_linear.weight", 0, W)
    hseg, zseg, _, _ = act_layout(cfg)
    bdesc = np.concatenate([seg.reshape(-1), head.reshape(-1), hseg.reshape(-1),
                            zseg.reshape(-1)])
    return np.concatenate(pieces), bdesc


_BWD_STATIC: Dict[tuple, tuple] = {}


def _bwd_static(cfg: NeRFConfig, device: torch.device):
    """(src, bdesc, dw_desc, n_jobs, n_tiles) on ``device``, made once per
    architecture and device (they hold no parameter value). dw_desc is
    ``dw_jobs`` then ``dw_tiles``, flattened."""
    key = (cfg, str(device))
    if key not in _BWD_STATIC:
        src, bdesc = bwd_sources(cfg)
        jobs = dw_jobs(cfg)
        tiles = dw_tiles(jobs)
        dw = np.concatenate([jobs.reshape(-1), tiles.reshape(-1)])
        _BWD_STATIC[key] = (torch.from_numpy(src).to(device), common.upload(bdesc, device),
                            common.upload(dw, device), len(jobs), len(tiles))
    return _BWD_STATIC[key]


def pack_backward(params, cfg: NeRFConfig, device, compute_dtype=torch.float32):
    """(wbt, bdesc): the weights in PyTorch's [out, in] layout, split where
    the input is a concatenation, each segment's rows padded to a multiple
    of 4 floats (zero), as one gather through ``bwd_sources``' map (under
    ``compute_dtype`` bfloat16 rounded to bf16, kept as fp32 values);
    bdesc is the int64
    BwdDesc of csrc/fused_mlp_bwd.cu."""
    device = torch.device(device)
    src, bdesc, _, _, _ = _bwd_static(cfg, device)
    wbt = flat_params(params, cfg, device)[src]
    return (bf16_round(wbt) if is_bf16(compute_dtype) else wbt), bdesc


_WEIGHT_MASK: Dict[tuple, torch.Tensor] = {}


def pack_forward(params, cfg: NeRFConfig, device, compute_dtype=torch.float32):
    """``fused_mlp.pack_network`` for B2's tile kernel; under
    ``compute_dtype`` bfloat16 the weight matrices rounded to bf16 (as fp32
    values), the biases fp32."""
    wbuf, desc, HS, ES = pack_network(params, cfg, device)
    if is_bf16(compute_dtype):
        key = (cfg, str(wbuf.device))
        if key not in _WEIGHT_MASK:
            layout, size = packed_layout(cfg)
            mask = np.zeros(size, bool)
            for name, (off, rows, _, ld) in layout.items():
                mask[off:off + rows * ld] = name.endswith(".weight")
            _WEIGHT_MASK[key] = torch.from_numpy(mask).to(wbuf.device)
        wbuf = torch.where(_WEIGHT_MASK[key], bf16_round(wbuf), wbuf)
    return wbuf, desc, HS, ES


def unpack_grads(grads: torch.Tensor, cfg: NeRFConfig) -> Dict[str, torch.Tensor]:
    """The kernel's packed [in, ld] gradient buffer -> state-dict layout."""
    layout, _ = packed_layout(cfg)
    out = {}
    for name, (off, rows, cols, ld) in layout.items():
        t = grads[off:off + rows * ld].view(rows, ld)[:, :cols]
        out[name] = t.t().contiguous() if name.endswith(".weight") else t[0].contiguous()
    return out


def smem_bytes(cfg: NeRFConfig) -> int:
    """Shared memory of one tile-kernel block: csrc/fused_mlp_bwd.cu
    bwd_smem_floats plus the NetDesc and BwdDesc it keeps in static shared
    memory."""
    HS = _round4(cfg.W)
    ES = _round4(cfg.input_ch) + _round4(cfg.input_ch_views)
    floats = 16 * 256 + 2 * TILE_P * HS + 2 * TILE_P * ES + TILE_P * G_LD
    net_desc = 8 * (16 + MAX_LAYERS * 4 + 20) + 256
    bwd_desc = 8 * (MAX_LAYERS * 4 + 12 + 4 * N_SEG)
    return 4 * floats + net_desc + bwd_desc


# csrc/fused_mlp_bwd.cu nstt_mlp_backward (and nstt_mlp_backward_bf16):
# descriptors, HS, ES; wb, wbt, enc, pts, vd, g; C; dx, hbuf, zbuf; dW
# tiles; jobs, tiles, part, grads; wsize, total, n_pad; S, grid, splits;
# stream
_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
         + [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int]
         + [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 3
         + [ctypes.c_void_p])


def launch_backward(params, cfg: NeRFConfig, pts, viewdirs, g,
                    compute_dtype=torch.float32):
    """Kernel B2 (its bf16 instantiation under ``compute_dtype`` bfloat16)
    on CUDA tensors -> (grads, dpts, ddirs).

    Scratch, all ``torch.empty``: H and dZ for n_pad = n rounded up to 64
    points (``act_layout``: 19,856 bytes a point at the lego width, ~3.9 GB
    at 196,608 points; the plain path's autograd keeps every layer's
    output too), and one partial copy of the packed gradients per point
    range (``dw_splits`` of them, 2.38 MB each at the lego width). Every
    float of a partial copy is written, padding as zero."""
    global LAUNCHES, LAUNCHES_BF16
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
    check_in("B2", compute_dtype, "launch_backward", params, pts=pts, viewdirs=viewdirs, g=g)
    bf16 = is_bf16(compute_dtype)
    fn = common.load("fused_mlp_bwd", _ARGS,
                     "nstt_mlp_backward_bf16" if bf16 else "nstt_mlp_backward")
    with torch.cuda.device(dev):
        wbuf, desc, HS, ES = pack_forward(params, cfg, dev, compute_dtype)
        wbt, bdesc = pack_backward(params, cfg, dev, compute_dtype)
        _, _, dw_desc, n_jobs, n_tiles = _bwd_static(cfg, dev)
        enc = encoder_buffer(cfg, dev)
        n_pt_tiles = -(-n // TILE_P)
        n_pad = n_pt_tiles * TILE_P
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        grid = min(n_pt_tiles, sms)
        splits = dw_splits(n_pad, n_tiles, sms)
        _, _, h_floats, z_floats = act_layout(cfg)
        hbuf = torch.empty(n_pad * h_floats, dtype=torch.float32, device=dev)
        zbuf = torch.empty(n_pad * z_floats, dtype=torch.float32, device=dev)
        part = torch.empty(splits * wsize, dtype=torch.float32, device=dev)
        grads = torch.empty(wsize, dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        tiles_ptr = dw_desc.data_ptr() + 8 * n_jobs * J_WORDS
        rc = fn(desc.data_ptr(), bdesc.data_ptr(), HS, ES, wbuf.data_ptr(),
                wbt.data_ptr(), enc.data_ptr(), pts.data_ptr(),
                viewdirs.data_ptr() if viewdirs is not None else 0,
                g.data_ptr(), out_channels(cfg), dx.data_ptr(), hbuf.data_ptr(),
                zbuf.data_ptr(), n_tiles, dw_desc.data_ptr(), tiles_ptr,
                part.data_ptr(), grads.data_ptr(), wsize, n, n_pad, S, grid, splits,
                stream)
    common.check_launch(rc, "fused_mlp_bwd (B2 bf16)" if bf16 else "fused_mlp_bwd (B2)")
    if bf16:
        LAUNCHES_BF16 += 1
    else:
        LAUNCHES += 1
    check_out("B2", compute_dtype, "launch_backward", grads=grads, dx=dx)
    dpts = dx[:, :3].reshape(pts.shape)
    ddirs = None
    if viewdirs is not None:
        ddirs = dx[:, 3:].reshape(pts.shape).sum(dim=-2)
    return unpack_grads(grads, cfg), dpts, ddirs


def _plain_backward(params, cfg, pts, viewdirs, g, compute_dtype, wrapper):
    """B2's plain version between its --debug_nans checks (a CPU tensor).
    It differentiates with autograd; anomaly mode (--debug_nans) is for the
    caller's graph, so it is off here: B2's own checks name a NaN."""
    check_in("B2", compute_dtype, wrapper, params, pts=pts, viewdirs=viewdirs, g=g)
    plain = plain_mlp_backward_bf16 if is_bf16(compute_dtype) else plain_mlp_backward
    with torch.autograd.set_detect_anomaly(False):
        grads, dpts, ddirs = plain(params, cfg, pts, viewdirs, g)
    check_out("B2", compute_dtype, wrapper, **grads, dpts=dpts, ddirs=ddirs)
    return grads, dpts, ddirs


def fused_mlp_backward(params, cfg: NeRFConfig, pts, viewdirs: Optional[torch.Tensor], g,
                       compute_dtype=torch.float32):
    """(grads, dpts, ddirs) of sum(raw * g): the plain version for CPU
    tensors, kernel B2 (its bf16 instantiation under ``compute_dtype``
    bfloat16) for CUDA tensors."""
    if pts.device.type == "cpu":
        return _plain_backward(params, cfg, pts, viewdirs, g, compute_dtype,
                               "fused_mlp_backward")
    if pts.device.type != "cuda":
        raise ValueError(f"fused_mlp_backward: no kernel for {pts.device}")
    return launch_backward(params, cfg, pts.contiguous(),
                           None if viewdirs is None else viewdirs.contiguous(),
                           g.contiguous(), compute_dtype)


class _TrainFn(torch.autograd.Function):
    """B1 forward, B2 backward (on the CPU, under bf16, their plain
    versions)."""

    @staticmethod
    def forward(ctx, cfg, names, dtype, pts, viewdirs, *weights):
        ctx.cfg, ctx.names, ctx.dtype = cfg, names, dtype
        ctx.save_for_backward(pts, viewdirs, *weights)
        params = dict(zip(names, weights))
        if pts.device.type == "cpu":
            check_in("B1", dtype, "fused_train_op", params, pts=pts, viewdirs=viewdirs)
            raw = plain_nerf_forward(params, cfg, pts, viewdirs, dtype)
            check_out("B1", dtype, "fused_train_op", raw=raw)
            return raw
        return launch_points(params, cfg, pts, viewdirs, dtype)

    @staticmethod
    def backward(ctx, g):
        pts, viewdirs, *weights = ctx.saved_tensors
        params = dict(zip(ctx.names, weights))
        if pts.device.type == "cpu":
            grads, dpts, ddirs = _plain_backward(params, ctx.cfg, pts, viewdirs, g, ctx.dtype,
                                                 "fused_train_op")
        else:
            grads, dpts, ddirs = launch_backward(params, ctx.cfg, pts, viewdirs,
                                                 g.contiguous(), ctx.dtype)
        need = ctx.needs_input_grad
        return (None, None, None, dpts if need[3] else None,
                ddirs if need[4] else None, *[grads[k] for k in ctx.names])


def fused_train_op(params, cfg: NeRFConfig, pts, viewdirs: Optional[torch.Tensor],
                   compute_dtype=torch.float32):
    """raw [..., S, C] whose forward is B1 and whose backward is B2 on CUDA
    tensors (their bf16 instantiations under ``compute_dtype`` bfloat16);
    on CPU tensors ``apply_nerf`` (forward and autograd backward) in fp32,
    the plain versions of B1 and B2 in bf16."""
    if pts.device.type == "cpu" and not is_bf16(compute_dtype):
        check_in("B1", compute_dtype, "fused_train_op", params, pts=pts, viewdirs=viewdirs)
        raw = apply_nerf(params, cfg, pts, viewdirs)
        check_out("B1", compute_dtype, "fused_train_op", raw=raw)
        return raw
    if pts.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_train_op: no kernel for {pts.device}")
    names = tuple(torch_param_order(cfg))
    return _TrainFn.apply(cfg, names, compute_dtype, pts.contiguous(),
                          None if viewdirs is None else viewdirs.contiguous(),
                          *[params[k] for k in names])


def flops_per_point_dw(cfg: NeRFConfig) -> int:
    """Multiply-adds x 2 of nerf_dw_kernel for one point: the weight-
    gradient product of every layer, one forward's worth
    (``flops_per_point``)."""
    return flops_per_point(cfg)


def flops_per_point_tile(cfg: NeRFConfig) -> int:
    """Multiply-adds x 2 of the tile kernel for one point: the forward
    again without the narrow output layers (their outputs are not needed)
    and the input-gradient product of every layer."""
    W = cfg.W
    narrow = W * 1 + (W // 2) * 3 if cfg.use_viewdirs else W * cfg.output_ch
    return 2 * (2 * (flops_per_point(cfg) // 2) - narrow)


def flops_per_point_bwd(cfg: NeRFConfig) -> int:
    """Multiply-adds x 2 of B2 for one point, counted from the layer
    shapes: the tile kernel's and nerf_dw_kernel's."""
    return flops_per_point_tile(cfg) + flops_per_point_dw(cfg)
