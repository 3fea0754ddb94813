"""Fused backward of the NeRF MLP (kernel B2), its plain version, and the
trainable op that pairs it with the forward kernel B1.

Counterpart of ``nerf_shared_tpu/ops/pallas/fused_mlp_bwd.py``:

- ``fused_mlp_backward(params, cfg, pts, viewdirs, g)``: the gradient of
  ``sum(apply_nerf(params, cfg, pts, viewdirs) * g)`` with respect to every
  parameter (a name -> tensor dict in the state-dict layout), the points
  (``dpts`` [..., S, 3]) and the view directions (``ddirs`` [..., 3],
  summed over the samples of each ray; None without a viewdir head). On a
  CUDA tensor it launches B1's training launch and then
  ``csrc/fused_mlp_bwd.cu``; on a CPU tensor it is ``plain_mlp_backward``,
  autograd of ``apply_nerf``.
- ``fused_train_op(params, cfg, pts, viewdirs)``: an ``autograd.Function``
  whose forward launches B1 and whose backward launches B2, the training
  path's network evaluation (``render/renderer.py`` under
  ``RenderConfig.fused_backward``). On CPU tensors it is ``apply_nerf``.

The data flow. When a gradient is wanted (grad mode on and an input that
requires one; fp32, IPE included), ``fused_train_op``'s forward is B1's
training launch (``forward_saving_h``): besides raw it writes every layer
input H of every point (the embedding, h_l, the feature, hv) into a device
buffer laid out by ``act_layout`` (one point-major segment per activation,
10,096 bytes a point at the lego width), counted in
``fused_mlp.SAVED_H_POINTS``. The buffer stays on the autograd context
until the backward has used it. Every other B1 launch writes no H.

B2 is two kernels and a reduction, launched by one C entry:

1. the tile kernel walks 128-point tiles on the tensor cores (B1's tile,
   ``csrc/mlp_tile_tc.cuh``): from the cotangent it takes the input
   gradients dh = dz·W through every layer over ``pack_backward_tc``'s
   pack down to dx, each ReLU mask read from H, and writes each weight
   matrix's post-mask cotangent dZ to a second device buffer
   (``act_layout``); split fp32 with each 8-row slice summed in fp32;
2. ``nerf_dw_kernel`` forms every dW = H^T·dZ on the tensor cores in split
   fp32 and every db = sum dZ in fp32, one output tile (``dw_tiles``) over
   one range of points (``split_ranges``) a block;
3. a fixed-order sum of the ranges' partial gradients.

``launch_backward`` called with no H (``fused_mlp_backward``, tests and
benchmarks) makes B1's training launch first, so there is one route.
``fused_train_op``'s backward forms dx only where the points or the view
directions need a gradient (pose refinement); otherwise (every benchmark
step) the fp32 tile is ``nerf_bwd_kernel<false>`` over a backward pack
without the GEMMs into the embedding (``bwd_gemms(cfg, dx=False)``).

``pack_backward_tc`` lays out each input-gradient GEMM's weights, W as a
[K = out, N = in] matrix split where the network concatenates (the skip
input, the view-direction input), in the tensor-core pack's slices, by one
gather through a source map made once per architecture; its descriptor
(``BwdDesc``) carries the GEMM sequence of the backward sweep and the H /
dZ segments. The wrapper allocates the dZ and partial buffers.

Under ``compute_dtype`` bfloat16 B2 has a second instantiation with the
JAX kernel's roundings (fused_mlp_bwd.py ``_make_bwd_kernel_closed``):
the rematerialised activations, the weights and the cotangent g are bf16;
each dz is rounded (dz_c) before it enters a weight gradient or dh =
dz_c·Wᵀ; the ReLU masks read the bf16 activations; the bias gradients sum
the fp32 dz (dbout the rounded g); demb and dx stay fp32. Its B1 is
another tile (``csrc/mlp_tile_bf16.cuh``), so its tile kernel reruns the
forward (B1's bf16 arithmetic on the tensor-core tile: one wgmma k16 bf16
product a 16-row slice of both packs in bf16), writes H itself and
writes dZ in fp32; ``nerf_dw_kernel`` rounds dZ as it loads it and forms
dW with one ``mma.sync.m16n8k16`` bf16 product a 16-point step.
``plain_mlp_backward_bf16`` is that arithmetic in plain PyTorch.

Under an IPE config (mip-NeRF) the tile kernel is ``nerf_bwd_ipe_kernel``
over H from B1's IPE training launch, in fp32, counted in
``LAUNCHES_IPE``; ``nerf_dw_kernel`` and the reduction are the same. It
computes the weight gradients alone: mip-NeRF trains no poses, so its
backward pack leaves out the GEMMs into the embedding (``bwd_gemms``) and
no dx is written.
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
    _TC_DESC_WORDS,
    MAX_LAYERS,
    PLANE_BF16,
    _round,
    _round4,
    bf16_round,
    check_config,
    check_in,
    check_out,
    check_params,
    check_points,
    encoder_buffer,
    flat_params,
    flops_per_point,
    gather_pack,
    is_bf16,
    launch_points,
    out_channels,
    pack_network_tc,
    packed_layout,
    padded_width,
    param_shapes,
    param_starts,
    place_slices,
    plain_nerf_forward,
    slice_floats,
    slice_rows,
    tc_strides,
)

LAUNCHES = 0      # B2 launches made by fused_mlp_backward and fused_train_op
LAUNCHES_BF16 = 0  # the same for the bf16 instantiation
LAUNCHES_IPE = 0   # the same for the IPE instantiation (mip-NeRF)
TILE_P = 128      # points per tile of the tile kernel (csrc/mlp_tile_tc.cuh TP)
MAX_SMEM = 232448  # shared memory one block may use on sm_90
G_LD = 8          # cotangent tile row: rgb 0-2, alpha 3, alpha 4 (csrc G_LD)
DX_LD = 6         # the tile's dx sums a point and warpgroup (csrc DX_LD)
ENC_ROW = 7       # the point-major encoder's floats a point (csrc PointEnc::ROW)
ENC_ROW_IPE = 9   # the IPE encoder's (csrc IpeEnc::ROW)
MAX_SLOTS = 8     # the deepest weight ring (csrc tc::MAX_SLOTS)

# The input-gradient GEMMs (csrc BwdDesc): at most the views layer's two,
# the feature layer's and two a trunk layer; their epilogues: dx through the
# embedding (arg 0 the points' columns, 1 the directions'), dfeature, dz_arg
# (the ReLU mask of h_arg), dz_arg with g_alpha·W_alpha added first
MAX_BGEMMS = 3 + 2 * MAX_LAYERS
BK_DEMB, BK_DFEATURE, BK_DZ, BK_DZ_ALPHA = range(4)

# Activation segments (csrc/fused_mlp_bwd.cu BwdDesc hseg / zseg): H slots are the
# embedding [emb_pts, emb_dirs], h_l at 1 + l, the feature and hv; dZ slots
# are dz_l at l, dfeature, dhv and the cotangent tile.
N_SEG = MAX_LAYERS + 3
H_EMB, H_FEATURE, H_HV = 0, MAX_LAYERS + 1, MAX_LAYERS + 2
Z_DFEATURE, Z_DHV, Z_GR = MAX_LAYERS, MAX_LAYERS + 1, MAX_LAYERS + 2
_BWD_DESC_WORDS = 8 + MAX_BGEMMS * 8 + 4 * N_SEG
_HSEG_WORD = 8 + MAX_BGEMMS * 8   # where the BwdDesc's H segments start

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


def bwd_gemms(cfg: NeRFConfig, dx: bool = True):
    """The tile kernel's input-gradient GEMMs dh = dz·W in the order it
    runs them: (name, col0, N, kind, arg), columns col0 .. col0 + N of
    weight ``name`` [out, in] as a [K = out, N] matrix. With viewdirs the
    views layer's direction and feature columns (dz = dhv), the feature
    layer (dz = dfeature); then per trunk layer from the last, its
    embedding columns (layer 0 and the layer after a skip) and its h
    columns (not layer 0). Without ``dx`` (no input needs a gradient) and
    under IPE the GEMMs into the embedding are left out."""
    P, V, W, D = cfg.input_ch, cfg.input_ch_views, cfg.W, cfg.D
    dx = dx and not cfg.ipe
    gemms = []
    if cfg.use_viewdirs:
        gemms += [("views_linears.0", W, V, BK_DEMB, 1)] if dx else []
        gemms += [("views_linears.0", 0, W, BK_DFEATURE, 0),
                  ("feature_linear", 0, W, BK_DZ_ALPHA, D - 1)]
    for l in reversed(range(D)):
        name = f"pts_linears.{l}"
        from_emb = l == 0 or (l - 1) in cfg.skips
        if from_emb and dx:
            gemms.append((name, 0, P, BK_DEMB, 0))
        if l > 0:
            gemms.append((name, P if from_emb else 0, W, BK_DZ, l - 1))
    return gemms


def bwd_layout(cfg: NeRFConfig, bf16: bool = False, dx: bool = True):
    """(layout, size, SLOT): where ``pack_backward_tc`` puts each of
    ``bwd_gemms(cfg, dx)``' GEMMs, (weight offset, Kp, Np) in floats: its [Kp, Np]
    weights (K padded to a multiple of ``slice_rows``, N by
    ``padded_width``) as consecutive slices of ``slice_floats(Np)``, 64-byte
    aligned; SLOT is the floats of the tile kernel's ring slot, the widest
    slice of this pack and of the forward's (``tc_strides``)."""
    shapes = param_shapes(cfg)
    sk = slice_rows(bf16)
    layout, off = [], 0
    for name, _, N, _, _ in bwd_gemms(cfg, dx):
        Kp, Np = _round(shapes[name + ".weight"][0], sk), padded_width(N)
        layout.append((off, Kp, Np))
        off += _round(Kp // sk * slice_floats(Np, bf16), 16)
    slot = max([tc_strides(cfg, bf16)[1]] + [slice_floats(Np, bf16) for _, _, Np in layout])
    return layout, off, slot


def bwd_tc_sources(cfg: NeRFConfig, bf16: bool = False, dx: bool = True):
    """(src, plane, src16, bdesc): ``fused_mlp.tc_sources``' source map for
    ``pack_backward_tc``'s buffer (block (k, n) of a GEMM is weight [k, col0
    + n]), and the int64 BwdDesc of csrc/fused_mlp_bwd.cu: its header
    (GEMM count, ring slot floats), a row per GEMM (weight offset, epilogue
    kind, Np, slices, the epilogue's argument, 0), ``act_layout``'s
    segments. Both depend on the architecture alone."""
    shapes = param_shapes(cfg)
    start = param_starts(cfg)
    layout, size, slot = bwd_layout(cfg, bf16, dx)
    sk = slice_rows(bf16)
    src = np.zeros(size, np.int64)
    plane = np.zeros(size, np.int8)
    src16 = np.zeros(2 * size, np.int64) if bf16 else None
    desc = np.zeros(_BWD_DESC_WORDS, np.int64)
    gemm = desc[8:8 + MAX_BGEMMS * 8].reshape(MAX_BGEMMS, 8)
    gems = bwd_gemms(cfg, dx)
    for i, ((name, col0, N, kind, arg), (w_off, Kp, Np)) in enumerate(zip(gems, layout)):
        n_out, n_in = shapes[name + ".weight"]
        block = np.zeros((Kp, Np), np.int64)
        block[:n_out, :N] = (start[name + ".weight"] + col0 + np.arange(N)[None, :]
                             + n_in * np.arange(n_out)[:, None])
        place_slices(src, plane, src16, w_off, block, bf16)
        gemm[i] = (w_off, kind, Np, Kp // sk, arg, 0, 0, 0)
    desc[:2] = (len(gems), slot)
    hseg, zseg, _, _ = act_layout(cfg)
    desc[8 + MAX_BGEMMS * 8:] = np.concatenate([hseg.reshape(-1), zseg.reshape(-1)])
    return src, plane, src16, desc


_BWD_STATIC: Dict[tuple, tuple] = {}


def _bwd_static(cfg: NeRFConfig, device: torch.device, bf16: bool = False,
                dx: bool = True):
    """(src, plane, bdesc, dw_desc, n_jobs, n_tiles, src16, in16) on
    ``device``, made once per architecture, type, ``dx`` (``bwd_gemms``)
    and device (they hold no parameter value). dw_desc is ``dw_jobs`` then ``dw_tiles``, flattened;
    src16 and in16 (its bf16 values' mask) are None in fp32."""
    key = (cfg, str(device), bf16, dx)
    if key not in _BWD_STATIC:
        src, plane, src16, bdesc = bwd_tc_sources(cfg, bf16, dx)
        jobs = dw_jobs(cfg)
        tiles = dw_tiles(jobs)
        dw = np.concatenate([jobs.reshape(-1), tiles.reshape(-1)])
        s16 = in16 = None
        if bf16:
            s16 = torch.from_numpy(src16).to(device)
            in16 = torch.from_numpy(np.repeat(plane == PLANE_BF16, 2)).to(device)
        _BWD_STATIC[key] = (torch.from_numpy(src).to(device), torch.from_numpy(plane).to(device),
                            common.upload(bdesc, device), common.upload(dw, device),
                            len(jobs), len(tiles), s16, in16)
    return _BWD_STATIC[key]


def pack_backward_tc(params, cfg: NeRFConfig, device, compute_dtype=torch.float32,
                     dx: bool = True):
    """(wbt, bdesc): the input-gradient GEMMs' weights (``bwd_gemms(cfg,
    dx)``) laid out by ``bwd_layout`` as the tensor-core pack lays out the forward's
    (``fused_mlp.pack_network_tc``): fp32, each 8-row slice's big and small
    tf32 planes; under ``compute_dtype`` bfloat16, one plane of 16 rows
    rounded to bf16; padding zero. One gather through ``bwd_tc_sources``'
    map, then the split or the rounding. bdesc is the int64 BwdDesc of
    csrc/fused_mlp_bwd.cu on ``device``."""
    device = torch.device(device)
    check_config(cfg)
    check_params(params, cfg, device)
    bf16 = is_bf16(compute_dtype)
    src, plane, bdesc, _, _, _, src16, in16 = _bwd_static(cfg, device, bf16, dx)
    extra = (src16, in16) if bf16 else ()
    return gather_pack(flat_params(params, cfg, device), src, plane, *extra), bdesc


def unpack_grads(grads: torch.Tensor, cfg: NeRFConfig) -> Dict[str, torch.Tensor]:
    """The kernel's packed [in, ld] gradient buffer -> state-dict layout."""
    layout, _ = packed_layout(cfg)
    out = {}
    for name, (off, rows, cols, ld) in layout.items():
        t = grads[off:off + rows * ld].view(rows, ld)[:, :cols]
        out[name] = t.t().contiguous() if name.endswith(".weight") else t[0].contiguous()
    return out


def smem_bytes(cfg: NeRFConfig) -> int:
    """Shared memory of one tile-kernel block with the smallest ring, two
    slots (the kernel takes the deepest that fits, at most MAX_SLOTS):
    csrc/fused_mlp_bwd.cu bwd_smem_floats (the [128][HS] activation tile,
    the cotangent tile, the encoder's rows, the dx sums, the ring) plus the
    Desc, the BwdDesc and the ring's barriers it keeps in static shared
    memory."""
    HS, _ = tc_strides(cfg)
    _, _, slot = bwd_layout(cfg)
    row = ENC_ROW_IPE if cfg.ipe else ENC_ROW
    floats = TILE_P * (HS + G_LD + row + 2 * DX_LD) + 2 * slot
    return 4 * floats + 8 * (_TC_DESC_WORDS + _BWD_DESC_WORDS + 2 * MAX_SLOTS)


# csrc/fused_mlp_bwd.cu nstt_mlp_backward (and nstt_mlp_backward_bf16):
# descriptors, HS, SLOT; wb, wbt, enc, pts, vd, g; C; dx, hbuf, zbuf; dW
# tiles; jobs, tiles, part, grads; wsize, total, n_pad; S, splits; stream
_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
         + [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int]
         + [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2
         + [ctypes.c_void_p])


def backward_symbol(cfg: NeRFConfig, bf16: bool, dx: bool = True) -> str:
    """B2's C entry for ``cfg`` (its IPE instantiation takes fp32 only;
    without ``dx``, fp32, the tile that forms no input gradient)."""
    if cfg.ipe:
        if bf16:
            raise ValueError("B2's IPE instantiation (mip-NeRF) computes in fp32 only")
        return "nstt_mlp_backward_ipe"
    if bf16:
        return "nstt_mlp_backward_bf16"
    return "nstt_mlp_backward" if dx else "nstt_mlp_backward_nodx"


def forward_saving_h(params, cfg: NeRFConfig, pts, viewdirs):
    """B1's training launch on CUDA tensors (fp32; its IPE instantiation
    for an IPE config) -> (raw, (hbuf, n_pad)): raw as ``launch_points``
    gives it, and B2's H buffer, every layer input of the n points for
    n_pad = n rounded up to the 128-point tile (``act_layout``; the padded
    rows hold the empty rows' activations, which nerf_dw_kernel reads as
    zero). ``torch.empty``: 10,096 bytes a point at the lego width, ~2.0
    GB at 196,608 points."""
    n, _ = check_points(cfg, pts, viewdirs)
    n_pad = -(-n // TILE_P) * TILE_P
    _, _, h_floats, _ = act_layout(cfg)
    hbuf = torch.empty(n_pad * h_floats, dtype=torch.float32, device=pts.device)
    bdesc = _bwd_static(cfg, pts.device)[2]
    hseg = bdesc[_HSEG_WORD:_HSEG_WORD + 2 * N_SEG]
    raw = launch_points(params, cfg, pts, viewdirs, torch.float32, hout=(hbuf, hseg, n_pad))
    return raw, (hbuf, n_pad)


def launch_backward(params, cfg: NeRFConfig, pts, viewdirs, g, compute_dtype=torch.float32,
                    saved=None, dx=True):
    """Kernel B2 (its bf16 instantiation under ``compute_dtype`` bfloat16,
    its IPE one for an IPE config) on CUDA tensors -> (grads, dpts,
    ddirs); under IPE, and in fp32 without ``dx``, dpts and ddirs are
    None. ``saved`` and ``dx``: as for ``launch_backward_h``."""
    return launch_backward_h(params, cfg, pts, viewdirs, g, compute_dtype, saved, dx)[:3]


def launch_backward_h(params, cfg: NeRFConfig, pts, viewdirs, g, compute_dtype=torch.float32,
                      saved=None, dx=True):
    """``launch_backward`` -> (grads, dpts, ddirs, hbuf, n_pad), with the H
    buffer the tile kernel read (``act_layout``: every layer input of every
    point, whose signs are the kernel's ReLU decisions). ``saved``: (hbuf,
    n_pad) from ``forward_saving_h`` on these points and weights; None in
    fp32: that launch is made first (it counts as a B1 launch). The bf16
    tile reruns the forward and writes H itself (``saved`` must be None).
    ``dx`` False (fp32; nothing needs the points' or the directions'
    gradient): the tile runs no GEMM into the embedding and forms no dx
    (``nstt_mlp_backward_nodx``); the weight gradients are the same bits.
    The bf16 tile forms dx either way, the IPE tile never.

    Scratch, all ``torch.empty``: dZ for n_pad = n rounded up to 128 points
    (``act_layout``: 9,760 bytes a point at the lego width; the plain
    path's autograd keeps every layer's output too), H under bf16, and
    one partial copy of the packed gradients per point range
    (``dw_splits`` of them, 2.38 MB each at the lego width). Every float
    of a partial copy is written, padding as zero."""
    global LAUNCHES, LAUNCHES_BF16, LAUNCHES_IPE
    dev = pts.device
    n, S = check_points(cfg, pts, viewdirs)
    common.check_tensor(g, "g", tuple(pts.shape[:-1]) + (out_channels(cfg),), dev)
    if smem_bytes(cfg) > MAX_SMEM:
        raise ValueError(f"B2 needs {smem_bytes(cfg)} bytes of shared memory "
                         f"per block at this width, more than {MAX_SMEM}")
    layout, wsize = packed_layout(cfg)
    bf16 = is_bf16(compute_dtype)
    dx = not cfg.ipe and (dx or bf16)
    dxbuf = torch.empty((n, 6) if dx else (0, 6), dtype=torch.float32, device=dev)
    if n == 0:
        return ({k: torch.zeros_like(params[k]) for k in layout},
                pts.new_zeros(pts.shape) if dx else None,
                torch.zeros_like(viewdirs) if dx and viewdirs is not None else None,
                dxbuf[:0, 0], 0)
    check_in("B2", compute_dtype, "launch_backward", params, pts=pts, viewdirs=viewdirs, g=g)
    if bf16 and saved is not None:
        raise ValueError("B2's bf16 tile reruns the forward: it takes no saved H")
    fn = common.load("fused_mlp_bwd", _ARGS, backward_symbol(cfg, bf16, dx))
    n_pad = -(-n // TILE_P) * TILE_P
    _, _, h_floats, z_floats = act_layout(cfg)
    if not bf16:
        hbuf, n_saved = saved if saved is not None else forward_saving_h(
            params, cfg, pts, viewdirs)[1]
        if n_saved != n_pad or hbuf.numel() != n_pad * h_floats:
            raise ValueError(f"the saved H holds {hbuf.numel()} floats for {n_saved} points, "
                             f"expected {n_pad * h_floats} for {n_pad}")
    with torch.cuda.device(dev):
        wbuf, desc, HS, _ = pack_network_tc(params, cfg, dev, compute_dtype)
        wbt, bdesc = pack_backward_tc(params, cfg, dev, compute_dtype, dx)
        _, _, _, dw_desc, n_jobs, n_tiles, _, _ = _bwd_static(cfg, dev, bf16, dx)
        enc = encoder_buffer(cfg, dev)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        splits = dw_splits(n_pad, n_tiles, sms)
        if bf16:
            hbuf = torch.empty(n_pad * h_floats, dtype=torch.float32, device=dev)
        zbuf = torch.empty(n_pad * z_floats, dtype=torch.float32, device=dev)
        part = torch.empty(splits * wsize, dtype=torch.float32, device=dev)
        grads = torch.empty(wsize, dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        tiles_ptr = dw_desc.data_ptr() + 8 * n_jobs * J_WORDS
        rc = fn(desc.data_ptr(), bdesc.data_ptr(), HS, bwd_layout(cfg, bf16, dx)[2],
                wbuf.data_ptr(), wbt.data_ptr(), enc.data_ptr(), pts.data_ptr(),
                viewdirs.data_ptr() if viewdirs is not None else 0,
                g.data_ptr(), out_channels(cfg), dxbuf.data_ptr() if dx else 0, hbuf.data_ptr(),
                zbuf.data_ptr(), n_tiles, dw_desc.data_ptr(), tiles_ptr,
                part.data_ptr(), grads.data_ptr(), wsize, n, n_pad, S, splits, stream)
    common.check_launch(rc, "fused_mlp_bwd (B2 bf16)" if bf16 else "fused_mlp_bwd (B2)")
    if cfg.ipe:
        LAUNCHES_IPE += 1
    elif bf16:
        LAUNCHES_BF16 += 1
    else:
        LAUNCHES += 1
    if not dx:
        check_out("B2", compute_dtype, "launch_backward", grads=grads)
        return unpack_grads(grads, cfg), None, None, hbuf, n_pad
    check_out("B2", compute_dtype, "launch_backward", grads=grads, dx=dxbuf)
    dpts = dxbuf[:, :3].reshape(pts.shape)
    ddirs = None
    if viewdirs is not None:
        ddirs = dxbuf[:, 3:].reshape(pts.shape).sum(dim=-2)
    return unpack_grads(grads, cfg), dpts, ddirs, hbuf, n_pad


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
    versions). ``save_h``: the forward is B1's training launch, whose H
    stays on the context until the backward has used it."""

    @staticmethod
    def forward(ctx, cfg, names, dtype, save_h, pts, viewdirs, *weights):
        ctx.cfg, ctx.names, ctx.dtype, ctx.saved_h = cfg, names, dtype, None
        ctx.save_for_backward(pts, viewdirs, *weights)
        params = dict(zip(names, weights))
        if pts.device.type == "cpu":
            check_in("B1", dtype, "fused_train_op", params, pts=pts, viewdirs=viewdirs)
            raw = plain_nerf_forward(params, cfg, pts, viewdirs, dtype)
            check_out("B1", dtype, "fused_train_op", raw=raw)
            return raw
        if save_h:
            raw, ctx.saved_h = forward_saving_h(params, cfg, pts, viewdirs)
            return raw
        return launch_points(params, cfg, pts, viewdirs, dtype)

    @staticmethod
    def backward(ctx, g):
        pts, viewdirs, *weights = ctx.saved_tensors
        params = dict(zip(ctx.names, weights))
        need = ctx.needs_input_grad
        if pts.device.type == "cpu":
            grads, dpts, ddirs = _plain_backward(params, ctx.cfg, pts, viewdirs, g, ctx.dtype,
                                                 "fused_train_op")
        else:
            if ctx.cfg.ipe and (need[4] or need[5]):
                raise ValueError("B2's IPE instantiation computes no gradient of the "
                                 "Gaussians or the view directions (mip-NeRF trains no poses)")
            saved, ctx.saved_h = ctx.saved_h, None
            grads, dpts, ddirs = launch_backward(params, ctx.cfg, pts, viewdirs,
                                                 g.contiguous(), ctx.dtype, saved=saved,
                                                 dx=need[4] or need[5])
        return (None, None, None, None, dpts if need[4] else None,
                ddirs if need[5] else None, *[grads[k] for k in ctx.names])


def saves_h(compute_dtype, tensors) -> bool:
    """Whether ``fused_train_op``'s B1 launch on CUDA tensors is the
    training launch that writes B2's H: in fp32 (IPE included; the bf16
    tile reruns its forward), with grad mode on and one of ``tensors``
    requiring a gradient. No-grad launches (frames, probes, eval) write
    none."""
    return (not is_bf16(compute_dtype) and torch.is_grad_enabled()
            and any(t is not None and t.requires_grad for t in tensors))


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
    weights = [params[k] for k in names]
    save_h = pts.device.type == "cuda" and saves_h(compute_dtype, [pts, viewdirs, *weights])
    return _TrainFn.apply(cfg, names, compute_dtype, save_h, pts.contiguous(),
                          None if viewdirs is None else viewdirs.contiguous(), *weights)


def flops_per_point_dw(cfg: NeRFConfig) -> int:
    """Multiply-adds x 2 of nerf_dw_kernel for one point: the weight-
    gradient product of every layer, one forward's worth
    (``flops_per_point``)."""
    return flops_per_point(cfg)


def flops_per_point_tile(cfg: NeRFConfig, dx: bool = True) -> int:
    """Multiply-adds x 2 of the tile kernel for one point: the input-
    gradient product of every layer, one forward's worth (the narrow
    heads' on the CUDA cores included; the tile reruns no forward); under
    IPE or without ``dx`` less the GEMMs into the embedding, which it
    does not run then."""
    f = flops_per_point(cfg)
    if cfg.ipe or not dx:
        P, V, W = cfg.input_ch, cfg.input_ch_views, cfg.W
        from_emb = 1 + sum(1 for s in cfg.skips if s + 1 < cfg.D)
        f -= 2 * (from_emb * P * W + (V * (W // 2) if cfg.use_viewdirs else 0))
    return f


def flops_per_point_bwd(cfg: NeRFConfig, dx: bool = True) -> int:
    """Multiply-adds x 2 of B2 for one point, counted from the layer
    shapes: the tile kernel's and nerf_dw_kernel's."""
    return flops_per_point_tile(cfg, dx) + flops_per_point_dw(cfg)
