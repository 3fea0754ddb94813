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
encoder) over the weights that ``pack_network_tc`` lays out, as B2's tile
kernel does for its forward.

Under ``compute_dtype`` bfloat16 (``--precision bf16``) each kernel has a
bf16 instantiation on a tile of its own (``csrc/mlp_tile_bf16.cuh``: bf16
operands on wgmma's k16, A read from shared memory, weights in stages of
up to four 16-row slices of ``pack_network_tc(..., torch.bfloat16)``). Its
arithmetic is the JAX kernels' (fused_mlp.py ``_mlp_out_value``): the
encoder in fp32, its output rounded to bf16; bf16 weights, fp32 biases,
fp32 accumulation; h and hv rounded after the ReLU, the feature rounded
without one; the narrow heads' weights and biases rounded (JAX's
``pack_params`` casts them), their output fp32. ``plain_mlp_bf16`` is that
arithmetic in plain PyTorch: bf16-rounded operands multiplied in fp32.

Under an IPE config (``models.nerf.MipNeRFConfig``, mip-NeRF) B1 takes
Gaussian records [..., S, 6] (mean, variances; ops/mip.py) for points and
launches ``nerf_points_ipe_kernel``, the same tile with the IPE encoder
(``csrc/mlp_tile_tc.cuh`` IpeEnc: sin / cos of f·μ times exp(-f²σ²/2) from
``encoder_tables``' kinds 3 and 4), fp32 only; it counts its launches in
``POINT_LAUNCHES_IPE`` and its points in ``IPE_POINTS``. B3 and B4 build
points from rays and depths, not Gaussians, and decline IPE configs.

B1's training launch (``launch_points(..., hout=...)``, made by
``fused_mlp_bwd.fused_train_op`` when a gradient is wanted, in fp32 and
under IPE) also writes every layer input it forms (the embedding, h_l, the
feature, hv) into B2's H buffer, which B2's tile then reads instead of
rerunning the forward; it counts those points in ``SAVED_H_POINTS``. Every
other launch writes no H.

Both entries dispatch on the tensors' device: on the CPU they are the plain
version, on a CUDA device they launch the kernel or raise. B1's gradient is
kernel B2 (``fused_mlp_bwd.fused_train_op``); B3's backward recomputes
through the plain network (``apply_nerf`` at the compute dtype: under bf16
the JAX package's plain bf16 network, as its remat backward runs it).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
import torch

import torch.nn.functional as F

from nerf_shared_tpu_torch.models.nerf import (
    NeRFConfig,
    apply_nerf,
    embed_inputs,
    torch_param_order,
)
from nerf_shared_tpu_torch.ops.cuda import common
from nerf_shared_tpu_torch.ops.mip import ipe_freqs

MAX_LAYERS, MAX_W, MAX_EMB, MAX_OUT = 32, 256, 256, 8

LAUNCHES = 0        # B3 launches made by fused_nerf_forward_rays
POINT_LAUNCHES = 0  # B1 launches made by fused_nerf_forward and fused_train_op
LAUNCHES_BF16 = 0        # the same for the bf16 instantiations
POINT_LAUNCHES_BF16 = 0
POINT_LAUNCHES_IPE = 0   # B1 launches of the IPE instantiation
IPE_POINTS = 0           # points encoded by those launches
SAVED_H_POINTS = 0       # points whose layer inputs B1's training launches wrote for B2


def is_bf16(compute_dtype) -> bool:
    """True for bfloat16, False for float32; raises on any other type."""
    if compute_dtype == torch.bfloat16:
        return True
    if compute_dtype == torch.float32:
        return False
    raise ValueError(f"the kernels compute in float32 or bfloat16, not {compute_dtype}")


def _label(kernel: str, compute_dtype) -> str:
    """A kernel's label in --debug_nans errors: ``B1``, ``B1 bf16``, ..."""
    return f"{kernel} bf16" if is_bf16(compute_dtype) else kernel


def check_in(kernel: str, compute_dtype, wrapper: str, params, **tensors):
    """--debug_nans on an MLP kernel's inputs: ``tensors`` and the
    network's ``params`` (common.check_finite)."""
    common.check_finite(_label(kernel, compute_dtype), wrapper, "input", **tensors, **params)


def check_out(kernel: str, compute_dtype, wrapper: str, **tensors):
    """--debug_nans on an MLP kernel's outputs."""
    common.check_finite(_label(kernel, compute_dtype), wrapper, "output", **tensors)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest, ties to even) and back to fp32."""
    return x.to(torch.bfloat16).float()


def plain_mlp_bf16(params, cfg: NeRFConfig, emb: torch.Tensor) -> torch.Tensor:
    """The bf16 kernels' network (B1, B3, B4 under bf16) on fp32
    embeddings [..., P (+ V)] -> raw fp32, in plain PyTorch: every operand
    rounded to bf16 and multiplied in fp32 (a product of two bf16 values
    is exact in fp32), the fp32 biases added in fp32, h and hv rounded
    after the ReLU, the feature without one, the narrow heads' biases
    rounded too (fused_mlp.py ``_mlp_out_value``, ``pack_params``)."""
    P, V = cfg.input_ch, cfg.input_ch_views

    def dense(name, x, round_bias=False):
        b = params[name + ".bias"]
        return F.linear(x, bf16_round(params[name + ".weight"]),
                        bf16_round(b) if round_bias else b)

    e = bf16_round(emb)
    pts, views = e[..., :P], e[..., P:P + V]
    h = pts
    for i in range(cfg.D):
        h = bf16_round(F.relu(dense(f"pts_linears.{i}", h)))
        if i in cfg.skips:
            h = torch.cat([pts, h], dim=-1)
    if cfg.use_viewdirs:
        alpha = dense("alpha_linear", h, True)
        feature = bf16_round(dense("feature_linear", h))
        hv = bf16_round(F.relu(dense("views_linears.0", torch.cat([feature, views], -1))))
        return torch.cat([dense("rgb_linear", hv, True), alpha], dim=-1)
    return dense("output_linear", h, True)


def plain_nerf_forward(params, cfg: NeRFConfig, pts, viewdirs,
                       compute_dtype=torch.float32):
    """The plain version of B1 (of its bf16 instantiation under
    ``compute_dtype`` bfloat16): raw [..., S, C] at pts [..., S, 3]."""
    if not is_bf16(compute_dtype):
        return apply_nerf(params, cfg, pts, viewdirs)
    return plain_mlp_bf16(params, cfg, embed_inputs(cfg, pts, viewdirs))


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def out_channels(cfg: NeRFConfig) -> int:
    return 4 if cfg.use_viewdirs else cfg.output_ch


def encoder_tables(cfg: NeRFConfig):
    """Per embedding column (the layout of [γ(pts), γ(dirs)]): the input it
    reads (0-2 ray, 3-5 view direction; under IPE 0-2 the mean, whose
    variances follow at 3-5, and 6-8 the view direction), its frequency,
    and its kind (0 identity, 1 sin, 2 cos; 3 and 4 the IPE's attenuated
    sin and cos)."""
    src, scale, kind = [], [], []
    specs = []
    if cfg.ipe:
        for freq in ipe_freqs(cfg.min_deg_point, cfg.multires):
            for k in (3, 4):
                for d in range(3):
                    src.append(d), scale.append(freq), kind.append(k)
    else:
        specs.append((0, cfg.pts_embedder))
    if cfg.use_viewdirs:
        specs.append((6 if cfg.ipe else 3, cfg.views_embedder))
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


def check_ray_config(cfg: NeRFConfig, kernel: str):
    """Raise for an IPE config: the ray-major kernels (B3, B4) form points
    from rays and depths, and mip-NeRF's samples are Gaussians."""
    if getattr(cfg, "ipe", False):
        raise ValueError(f"kernel {kernel} evaluates points o + z·d along rays; mip-NeRF's "
                         "IPE network takes Gaussians and renders through kernel B1 "
                         "(render/renderer.py render_rays_mip)")


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
    """(layout, size): the packed layout B2 writes its gradients in. layout
    maps a state-dict name to (float offset, rows, cols, row stride): a
    weight [out, in] is stored transposed as rows = in, cols = out; a bias
    as one row. Row strides are cols rounded up to 4, so every matrix
    starts 16-byte aligned."""
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


def param_starts(cfg: NeRFConfig) -> Dict[str, int]:
    """1 + the index of each parameter's first entry in the parameters
    flattened in ``torch_param_order`` after one leading zero: the source
    numbering of the packs' gathers (``flat_params``; 0 reads the zero)."""
    shapes = param_shapes(cfg)
    start, off = {}, 1
    for name in torch_param_order(cfg):
        start[name] = off
        off += int(np.prod(shapes[name]))
    return start


def flat_params(params: Dict[str, torch.Tensor], cfg: NeRFConfig, device) -> torch.Tensor:
    """[0, every parameter flattened in ``torch_param_order``]: what the
    packs gather from, by ``param_starts``' numbering."""
    return torch.cat([torch.zeros(1, dtype=torch.float32, device=device)]
                     + [params[k].detach().reshape(-1) for k in torch_param_order(cfg)])


# --- the tensor-core kernels' pack (B1, B3, B4: csrc/mlp_tile_tc.cuh) --------

MAX_GEMMS, SLICE_K, SLICE_K_BF16 = MAX_LAYERS + 2, 8, 16
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


def slice_rows(bf16: bool = False) -> int:
    """Weight rows of a ring slot: one MMA's k (tf32 k8, bf16 k16)."""
    return SLICE_K_BF16 if bf16 else SLICE_K


def slice_floats(Np: int, bf16: bool = False) -> int:
    """Floats of one weight slice of an Np-wide GEMM: fp32, its big plane
    then its small plane, each 8 x Np; bf16, one plane of 16 x Np bf16
    values (the bytes of 8 x Np floats)."""
    return 8 * Np if bf16 else 16 * Np


def slice_index(Np: int) -> torch.Tensor:
    """int64 [8, Np]: where weight (row k, column n) of a slice sits in one
    plane: wgmma's K-major layout without swizzle, core matrices of 8
    columns x 4 rows (a column's 4 k-values contiguous), the two k-halves
    of a column group 32 floats apart, column groups 64 floats apart."""
    k = torch.arange(SLICE_K)[:, None]
    n = torch.arange(Np)[None, :]
    return (n // 8) * 64 + (k // 4) * 32 + (n % 8) * 4 + k % 4


def slice_index_bf16(Np: int) -> torch.Tensor:
    """int64 [16, Np]: where weight (row k, column n) of a bf16 slice sits,
    in bf16 values: the same K-major core matrices in bytes (8 columns x
    16 bytes, a column's 8 k-values contiguous), the two k-halves of a
    column group 64 values (128 bytes) apart, column groups 128 values
    (256 bytes) apart, so one wgmma descriptor reads either pack."""
    k = torch.arange(SLICE_K_BF16)[:, None]
    n = torch.arange(Np)[None, :]
    return (n // 8) * 128 + (k // 8) * 64 + (n % 8) * 8 + k % 8


def tc_layout(cfg: NeRFConfig, bf16: bool = False):
    """(layout, size): where ``pack_network_tc`` puts each matrix. A GEMM
    maps to (weight offset, bias offset, Kp, Np): its [Kp, Np] weight (each
    input segment's rows padded to a multiple of ``slice_rows``, N padded
    by ``padded_width``) as consecutive slices of ``slice_floats(Np)``,
    its bias as Np floats; a narrow head to (weight offset, bias offset, K,
    N), its weight [N, K] as torch stores it. Offsets and sizes count
    floats; every block starts 64-byte aligned; padding is zero."""
    layout, off = {}, 0
    sk = slice_rows(bf16)

    def take(n):
        nonlocal off
        start, off = off, off + _round(n, 16)
        return start

    for name, segs, N, _ in tc_gemms(cfg):
        Kp, Np = sum(_round(k, sk) for _, k in segs), padded_width(N)
        layout[name] = (take(Kp // sk * slice_floats(Np, bf16)), take(Np), Kp, Np)
    for _, name, K, N in tc_narrow_heads(cfg):
        layout[name] = (take(N * K), take(N), K, N)
    return layout, off


# --- the bf16 forward tile (B1, B3, B4 in bf16: csrc/mlp_tile_bf16.cuh) ---------

STAGE_SLICES, TILE_WG_ROWS = 4, 64
OPERAND_KCHUNK, OPERAND_CORE = 16 * TILE_WG_ROWS, 128


def operand_offset(p, k):
    """Byte offset of (row p < 64, column k) in a consumer warpgroup's bf16
    operand block of the bf16 tile (its activations h, or its encoded
    inputs [pts_emb, dirs_emb]): wgmma's K-major layout without swizzle,
    8-column chunks ``OPERAND_KCHUNK`` bytes apart (the descriptor's
    leading offset), 8-row core matrices ``OPERAND_CORE`` bytes apart (its
    stride offset), a row's 8 values in 16 bytes. ints or integer
    tensors."""
    return (k // 8) * OPERAND_KCHUNK + (p // 8) * OPERAND_CORE + (p % 8) * 16 + (k % 8) * 2


def tile_emb_cols(cfg: NeRFConfig) -> int:
    """Columns of the bf16 tile's encoded-input block: the points' P
    padded to 16, then (with a viewdir head) the directions' V padded to
    16, as the pack pads those segments' rows."""
    return _round(cfg.input_ch, 16) + (_round(cfg.input_ch_views, 16) if cfg.use_viewdirs else 0)


def bf16_stage_plan(cfg: NeRFConfig):
    """The bf16 tile's weight stages for one tile, in ring order: (GEMM
    index, first slice, slices, bytes, float offset in the bf16 pack).
    Each GEMM's 16-row slices, consecutive in the pack, in stages of up to
    ``STAGE_SLICES`` (64 weight rows), its last stage possibly shorter."""
    layout, _ = tc_layout(cfg, True)
    plan = []
    for g, (name, _, _, _) in enumerate(tc_gemms(cfg)):
        w_off, _, Kp, Np = layout[name]
        ns, sf = Kp // SLICE_K_BF16, slice_floats(Np, True)
        for s0 in range(0, ns, STAGE_SLICES):
            n = min(STAGE_SLICES, ns - s0)
            plan.append((g, s0, n, 4 * n * sf, w_off + s0 * sf))
    return plan


def entry_sizes(cfg: NeRFConfig, bf16: bool, HS: int, SLOT: int):
    """The two sizes an MLP kernel's C entry takes after its descriptor:
    fp32, the pack's (HS, SLOT); bf16, (SLOT, ``tile_emb_cols``)."""
    return (SLOT, tile_emb_cols(cfg)) if bf16 else (HS, SLOT)


def tc_strides(cfg: NeRFConfig, bf16: bool = False):
    """(HS, SLOT): the shared-memory row stride in floats of the
    activations, 4 mod 8 so that a warp's A-fragment loads touch 32
    distinct banks, and the floats of a weight ring slot (the widest
    GEMM's slice)."""
    wn = padded_width(cfg.W)
    return wn + 4, slice_floats(wn, bf16)


PLANE_KEEP, PLANE_BIG, PLANE_SMALL, PLANE_BF16, PLANE_ROUND = range(5)


def place_slices(src, plane, src16, w_off, block, bf16: bool):
    """Lay a GEMM's [Kp, Np] source block (sources by ``param_starts``'
    numbering, 0 for padding) into a pack's slices from float ``w_off``:
    fp32, its big and small planes (``src`` and ``plane``); bf16, one bf16
    plane (``src16``, two values a float; ``plane`` PLANE_BF16)."""
    Kp, Np = block.shape
    sk = slice_rows(bf16)
    n_sl = Kp // sk
    if bf16:
        at = slice_index_bf16(Np).reshape(-1).numpy()
        dst = (2 * w_off + np.arange(n_sl)[:, None] * (2 * slice_floats(Np, True))
               + at[None, :])
        src16[dst] = block.reshape(n_sl, sk * Np)
        plane[w_off:w_off + n_sl * slice_floats(Np, True)] = PLANE_BF16
        return
    at = slice_index(Np).reshape(-1).numpy()
    for pl in (PLANE_BIG, PLANE_SMALL):
        dst = (w_off + np.arange(n_sl)[:, None] * slice_floats(Np)
               + (pl - 1) * 8 * Np + at[None, :])
        src[dst] = block.reshape(n_sl, 8 * Np)
        plane[dst] = pl


def gather_pack(flat: torch.Tensor, src, plane, src16=None, in16=None) -> torch.Tensor:
    """A pack's fp32 buffer from the parameters flattened by ``flat_params``
    and a source map: fp32 (``src16`` None), each GEMM weight split by
    ``tf32_split`` into its plane; bf16, the narrow heads rounded in place
    and the weight slices' bf16 values (``src16``, where ``in16``) in pairs
    a float."""
    v = flat[src]
    if src16 is None:
        big, small = tf32_split(v)
        return torch.where(plane == PLANE_BIG, big,
                           torch.where(plane == PLANE_SMALL, small, v))
    v = torch.where(plane == PLANE_ROUND, bf16_round(v), v)
    w16 = torch.where(in16, flat[src16].to(torch.bfloat16), v.view(torch.bfloat16))
    return w16.view(torch.float32)


def tc_sources(cfg: NeRFConfig, bf16: bool = False):
    """(src, plane, src16, desc): where each float of ``pack_network_tc``'s
    buffer comes from, which depends on the architecture alone. src [size]
    int64 is 1 + the entry's index in the parameters flattened in
    ``torch_param_order`` (0: padding, zero); plane [size] int8 says what
    becomes of it: PLANE_BIG / PLANE_SMALL a GEMM weight's big / small
    tf32 plane, PLANE_KEEP kept as it is (biases; the narrow heads in
    fp32), PLANE_ROUND rounded to bf16 (the narrow heads under bf16),
    PLANE_BF16 a float of a bf16 weight slice, whose two bf16 values come
    from src16 [2 * size] (None in fp32); desc is the int64 ``Desc`` of
    ``csrc/mlp_tile_tc.cuh``."""
    layout, size = tc_layout(cfg, bf16)
    shapes = param_shapes(cfg)
    start = param_starts(cfg)
    sk = slice_rows(bf16)
    src = np.zeros(size, np.int64)
    plane = np.zeros(size, np.int8)
    src16 = np.zeros(2 * size, np.int64) if bf16 else None
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
            row, col = row + _round(k, sk), col + k
        place_slices(src, plane, src16, w_off, block, bf16)
        src[b_off:b_off + N] = start[name + ".bias"] + np.arange(N)
        seg_src = [s for s, _ in segs] + [-1]
        ns = [_round(k, sk) // sk for _, k in segs] + [0]
        gemm[g] = (w_off, b_off, Np, ns[0], seg_src[0], ns[1], seg_src[1], int(relu))
    for row, name, K, N in tc_narrow_heads(cfg):
        w_off, b_off, _, _ = layout[name]
        src[w_off:w_off + N * K] = start[name + ".weight"] + np.arange(N * K)
        src[b_off:b_off + N] = start[name + ".bias"] + np.arange(N)
        if bf16:
            plane[w_off:w_off + N * K] = PLANE_ROUND
            plane[b_off:b_off + N] = PLANE_ROUND
        narrow[row] = (w_off, b_off, K, N)
    HS, SLOT = tc_strides(cfg, bf16)
    hdr[:9] = (cfg.D, cfg.W, cfg.input_ch, cfg.input_ch_views, out_channels(cfg),
               int(cfg.use_viewdirs), HS, SLOT, len(tc_gemms(cfg)))
    k = encoder_tables(cfg)[2]
    kind[:k.size] = k
    return src, plane, src16, desc


_TC_STATIC: Dict[tuple, tuple] = {}


def _tc_static(cfg: NeRFConfig, device: torch.device, bf16: bool = False):
    """``tc_sources`` on ``device`` (src, plane, desc, and under bf16 src16
    and the mask of its bf16 values), made once per architecture, type and
    device (it holds no parameter value)."""
    key = (cfg, str(device), bf16)
    if key not in _TC_STATIC:
        src, plane, src16, desc = tc_sources(cfg, bf16)
        entry = (torch.from_numpy(src).to(device), torch.from_numpy(plane).to(device),
                 common.upload(desc, device))
        if bf16:
            in16 = np.repeat(plane == PLANE_BF16, 2)
            entry += (torch.from_numpy(src16).to(device), torch.from_numpy(in16).to(device))
        _TC_STATIC[key] = entry
    return _TC_STATIC[key]


def pack_network_tc(params: Dict[str, torch.Tensor], cfg: NeRFConfig, device,
                    compute_dtype=torch.float32):
    """(weights, desc, HS, SLOT) for the tensor-core kernels B1, B3 and B4:
    the fp32 buffer laid out by ``tc_layout`` (GEMM weights split by
    ``tf32_split`` into their two planes; under ``compute_dtype`` bfloat16
    rounded to bf16, one plane, and the narrow heads' weights and biases
    rounded in place), the int64 ``Desc`` of ``csrc/mlp_tile_tc.cuh`` on ``device``
    and the strides of ``tc_strides``. The buffer is made from the
    parameters on every call, in a few launches: one gather by
    ``tc_sources``, then the split or the rounding."""
    device = torch.device(device)
    check_config(cfg)
    check_params(params, cfg, device)
    bf16 = is_bf16(compute_dtype)
    src, plane, desc, *src16 = _tc_static(cfg, device, bf16)
    HS, SLOT = tc_strides(cfg, bf16)
    return gather_pack(flat_params(params, cfg, device), src, plane, *src16), desc, HS, SLOT


def encoder_buffer(cfg: NeRFConfig, device) -> torch.Tensor:
    """The point-major encoder table of B1 and B2, float32 [2 * MAX_EMB]:
    per compact embedding column its frequency, then its input (0-2 the
    point, 3-5 the view direction)."""
    src, scale, _ = encoder_tables(cfg)
    buf = np.zeros(2 * MAX_EMB, np.float32)
    buf[:scale.size] = scale
    buf[MAX_EMB:MAX_EMB + src.size] = src
    return common.upload(buf, device)


def plain_nerf_forward_rays(params, cfg: NeRFConfig, rays_o, rays_d, z, viewdirs,
                            compute_dtype=torch.float32):
    """The plain PyTorch version of B3 (of its bf16 instantiation under
    ``compute_dtype`` bfloat16): the network on o + z·d -> raw [N, S, C]."""
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z[..., None]
    return plain_nerf_forward(params, cfg, pts, viewdirs, compute_dtype)


def twin_nerf_forward_rays(params, cfg: NeRFConfig, rays_o, rays_d, z, viewdirs,
                           compute_dtype=torch.float32):
    """What B3's backward differentiates: ``apply_nerf`` at the compute
    dtype on o + z·d, the JAX package's remat twin (fused_mlp.py
    ``_fused_rays_bwd``). In fp32 it is B3's plain version."""
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z[..., None]
    return apply_nerf(params, cfg, pts, viewdirs, compute_dtype)


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


def _launch(params, cfg, rays_o, rays_d, z, viewdirs,
            compute_dtype=torch.float32) -> torch.Tensor:
    """Kernel B3 (its bf16 instantiation under ``compute_dtype`` bfloat16)
    on CUDA tensors."""
    global LAUNCHES, LAUNCHES_BF16
    n, S = _check_rays(cfg, rays_o, rays_d, z, viewdirs)
    C = out_channels(cfg)
    out = torch.empty((n, S, C), dtype=torch.float32, device=z.device)
    if n * S == 0:
        return out
    check_in("B3", compute_dtype, "fused_nerf_forward_rays", params, rays_o=rays_o,
             rays_d=rays_d, z=z, viewdirs=viewdirs)
    bf16 = is_bf16(compute_dtype)
    fn = common.load("fused_mlp", _ARGS,
                     "nstt_rays_forward_bf16" if bf16 else "nstt_rays_forward_tc")
    with torch.cuda.device(z.device):
        wbuf, desc, HS, SLOT = pack_network_tc(params, cfg, z.device, compute_dtype)
        A, B = ray_encoder_args(cfg, rays_o, rays_d, viewdirs)
        stream = torch.cuda.current_stream(z.device).cuda_stream
        rc = fn(desc.data_ptr(), *entry_sizes(cfg, bf16, HS, SLOT), wbuf.data_ptr(),
                A.data_ptr(), B.data_ptr(), z.data_ptr(), out.data_ptr(), n, S, stream)
    common.check_launch(rc, "fused_mlp (B3 bf16)" if bf16 else "fused_mlp (B3)")
    if bf16:
        LAUNCHES_BF16 += 1
    else:
        LAUNCHES += 1
    check_out("B3", compute_dtype, "fused_nerf_forward_rays", raw=out)
    return out


def _plain_rays(params, cfg, rays_o, rays_d, z, viewdirs, compute_dtype):
    """B3's plain version between its --debug_nans checks (a CPU tensor)."""
    check_in("B3", compute_dtype, "fused_nerf_forward_rays", params, rays_o=rays_o,
             rays_d=rays_d, z=z, viewdirs=viewdirs)
    raw = plain_nerf_forward_rays(params, cfg, rays_o, rays_d, z, viewdirs, compute_dtype)
    check_out("B3", compute_dtype, "fused_nerf_forward_rays", raw=raw)
    return raw


class _RaysFn(torch.autograd.Function):
    """B3 forward (on the CPU, under bf16, its plain version), backward
    through ``twin_nerf_forward_rays`` at the compute dtype."""

    @staticmethod
    def forward(ctx, cfg, names, dtype, rays_o, rays_d, z, viewdirs, *weights):
        ctx.cfg, ctx.names, ctx.dtype, ctx.n_lead = cfg, names, dtype, 3
        ctx.save_for_backward(rays_o, rays_d, z, viewdirs, *weights)
        params = dict(zip(names, weights))
        if rays_o.device.type == "cpu":
            return _plain_rays(params, cfg, rays_o, rays_d, z, viewdirs, dtype)
        return _launch(params, cfg, rays_o, rays_d, z, viewdirs, dtype)

    @staticmethod
    def backward(ctx, g):
        cfg, names = ctx.cfg, ctx.names

        def twin(ro, rd, zz, vd, *w):
            return twin_nerf_forward_rays(dict(zip(names, w)), cfg, ro, rd, zz, vd, ctx.dtype)

        grads = common.remat_grads(ctx, twin, ctx.saved_tensors, (g,))
        return (None, None, None, *grads)


def fused_nerf_forward_rays(params, cfg: NeRFConfig, rays_o, rays_d, z,
                            viewdirs: Optional[torch.Tensor],
                            compute_dtype=torch.float32) -> torch.Tensor:
    """raw [N, S, 4 | output_ch] of the network at pts = o + z·d: the plain
    version for CPU tensors, kernel B3 (its bf16 instantiation under
    ``compute_dtype`` bfloat16) for CUDA tensors."""
    check_ray_config(cfg, "B3")
    if rays_o.device.type == "cpu" and not is_bf16(compute_dtype):
        return _plain_rays(params, cfg, rays_o, rays_d, z, viewdirs, compute_dtype)
    if rays_o.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_nerf_forward_rays: no kernel for {rays_o.device}")
    names = tuple(torch_param_order(cfg))
    return _RaysFn.apply(cfg, names, compute_dtype, rays_o, rays_d, z, viewdirs,
                         *[params[k] for k in names])


def check_points(cfg: NeRFConfig, pts, viewdirs):
    """(N, S): raise unless pts is a contiguous float32 [..., S, 3] (under
    IPE the Gaussian records [..., S, 6]) and viewdirs (with a viewdir
    head) a contiguous float32 [..., 3] on the same device, one direction
    per ray of S samples. N counts points."""
    dev = pts.device
    w = cfg.point_width
    if pts.dim() < 2 or pts.shape[-1] != w:
        raise ValueError(f"pts has shape {tuple(pts.shape)}, expected [..., S, {w}]")
    common.check_tensor(pts, "pts", tuple(pts.shape), dev)
    if cfg.use_viewdirs:
        if viewdirs is None:
            raise ValueError("cfg.use_viewdirs needs viewdirs")
        common.check_tensor(viewdirs, "viewdirs", tuple(pts.shape[:-2]) + (3,), dev)
    elif viewdirs is not None:
        raise ValueError("viewdirs given to a network without a viewdir head")
    S = pts.shape[-2]
    return pts.numel() // w, S


_POINT_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
# the training launch's entries: the same, then hbuf, hseg, n_pad
_POINT_TRAIN_ARGS = _POINT_ARGS + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]


def point_symbol(cfg: NeRFConfig, bf16: bool, train: bool = False) -> str:
    """B1's C entry for ``cfg`` (its IPE instantiation takes fp32 only);
    ``train``: the fp32 training launch's, which also writes B2's H."""
    if bf16 and (cfg.ipe or train):
        raise ValueError("B1's IPE instantiation (mip-NeRF) and its training launch "
                         "compute in fp32 only")
    if train:
        return "nstt_points_train_ipe" if cfg.ipe else "nstt_points_train_tc"
    if cfg.ipe:
        return "nstt_points_forward_ipe"
    return "nstt_points_forward_bf16" if bf16 else "nstt_points_forward_tc"


def launch_points(params, cfg: NeRFConfig, pts, viewdirs,
                  compute_dtype=torch.float32, hout=None) -> torch.Tensor:
    """Kernel B1 (its bf16 instantiation under ``compute_dtype`` bfloat16,
    its IPE one for an IPE config) on CUDA tensors -> raw [..., S, C]; no
    autograd. ``hout`` (fp32; ``fused_mlp_bwd.forward_saving_h``): (hbuf,
    hseg, n_pad), B2's H buffer for n_pad points and its int64 segment
    table [N_SEG, 2] on the device (``fused_mlp_bwd.act_layout``): the
    training launch, which also writes every layer input there."""
    global POINT_LAUNCHES, POINT_LAUNCHES_BF16, POINT_LAUNCHES_IPE, IPE_POINTS, SAVED_H_POINTS
    n, S = check_points(cfg, pts, viewdirs)
    C = out_channels(cfg)
    out = torch.empty(pts.shape[:-1] + (C,), dtype=torch.float32, device=pts.device)
    if n == 0:
        return out
    check_in("B1", compute_dtype, "launch_points", params, pts=pts, viewdirs=viewdirs)
    bf16 = is_bf16(compute_dtype)
    train = hout is not None
    fn = common.load("fused_mlp", _POINT_TRAIN_ARGS if train else _POINT_ARGS,
                     point_symbol(cfg, bf16, train))
    extra = ()
    if train:
        hbuf, hseg, n_pad = hout
        extra = (hbuf.data_ptr(), hseg.data_ptr(), n_pad)
    with torch.cuda.device(pts.device):
        wbuf, desc, HS, SLOT = pack_network_tc(params, cfg, pts.device, compute_dtype)
        enc = encoder_buffer(cfg, pts.device)
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        rc = fn(desc.data_ptr(), *entry_sizes(cfg, bf16, HS, SLOT), wbuf.data_ptr(),
                enc.data_ptr(), pts.data_ptr(),
                viewdirs.data_ptr() if viewdirs is not None else 0, out.data_ptr(), n, S,
                stream, *extra)
    common.check_launch(rc, "fused_mlp points (B1 bf16)" if bf16 else "fused_mlp points (B1)")
    if cfg.ipe:
        POINT_LAUNCHES_IPE += 1
        IPE_POINTS += n
    elif bf16:
        POINT_LAUNCHES_BF16 += 1
    else:
        POINT_LAUNCHES += 1
    if train:
        SAVED_H_POINTS += n
    check_out("B1", compute_dtype, "launch_points", raw=out)
    return out


def fused_nerf_forward(params, cfg: NeRFConfig, pts,
                       viewdirs: Optional[torch.Tensor],
                       compute_dtype=torch.float32) -> torch.Tensor:
    """raw [..., S, 4 | output_ch] of the network at pts [..., S, 3] with
    view directions [..., 3]: the plain version for CPU tensors (in fp32
    ``apply_nerf``), kernel B1 (its bf16 instantiation under
    ``compute_dtype`` bfloat16) for CUDA tensors, differentiated by kernel
    B2 (``fused_mlp_bwd.fused_train_op``)."""
    if pts.device.type == "cpu" and not is_bf16(compute_dtype):
        check_in("B1", compute_dtype, "fused_nerf_forward", params, pts=pts, viewdirs=viewdirs)
        raw = apply_nerf(params, cfg, pts, viewdirs)
        check_out("B1", compute_dtype, "fused_nerf_forward", raw=raw)
        return raw
    if pts.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_nerf_forward: no kernel for {pts.device}")
    from nerf_shared_tpu_torch.ops.cuda.fused_mlp_bwd import fused_train_op
    return fused_train_op(params, cfg, pts, viewdirs, compute_dtype)


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
