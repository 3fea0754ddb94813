"""The bf16 forward tile of kernels B1, B3 and B4 (``csrc/mlp_tile_bf16.cuh``)
on the CPU: its shared-memory operand layout, its weight stages, and an
emulation of its walk over the pack.

- The operand blocks (each consumer warpgroup's activations h and encoded
  inputs, bf16) are held against wgmma's canonical K-major layout without
  swizzle, the one the weight slices already use (``slice_index_bf16``).
- The stage plan (``fused_mlp.bf16_stage_plan``) is held at four
  architectures against the pack's layout and descriptor.
- ``emulate_tile`` walks ``pack_network_tc(..., torch.bfloat16)``'s buffer
  stage by stage as the kernel does: each warpgroup takes its 64 rows of a
  128-point tile, its operands read from byte images of the blocks through
  the descriptors' offsets, its k16 products chained in fp32 in slice
  order. It equals ``tests/test_torch_bf16.py``'s ``bf16_tile`` and the
  plain bf16 version to fp32 rounding, and the Pallas bf16 kernel within
  that file's tolerance.

The CUDA kernels themselves are held against the plain versions on the
card by ``chip_smoke.py`` (phase 15).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_shared_tpu.ops.pallas import fused_mlp as jfm
from nerf_shared_tpu_torch.models import nerf as tnerf
from nerf_shared_tpu_torch.ops.cuda import fused_mlp
from tests.test_torch_bf16 import _close, _desc, _models, _rays, _t, bf16_tile

ARCHS = [dict(), dict(use_viewdirs=False, output_ch=5),
         dict(D=2, W=30, skips=(0,), i_embed=-1),
         dict(D=8, W=256, skips=(4,), multires=10, multires_views=4)]
IDS = ["d4w64", "no_viewdirs", "identity_w30", "lego"]
ROWS = fused_mlp.TILE_WG_ROWS
# wgmma's descriptor fields: the weight slices' (slice_index_bf16) and the
# operand blocks' leading and stride byte offsets
B_LBO, B_SBO = 128, 256
A_LBO, A_SBO = fused_mlp.OPERAND_KCHUNK, fused_mlp.OPERAND_CORE


def canonical(start, lbo, sbo, rows, k):
    """Byte address of (row, k) of a K-major operand in wgmma's canonical
    layout without swizzle: core matrices of 8 rows x 16 bytes (a row's 8
    k-values contiguous, rows 16 bytes apart), core matrices adjacent in K
    ``lbo`` bytes apart, adjacent in rows ``sbo`` bytes apart."""
    return start + (k // 8) * lbo + (rows // 8) * sbo + (rows % 8) * 16 + (k % 8) * 2


def desc_fields(start, lbo, sbo):
    """A no-swizzle wgmma descriptor's 64 bits, and its fields decoded."""
    word = ((start & 0x3FFFF) >> 4) | ((lbo >> 4) << 16) | ((sbo >> 4) << 32)
    return word, ((word & 0x3FFF) << 4, ((word >> 16) & 0x3FFF) << 4,
                  ((word >> 32) & 0x3FFF) << 4, word >> 62)


@pytest.mark.parametrize("K", [96, 256])
def test_operand_blocks_are_wgmmas_k_major_layout(K):
    """operand_offset places (row p, column k) of a warpgroup's block where a
    descriptor of leading offset OPERAND_KCHUNK and stride offset
    OPERAND_CORE reads it, for every k16 sub-block the GEMMs read; the
    block is dense (each byte pair once); the weight slices lay out in the
    same canonical form (leading 128, stride 256), so one reader serves
    both operands; a warp's epilogue and encoder stores of one column group
    fill one 128-byte core matrix (no bank conflict); the descriptors'
    fields survive their 14-bit encoding."""
    p = torch.arange(ROWS)[:, None].expand(ROWS, K)
    k = torch.arange(K)[None, :].expand(ROWS, K)
    off = fused_mlp.operand_offset(p, k)
    assert sorted(off.reshape(-1).tolist()) == list(range(0, 2 * ROWS * K, 2))
    for k0 in range(0, K, 16):
        sub = canonical((k0 // 8) * A_LBO, A_LBO, A_SBO, p[:, :16], k[:, :16])
        assert torch.equal(sub, off[:, k0:k0 + 16])
    for Np in (32, 128, 256):
        n = torch.arange(Np)[None, :].expand(16, Np)
        kk = torch.arange(16)[:, None].expand(16, Np)
        assert torch.equal(2 * fused_mlp.slice_index_bf16(Np), canonical(0, B_LBO, B_SBO, n, kk))
    lane = torch.arange(32)
    for warp in range(4):
        for j in range(K // 8):
            for half in (0, 8):
                rows = 16 * warp + lane // 4 + half
                got = fused_mlp.operand_offset(rows, 8 * j + 2 * (lane % 4))
                assert sorted(got.tolist()) == list(range(int(got.min()), int(got.min()) + 128, 4))
                assert int(got.min()) % 128 == 0
    for start, lbo, sbo in ((0x1F000, A_LBO, A_SBO), (0x2C400, B_LBO, B_SBO)):
        word, fields = desc_fields(start, lbo, sbo)
        assert fields == (start, lbo, sbo, 0) and word < 1 << 62


@pytest.mark.parametrize("kw", ARCHS, ids=IDS)
def test_stage_plan_covers_each_gemm_in_stages_of_64_rows(kw):
    """bf16_stage_plan: each GEMM's 16-row slices in order, in stages of up
    to STAGE_SLICES, only its last stage shorter; each stage one contiguous
    run of the pack (the bytes its slices fill) starting where its first
    slice starts; slices per GEMM as the descriptor counts them; no stage
    larger than a ring slot (STAGE_SLICES x SLOT floats). The encoded-input
    block's width is the one the kernel derives from the descriptor."""
    _, _, tcfg, tp = _models(seed=5, **kw)
    wbuf, desc, HS, SLOT = fused_mlp.pack_network_tc(tp, tcfg, "cpu", torch.bfloat16)
    hdr, gemm, _ = _desc(desc)
    layout, _ = fused_mlp.tc_layout(tcfg, True)
    plan = fused_mlp.bf16_stage_plan(tcfg)
    S = fused_mlp.STAGE_SLICES
    for g, (name, _, _, _) in enumerate(fused_mlp.tc_gemms(tcfg)):
        w_off, _, Kp, Np = layout[name]
        mine = [st for st in plan if st[0] == g]
        ns = int(gemm[g][3] + gemm[g][5])
        assert ns == Kp // 16 and int(gemm[g][0]) == w_off and int(gemm[g][2]) == Np
        assert [st[1] for st in mine] == list(range(0, ns, S))
        assert [st[2] for st in mine] == [S] * (ns // S) + ([ns % S] if ns % S else [])
        sf = fused_mlp.slice_floats(Np, True)
        for _, s0, n, nbytes, off in mine:
            assert nbytes == n * 32 * Np == 4 * n * sf and off == w_off + s0 * sf
            assert nbytes <= 4 * S * SLOT
        assert sum(st[3] for st in mine) == 2 * Kp * Np
    assert [st[0] for st in plan] == sorted(st[0] for st in plan)
    P, V, VD = int(hdr[2]), int(hdr[3]), bool(hdr[5])
    assert fused_mlp.tile_emb_cols(tcfg) == (P + 15) // 16 * 16 + ((V + 15) // 16 * 16 if VD else 0)
    assert fused_mlp.entry_sizes(tcfg, True, HS, SLOT) == (SLOT, fused_mlp.tile_emb_cols(tcfg))
    assert fused_mlp.entry_sizes(tcfg, False, HS, SLOT) == (HS, SLOT)
    if kw == ARCHS[3]:
        assert len(plan) == 39 and fused_mlp.tile_emb_cols(tcfg) == 96


def _block(x, K):
    """A warpgroup's operand block as the kernel lays it: the bf16 values of
    x [64, <= K] (columns past x's zero) at operand_offset, as int16."""
    buf = torch.zeros(ROWS * K, dtype=torch.int16)
    p = torch.arange(ROWS)[:, None].expand(ROWS, x.shape[1])
    k = torch.arange(x.shape[1])[None, :].expand(ROWS, x.shape[1])
    buf[fused_mlp.operand_offset(p, k).reshape(-1) // 2] = \
        x.to(torch.bfloat16).contiguous().view(torch.int16).reshape(-1)
    return buf


def _read(buf16, start, lbo, sbo, rows, k=16):
    """[rows, k] fp32 values a descriptor (start, lbo, sbo) reads from a
    bf16 image (int16) in wgmma's canonical K-major layout."""
    r = torch.arange(rows)[:, None].expand(rows, k)
    kk = torch.arange(k)[None, :].expand(rows, k)
    return buf16[canonical(start, lbo, sbo, r, kk) // 2].view(torch.bfloat16).float()


def emulate_tile(wbuf, desc, emb):
    """raw [M, OUT] (M <= 128) of the bf16 tile on the pack, walked as the
    kernel walks it: each warpgroup's 64 rows (rows past M empty, zero
    inputs), its encoded inputs and activations in bf16 operand blocks,
    each GEMM's stages in ring order (bf16_stage_plan's, read off the
    descriptor), a stage's slices read from its bytes and chained into an
    fp32 accumulator in order, the epilogue's bias, ReLU and bf16 rounding
    written back into the block, the narrow heads in fp32."""
    hdr, gemm, narrow = _desc(desc)
    D, W, P, V, OUT, VD, HS, SLOT, NG = (int(v) for v in hdr[:9])
    P16, V16 = (P + 15) // 16 * 16, ((V + 15) // 16 * 16 if VD else 0)
    E, HW = P16 + V16, SLOT // 8
    pack16 = wbuf.view(torch.int16)
    M = emb.shape[0]
    x = torch.zeros(2 * ROWS, E)
    x[:M, :P] = emb[:, :P]
    if VD:
        x[:M, P16:P16 + V] = emb[:, P:P + V]
    raw = torch.zeros(2 * ROWS, 8)
    for wg in range(2):
        eb = _block(x[ROWS * wg:ROWS * (wg + 1)], E)
        hb = torch.zeros(ROWS * HW, dtype=torch.int16)
        seg = {fused_mlp.SRC_PTS: (eb, 0), fused_mlp.SRC_DIRS: (eb, P16),
               fused_mlp.SRC_H: (hb, 0)}

        def head(row, col):
            w_off, b_off, K, N = (int(v) for v in narrow[row])
            h = _read(hb, 0, A_LBO, A_SBO, ROWS, K)
            raw[ROWS * wg:ROWS * (wg + 1), col:col + N] = (
                h @ wbuf[w_off:w_off + N * K].view(N, K).t() + wbuf[b_off:b_off + N])

        for gi in range(NG):
            w_off, b_off, Np, ns0, src0, ns1, src1, relu = (int(v) for v in gemm[gi])
            ns, sf = ns0 + ns1, 8 * Np
            acc = torch.zeros(ROWS, Np)
            for s0 in range(0, ns, fused_mlp.STAGE_SLICES):
                n = min(fused_mlp.STAGE_SLICES, ns - s0)
                stage = pack16[2 * (w_off + s0 * sf):2 * (w_off + (s0 + n) * sf)]
                for j in range(n):
                    i = s0 + j
                    src, k0 = (src0, 16 * i) if i < ns0 else (src1, 16 * (i - ns0))
                    buf, col0 = seg[src]
                    a = _read(buf, ((col0 + k0) // 8) * A_LBO, A_LBO, A_SBO, ROWS)
                    b = _read(stage, j * 4 * sf, B_LBO, B_SBO, Np).t()
                    acc = acc + a @ b
            out = acc + wbuf[b_off:b_off + Np]
            hb = _block(out.clamp_min(0.0) if relu else out, HW)
            seg[fused_mlp.SRC_H] = (hb, 0)
            if gi == D - 1:
                head(0, 3) if VD else head(2, 0)
        if VD:
            head(1, 0)
    return raw[:M, :OUT]


@pytest.mark.parametrize("kw", ARCHS, ids=IDS)
def test_stage_walk_with_operands_in_shared_memory_matches_plain_and_pallas(kw):
    """emulate_tile over pack_network_tc(..., torch.bfloat16) on the
    point-major encoder's inputs equals bf16_tile and the plain version of
    bf16 B1 to fp32 rounding, and the Pallas bf16 kernel within 1e-2."""
    jcfg, jp, tcfg, tp = _models(seed=9, **kw)
    ro, rd, z = _rays(n=6, S=8, seed=14)
    pts = (ro[:, None] + rd[:, None] * z[..., None]).astype(np.float32)
    vd = rd if tcfg.use_viewdirs else None
    wbuf, desc, _, _ = fused_mlp.pack_network_tc(tp, tcfg, "cpu", torch.bfloat16)
    emb = tnerf.embed_inputs(tcfg, _t(pts), _t(vd)).reshape(48, -1)
    got = emulate_tile(wbuf, desc, emb).reshape(6, 8, -1)
    plain = fused_mlp.plain_nerf_forward(tp, tcfg, _t(pts), _t(vd), torch.bfloat16)
    atol = 1e-5 * max(1.0, float(plain.abs().max()))
    torch.testing.assert_close(got, bf16_tile(wbuf, desc, emb).reshape(6, 8, -1), rtol=0, atol=atol)
    torch.testing.assert_close(got, plain, rtol=0, atol=atol)
    want = jfm.fused_nerf_forward(jp, jcfg, jnp.asarray(pts),
                                  None if vd is None else jnp.asarray(vd),
                                  compute_dtype=jnp.bfloat16)
    _close(got, want)
