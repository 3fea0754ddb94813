"""The split-fp32 (3xTF32) tensor-core numerics of kernels B3 and B4
(csrc/mlp_tile_tc.cuh) on the CPU.

A CUDA kernel cannot run here, so these tests hold its arithmetic and its
pack:

- a plain-torch emulation of the kernel's GEMMs (tf32 round-to-nearest by
  integer bit operations, the big / small split of every operand, three
  products a multiply-add accumulated in fp32 slice by slice over K padded
  to 8) walks ``pack_network_tc``'s buffer and descriptor, and is held
  against the plain fp32 version and against the JAX package's Pallas ray
  and render kernels (interpret mode) within B3's 2e-4 x max(1, max|raw|),
  at the lego width and at chip_smoke.py's ``check_other_shapes``
  architectures; the same emulation with one TF32 product a multiply-add
  (plain TF32) misses chip_smoke.py's fp32-accuracy gate, which split
  fp32 meets;
- the pack round-trips to the parameters, and every padded entry is zero;
- B4's tiling: the composite walked in flat tiles that span rays, with the
  transmittance carried from tile to tile, is raw2outputs.

The kernels themselves are held against the plain versions on the card by
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_shared_tpu.models import nerf as jnerf
from nerf_shared_tpu.ops.pallas.fused_mlp import fused_nerf_forward_rays as j_b3
from nerf_shared_tpu.ops.pallas.fused_render import fused_render_rays as j_b4
from nerf_shared_tpu_torch.models import nerf as tnerf
from nerf_shared_tpu_torch.ops.compositing import raw2outputs
from nerf_shared_tpu_torch.ops.cuda import fused_mlp

LEGO = dict(D=8, W=256, skips=(4,), multires=10, multires_views=4)
# chip_smoke.py check_other_shapes
OTHER = [dict(D=3, W=64, skips=(1,), use_viewdirs=False, output_ch=5),
         dict(D=8, W=256, skips=(4,), multires=15, multires_views=6),
         dict(D=2, W=30, skips=(0,), i_embed=-1),
         dict(D=5, W=128, skips=(1, 3), multires=6, multires_views=2)]
TOL = 2e-4  # B3's tolerance, scaled by max(1, max|want|)
FP32_TOL = 5e-6  # chip_smoke.py FP32_TOL: B3's and B4's fp32-accuracy gate


def _models(seed=0, **kw):
    jcfg = jnerf.NeRFConfig(**kw)
    jp = jnerf.init_nerf_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jp, tnerf.NeRFConfig(**kw), tnerf.params_from_jax(jax.device_get(jp))


def _rays(n, S, seed):
    rng = np.random.default_rng(seed)
    ro = rng.standard_normal((n, 3)).astype(np.float32) * 0.1
    rd = rng.standard_normal((n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, -1, keepdims=True)
    z = np.sort((rng.random((n, S)) * 4 + 2).astype(np.float32), -1)
    return ro, rd, z


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a, np.float32))


# --- split fp32 --------------------------------------------------------------


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round fp32 to 10 mantissa bits, to nearest with
    ties away from zero (the magnitude bits carry into the exponent)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    big = tf32(x)
    return big, tf32(x - big)


def mm3(a: torch.Tensor, w_big: torch.Tensor, w_small: torch.Tensor,
        products: int = 3) -> torch.Tensor:
    """a [M, K] @ w [K, N] as the kernel forms it from the split planes of
    w: a split here, and for each 8-row slice of K in order, small·big' +
    big·small' + big·big' added to an fp32 accumulator (``products`` 1:
    big·big' alone, plain TF32). K must be a multiple of 8."""
    acc = torch.zeros(a.shape[0], w_big.shape[1], dtype=torch.float32)
    for k in range(0, a.shape[1], 8):
        ab, as_ = split(a[:, k:k + 8])
        wb, ws = w_big[k:k + 8], w_small[k:k + 8]
        acc = acc + (as_ @ wb + ab @ ws + ab @ wb if products == 3 else ab @ wb)
    return acc


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10          # representable in tf32
    half_ulp = 2.0 ** -11
    x = torch.tensor([1.0 + half_ulp, -(1.0 + half_ulp), one + half_ulp * 0.99,
                      one, 0.0], dtype=torch.float32)
    got = tf32(x)
    want = torch.tensor([one, -one, one, one, 0.0])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    r = torch.randn(10000, generator=torch.Generator().manual_seed(0))
    assert (tf32(r).view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((tf32(r) - r).abs() <= r.abs() * 2.0 ** -11).all()


def test_host_split_is_the_kernels_split():
    """The pack splits the weights on the host (fused_mlp.tf32_split) as
    the kernel splits activations in registers (cvt.rna.tf32.f32)."""
    w = torch.randn(4096, generator=torch.Generator().manual_seed(2)) * 3
    big, small = fused_mlp.tf32_split(w)
    want_big, want_small = split(w)
    torch.testing.assert_close(big, want_big, rtol=0, atol=0)
    torch.testing.assert_close(small, want_small, rtol=0, atol=0)
    assert ((big + small - w).abs() <= w.abs() * 2.0 ** -21).all()


def test_split_fp32_keeps_fp32_accuracy():
    """Three TF32 products land within fp32 rounding of the float64
    product; one TF32 product (plain TF32) misses it by ~2^-11."""
    g = torch.Generator().manual_seed(1)
    a = torch.randn(64, 256, generator=g)
    w = torch.randn(256, 128, generator=g) / 16
    exact = (a.double() @ w.double())
    scale = float(exact.abs().max())
    err3 = float((mm3(a, *fused_mlp.tf32_split(w)).double() - exact).abs().max()) / scale
    err32 = float(((a @ w).double() - exact).abs().max()) / scale
    err1 = float(((tf32(a) @ tf32(w)).double() - exact).abs().max()) / scale
    assert err3 < 4 * max(err32, 2.0 ** -23) and err3 < 1e-6
    assert err1 > 1e-4 > 100 * err3


# --- the network on the pack ---------------------------------------------------


def _desc(desc):
    d = desc.numpy()
    G = fused_mlp.MAX_GEMMS
    hdr = d[:16]
    gemm = d[16:16 + 8 * G].reshape(G, 8)
    narrow = d[16 + 8 * G:16 + 8 * G + 12].reshape(3, 4)
    kind = d[16 + 8 * G + 12:].view(np.int8)
    return hdr, gemm, narrow, kind


def _planes(flat, w_off, Kp, Np):
    """A GEMM's [Kp, Np] big and small weight planes back out of its slices
    (fused_mlp.slice_floats, slice_index)."""
    v = flat[w_off:w_off + Kp // 8 * fused_mlp.slice_floats(Np)].view(Kp // 8, 2, 8 * Np)
    at = fused_mlp.slice_index(Np).reshape(-1)
    return [v[:, plane, at].reshape(Kp, Np) for plane in (0, 1)]


def emulate_tc(wbuf, desc, A, B, z, products=3):
    """raw [N, S, OUT] of csrc/mlp_tile_tc.cuh on the pack: the encoder and
    bias adds in fp32, the GEMMs through mm3 (with ``products``), the
    narrow heads in fp32."""
    hdr, gemm, narrow, kind = _desc(desc)
    D, W, P, V, OUT, VD, HS, SLOT, NG = (int(v) for v in hdr[:9])
    P8, V8 = (P + 7) // 8 * 8, (V + 7) // 8 * 8
    n, S = z.shape
    arg = A[:, None, :] + z[..., None] * B[:, None, :]
    k = torch.from_numpy(kind[:P + V].astype(np.int64))
    emb = torch.where(k == 0, arg, torch.where(k == 1, torch.sin(arg), torch.cos(arg)))
    emb = emb.reshape(n * S, P + V)
    srcs = {fused_mlp.SRC_PTS: torch.nn.functional.pad(emb[:, :P], (0, P8 - P)),
            fused_mlp.SRC_DIRS: torch.nn.functional.pad(emb[:, P:], (0, V8 - V))}
    raw = torch.zeros(n * S, 8)

    def head(row, x, col):
        w_off, b_off, K, N = (int(v) for v in narrow[row])
        wn = wbuf[w_off:w_off + N * K].view(N, K)
        raw[:, col:col + N] = x[:, :K] @ wn.t() + wbuf[b_off:b_off + N]

    h = None
    for gi in range(NG):
        w_off, b_off, Np, ns0, src0, ns1, src1, relu = (int(v) for v in gemm[gi])
        Kp = 8 * (ns0 + ns1)
        a = torch.cat([h if s == fused_mlp.SRC_H else srcs[s]
                       for s, ns in ((src0, ns0), (src1, ns1)) if ns], -1)
        assert a.shape[1] == Kp
        out = mm3(a, *_planes(wbuf, w_off, Kp, Np), products) + wbuf[b_off:b_off + Np]
        h = out.clamp_min(0.0) if relu else out
        if gi == D - 1:
            head(0, h, 3) if VD else head(2, h, 0)
    if VD:
        head(1, h, 0)
    return raw[:, :OUT].reshape(n, S, OUT)


def _tc_raw(tp, tcfg, ro, rd, z, vd, products=3):
    wbuf, desc, _, _ = fused_mlp.pack_network_tc(tp, tcfg, "cpu")
    A, B = fused_mlp.ray_encoder_args(tcfg, _t(ro), _t(rd), _t(vd))
    return emulate_tc(wbuf, desc, A, B, _t(z), products)


def _check(got, want):
    want = torch.from_numpy(np.array(want, np.float32))
    err = float((got - want).abs().max())
    assert err <= TOL * max(1.0, float(want.abs().max())), err


@pytest.mark.parametrize("kw", [LEGO] + OTHER, ids=["lego", "no_viewdirs",
                                                    "stonehenge", "identity_w30",
                                                    "two_skips"])
def test_split_fp32_network_matches_plain_and_pallas(kw):
    jcfg, jp, tcfg, tp = _models(seed=2, **kw)
    ro, rd, z = _rays(5, 7, seed=3)
    vd = rd if tcfg.use_viewdirs else None
    got = _tc_raw(tp, tcfg, ro, rd, z, vd)
    _check(got, fused_mlp.plain_nerf_forward_rays(tp, tcfg, _t(ro), _t(rd), _t(z), _t(vd)))
    want = j_b3(jp, jcfg, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z),
                None if vd is None else jnp.asarray(vd))
    _check(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fp32_gate_separates_split_fp32_from_plain_tf32(seed):
    """The fp32-accuracy gate on B3's raw (FP32_TOL of max(1, max|plain|))
    at the lego width with the port's seeded init: the split-fp32
    emulation is far inside it, one TF32 product a multiply-add (plain
    TF32, which the fp32 path does not allow) is outside it."""
    tcfg = tnerf.NeRFConfig(**LEGO)
    tp = {k: v.detach() for k, v in tnerf.NeRF(
        tcfg, generator=torch.Generator().manual_seed(seed)).params().items()}
    ro, rd, z = _rays(8, 16, seed=seed)
    want = fused_mlp.plain_nerf_forward_rays(tp, tcfg, _t(ro), _t(rd), _t(z), _t(rd))
    scale = max(1.0, float(want.abs().max()))
    err3, err1 = (float((_tc_raw(tp, tcfg, ro, rd, z, rd, products=p) - want).abs().max())
                  / scale for p in (3, 1))
    assert err3 < FP32_TOL / 10 and err1 > 2 * FP32_TOL, (err3, err1)


@pytest.mark.parametrize("white_bkgd", [True, False])
def test_split_fp32_composite_matches_pallas_render_kernel(white_bkgd):
    """B4's numerics: the emulated network through raw2outputs against the
    Pallas render kernel, on rays clear of the 1e10 sentinel's flip."""
    jcfg, jp, tcfg, tp = _models(seed=4, **LEGO)
    ro, rd, z = _rays(24, 12, seed=5)
    raw = _tc_raw(tp, tcfg, ro, rd, z, rd)
    got = raw2outputs(raw, _t(z), _t(rd), white_bkgd=white_bkgd)
    want = j_b4(jp, jcfg, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z),
                jnp.asarray(rd), white_bkgd=white_bkgd, want_weights=True)
    mask = raw[:, -1, 3].abs() >= 1e-2
    assert int(mask.sum()) >= 8
    for g, w in zip(got, want):
        _check(g[mask], np.asarray(w)[mask.numpy()])


# --- the pack ------------------------------------------------------------------


def unpack_tc(wbuf, tcfg):
    """The parameters back out of pack_network_tc's buffer (GEMM weights as
    their (big, small) planes), a mask of the entries they occupy and one
    of the small planes' entries (0 where a weight is a TF32 number)."""
    layout, size = fused_mlp.tc_layout(tcfg)
    used = torch.zeros(size, dtype=torch.bool)
    small = torch.zeros(size, dtype=torch.bool)
    where = torch.arange(size)
    params = {}
    for name, segs, N, _ in fused_mlp.tc_gemms(tcfg):
        w_off, b_off, Kp, Np = layout[name]
        planes, at = _planes(wbuf, w_off, Kp, Np), _planes(where, w_off, Kp, Np)
        rows = [[], []]
        row = 0
        for _, k in segs:
            for i in (0, 1):
                rows[i].append(planes[i][row:row + k, :N])
                used[at[i][row:row + k, :N].reshape(-1)] = True
            small[at[1][row:row + k, :N].reshape(-1)] = True
            row += (k + 7) // 8 * 8
        params[name + ".weight"] = tuple(torch.cat(r, 0).t() for r in rows)
        params[name + ".bias"] = wbuf[b_off:b_off + N]
        used[b_off:b_off + N] = True
    for _, name, K, N in fused_mlp.tc_narrow_heads(tcfg):
        w_off, b_off, _, _ = layout[name]
        params[name + ".weight"] = wbuf[w_off:w_off + N * K].view(N, K)
        params[name + ".bias"] = wbuf[b_off:b_off + N]
        used[w_off:w_off + N * K] = True
        used[b_off:b_off + N] = True
    return params, used, small


@pytest.mark.parametrize("kw", [LEGO] + OTHER, ids=["lego", "no_viewdirs",
                                                    "stonehenge", "identity_w30",
                                                    "two_skips"])
def test_tc_pack_round_trips_and_pads_with_zeros(kw):
    """Unpacking gives back every parameter: the narrow heads and biases
    exactly, a GEMM weight as its split (big, small) planes, big + small
    within 2^-21 of it. Every padded entry is zero."""
    _, _, tcfg, tp = _models(seed=6, **kw)
    tp = {k: v + 0.5 for k, v in tp.items()}   # no parameter entry is zero
    wbuf, desc, HS, SLOT = fused_mlp.pack_network_tc(tp, tcfg, "cpu")
    params, used, small = unpack_tc(wbuf, tcfg)
    assert set(params) == set(tp)
    for name, t in tp.items():
        got = params[name]
        if isinstance(got, tuple):
            for a, b in zip(got, fused_mlp.tf32_split(t)):
                torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
            assert ((got[0] + got[1] - t).abs() <= t.abs() * 2.0 ** -21).all(), name
        else:
            torch.testing.assert_close(got, t, rtol=0, atol=0, msg=name)
    assert wbuf[~used].eq(0).all() and wbuf[used & ~small].ne(0).all()
    # every block 64-byte aligned; K padded to 8, N to a power of two >= 32
    hdr, gemm, narrow, _ = _desc(desc)
    NG = int(hdr[8])
    assert NG == len(fused_mlp.tc_gemms(tcfg))
    for w_off, b_off, Np, ns0, _, ns1, _, _ in gemm[:NG]:
        assert w_off % 16 == 0 and b_off % 16 == 0 and Np >= 32 and Np & (Np - 1) == 0
        assert Np <= HS - 4
    assert all(w_off % 16 == 0 for w_off in narrow[:, 0])
    # conflict-free A-fragment loads: rows of h 4 mod 8 floats; a ring slot
    # holds the widest slice
    assert HS % 8 == 4 and (int(hdr[6]), int(hdr[7])) == (HS, SLOT)
    assert SLOT == max(fused_mlp.slice_floats(int(Np)) for Np in gemm[:NG, 2])


def test_slice_index_is_the_k_major_core_matrix_layout():
    """Within a plane, weight (k, n) of a slice sits in core matrix (n // 8,
    k // 4): 8 columns x 4 k-values, 128 contiguous bytes; the two k-halves
    32 floats apart (the wgmma descriptor's leading offset, 128 bytes),
    column groups 64 floats apart (its stride offset, 256 bytes)."""
    at = fused_mlp.slice_index(64)
    assert sorted(at.reshape(-1).tolist()) == list(range(8 * 64))
    assert at[0, 0] == 0 and at[1, 0] == 1 and at[0, 1] == 4 and at[4, 0] == 32
    assert at[0, 8] == 64 and at[7, 15] == 64 + 32 + 7 * 4 + 3


def test_tc_pack_refuses_params_that_do_not_match_the_config():
    _, _, tcfg, tp = _models(D=3, W=32, skips=(1,))
    bad = dict(tp)
    bad["pts_linears.2.weight"] = torch.zeros(32, 31)
    with pytest.raises(ValueError, match="pts_linears.2.weight"):
        fused_mlp.pack_network_tc(bad, tcfg, "cpu")


# --- B4's tiling ---------------------------------------------------------------


def composite_by_tiles(raw, z, rays_d, white_bkgd, tp):
    """csrc/fused_render.cu's composite: the flat samples (r * S + s) in
    tiles of tp that span rays, one walk per ray segment of a tile, the
    transmittance and sums carried into the next tile while a ray is open.
    Returns rgb, disp, acc, weights, depth."""
    n, S = z.shape
    dn = torch.linalg.norm(rays_d, dim=-1)
    z_next = torch.cat([z[:, 1:], torch.full((n, 1), 1e10)], -1)
    dist = torch.where(torch.arange(S) < S - 1, z_next - z, torch.full_like(z, 1e10))
    alpha = (1.0 - torch.exp(-raw[..., 3].clamp_min(0.0) * dist * dn[:, None])).reshape(-1)
    rgb = torch.sigmoid(raw[..., :3]).reshape(-1, 3)
    zf = z.reshape(-1)
    out8 = torch.zeros(n, 8)
    weights = torch.zeros(n * S)
    carry = None
    for p0 in range(0, n * S, tp):
        for q in range(p0, min(p0 + tp, n * S)):
            r, s = divmod(q, S)
            if s != 0 and q != p0:
                continue
            T, c, dep, acc = carry if s != 0 else (1.0, torch.zeros(3), 0.0, 0.0)
            k = q
            while k < min(p0 + tp, (r + 1) * S):
                w = float(alpha[k]) * T
                T = T * ((1.0 - float(alpha[k])) + 1e-10)
                c, dep, acc = c + w * rgb[k], dep + w * float(zf[k]), acc + w
                weights[k] = w
                k += 1
            if k == (r + 1) * S:
                bg = 1.0 - acc if white_bkgd else 0.0
                out8[r, :3] = c + bg
                out8[r, 3] = 1.0 / max(1e-10, dep / max(acc, 1e-10))
                out8[r, 4], out8[r, 5] = acc, dep
            else:
                carry = (T, c, dep, acc)
    return (out8[:, :3], out8[:, 3], out8[:, 4], weights.reshape(n, S), out8[:, 5])


@pytest.mark.parametrize("n,S,tp", [(6, 64, 128), (3, 192, 128), (5, 7, 128),
                                    (4, 65, 64), (9, 1, 64)])
def test_b4_tiles_spanning_rays_composite_like_raw2outputs(n, S, tp):
    g = torch.Generator().manual_seed(S)
    raw = torch.randn(n, S, 4, generator=g) * 2
    z = torch.sort(2 + 4 * torch.rand(n, S, generator=g), -1).values
    rays_d = torch.randn(n, 3, generator=g)
    for white in (False, True):
        got = composite_by_tiles(raw, z, rays_d, white, tp)
        want = raw2outputs(raw, z, rays_d, white_bkgd=white)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
