"""The training kernels' modules on the CPU: B1 (ops/cuda/fused_mlp.py
fused_nerf_forward) and B2 (ops/cuda/fused_mlp_bwd.py).

A CUDA kernel cannot run here, so these tests hold what surrounds it:

- the plain versions against the JAX package's Pallas kernels, run as the
  JAX suite runs them on the CPU (interpret mode; one 512-point grid step
  of the backward at this size);
- the CPU dispatch of fused_nerf_forward, fused_mlp_backward and
  fused_train_op, and the guards;
- the packs, descriptors and encoder table B2 reads, driven through a
  transcription of its arithmetic (csrc/fused_mlp_bwd.cu: the tile kernel
  on the tensor cores in split fp32 with 8-row slice sums, or one bf16
  product a 16-row slice, then the dW kernel and the reduction); B1's
  tensor-core arithmetic is emulated in tests/test_torch_tc_mlp.py.

The kernels themselves are held against the plain versions on the card by
chip_smoke.py (phase 5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from nerf_shared_tpu.models import nerf as jnerf
from nerf_shared_tpu.ops.pallas import fused_mlp as jfm
from nerf_shared_tpu.ops.pallas import fused_mlp_bwd as jbwd
from nerf_shared_tpu_torch.models import nerf as tnerf
from nerf_shared_tpu_torch.ops.cuda import common, fused_mlp, fused_mlp_bwd


def _models(D=3, W=32, skips=(1,), use_viewdirs=True, multires=6,
            multires_views=3, i_embed=0, output_ch=4, seed=0):
    kw = dict(D=D, W=W, skips=skips, use_viewdirs=use_viewdirs,
              multires=multires, multires_views=multires_views,
              i_embed=i_embed, output_ch=output_ch)
    jcfg = jnerf.NeRFConfig(**kw)
    jp = jnerf.init_nerf_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jp, tnerf.NeRFConfig(**kw), tnerf.params_from_jax(
        jax.device_get(jp))


def _points(n=8, S=16, C=4, seed=3):
    """pts [n, S, 3] along seeded rays, unit viewdirs [n, 3], a cotangent
    g [n, S, C]."""
    rng = np.random.default_rng(seed)
    ro = rng.standard_normal((n, 3)).astype(np.float32) * 0.1
    rd = rng.standard_normal((n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    z = np.sort((rng.random((n, S)) * 4 + 2).astype(np.float32), -1)
    pts = (ro[:, None] + rd[:, None] * z[..., None]).astype(np.float32)
    g = rng.standard_normal((n, S, C)).astype(np.float32)
    return pts, rd, g


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a, np.float32))


def _j_grads_to_torch(jgrads):
    return tnerf.params_from_jax(jax.device_get(jgrads))


def _assert_grads_close(got, want, rtol, atol, scale=True):
    for k in want:
        w = want[k].detach()
        tol = atol * max(1.0, float(w.abs().max())) if scale else atol
        torch.testing.assert_close(got[k], w, rtol=rtol, atol=tol, msg=k)


# --- B1: the plain version against the Pallas forward ---------------------


@pytest.mark.parametrize("use_vd,n,S", [(True, 8, 16), (False, 5, 24),
                                        (True, 3, 7)])
def test_plain_b1_matches_pallas_forward(use_vd, n, S):
    """Tolerance 1e-4: the Pallas kernel forms cos as sin(x + π/2) from a
    matmul-formed argument, apply_nerf takes cos of f·x."""
    jcfg, jp, tcfg, tp = _models(use_viewdirs=use_vd, output_ch=4 if use_vd else 5)
    pts, vd, _ = _points(n=n, S=S)
    vd = vd if use_vd else None
    want = jfm.fused_nerf_forward(jp, jcfg, jnp.asarray(pts),
                                  None if vd is None else jnp.asarray(vd))
    got = fused_mlp.fused_nerf_forward(tp, tcfg, _t(pts), _t(vd))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_b1_encoder_arguments_match_embed_bit_for_bit():
    """The point-major encoder of B1 and B2 (csrc/mlp_tile_tc.cuh PointEnc)
    forms f·x from the encoder table, rounded once: for every column that
    is exactly the plain embed's x * f."""
    _, _, tcfg, _ = _models(multires=10, multires_views=4)
    pts, vd, _ = _points(n=4, S=5)
    enc = fused_mlp.encoder_buffer(tcfg, "cpu")
    src, scale, kind = fused_mlp.encoder_tables(tcfg)
    m = fused_mlp.MAX_EMB
    np.testing.assert_array_equal(enc[:src.size].numpy(), scale)
    np.testing.assert_array_equal(enc[m:m + src.size].numpy(), src)
    x = np.concatenate([pts, np.broadcast_to(vd[:, None], pts.shape)], -1)
    arg = _t(x)[..., src] * enc[:src.size]
    P = tcfg.input_ch
    from nerf_shared_tpu_torch.ops.embedding import embed
    emb = embed(_t(pts), tcfg.pts_embedder)
    sines = torch.from_numpy(kind[:P] == 1)
    torch.testing.assert_close(torch.sin(arg[..., :P])[..., sines],
                               emb[..., sines], rtol=0, atol=0)


# --- B2: the plain version against the Pallas backward --------------------


def _pallas_backward(jcfg, jp, pts, vd, g):
    """fused_mlp_backward on the padded [N, 8] / [N, 128] layout, as
    fused_train_op's backward calls it, -> (torch-layout grads, dx [N, 8])."""
    n = pts.shape[0] * pts.shape[1]
    flat = pts.reshape(n, 3)
    dirs = (np.broadcast_to(vd[:, None], pts.shape).reshape(n, 3) if vd is not None
            else np.zeros((n, 3), np.float32))
    x = np.concatenate([flat, dirs, np.zeros((n, 2), np.float32)], -1)
    gp = np.zeros((n, jfm.LANE), np.float32)
    gp[:, :g.shape[-1]] = g.reshape(n, -1)
    n_pad = -(-n // jbwd.TILE_BWD) * jbwd.TILE_BWD
    x = np.pad(x, ((0, n_pad - n), (0, 0)))
    gp = np.pad(gp, ((0, n_pad - n), (0, 0)))
    gb = jbwd.fused_mlp_backward(jp, jcfg, jnp.asarray(x), jnp.asarray(gp))
    grads = _j_grads_to_torch(jbwd.grads_to_pytree(gb, jp, jcfg))
    return grads, np.asarray(gb["dx"])[:n]


@pytest.mark.parametrize("kw", [dict(), dict(use_viewdirs=False, output_ch=5),
                                dict(D=4, skips=(0, 2), W=48)])
def test_plain_b2_matches_pallas_backward(kw):
    """Tolerance 1e-4 relative to each tensor's max |grad|: fp32 sums over
    the 128 points in another order."""
    jcfg, jp, tcfg, tp = _models(**kw)
    C = 4 if tcfg.use_viewdirs else tcfg.output_ch
    pts, vd, g = _points(C=C)
    vd = vd if tcfg.use_viewdirs else None
    want, dx = _pallas_backward(jcfg, jp, pts, vd, g)
    got, dpts, ddirs = fused_mlp_bwd.plain_mlp_backward(tp, tcfg, _t(pts), _t(vd), _t(g))
    _assert_grads_close(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dpts.numpy().reshape(-1, 3), dx[:, :3],
                               rtol=1e-4, atol=1e-4 * max(1.0, np.abs(dx).max()))
    if vd is not None:
        want_dd = dx[:, 3:6].reshape(pts.shape).sum(1)
        np.testing.assert_allclose(ddirs.numpy(), want_dd, rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.abs(want_dd).max()))


@pytest.mark.parametrize("use_vd", [True, False])
def test_fused_train_op_gradients_match_jax(use_vd):
    """jax.grad through the JAX fused_train_op (B1 forward + B2 backward in
    interpret mode) against the port's fused_train_op on the CPU, params,
    dpts and ddirs; tolerance 1e-4 relative to max |grad|."""
    jcfg, jp, tcfg, tp = _models(use_viewdirs=use_vd, output_ch=4 if use_vd else 5)
    C = 4 if use_vd else 5
    pts, vd, g = _points(n=6, S=16, C=C, seed=9)
    vd = vd if use_vd else None

    def jloss(p, x, d):
        return jnp.sum(jbwd.fused_train_op(jcfg, p, x, d) * g)

    argn = (0, 1, 2) if use_vd else (0, 1)
    jg = jax.grad(jloss, argnums=argn)(jp, jnp.asarray(pts),
                                       None if vd is None else jnp.asarray(vd))
    tp = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tpts = _t(pts).requires_grad_(True)
    tvd = None if vd is None else _t(vd).requires_grad_(True)
    (fused_mlp_bwd.fused_train_op(tp, tcfg, tpts, tvd) * _t(g)).sum().backward()
    _assert_grads_close({k: v.grad for k, v in tp.items()}, _j_grads_to_torch(jg[0]),
                        rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tpts.grad.numpy(), np.asarray(jg[1]), rtol=1e-4,
                               atol=1e-4 * max(1.0, np.abs(np.asarray(jg[1])).max()))
    if use_vd:
        np.testing.assert_allclose(tvd.grad.numpy(), np.asarray(jg[2]), rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.abs(np.asarray(jg[2])).max()))


# --- the packed buffers B2 reads, through a transcription of its arithmetic -


def _tf32(x):
    """cvt.rna.tf32.f32 on a float32 array: 10 mantissa bits, to nearest,
    ties away from zero."""
    bits = np.ascontiguousarray(x, np.float32).view(np.int32)
    return ((bits + 0x1000) & -0x2000).view(np.float32)


def _split(x):
    big = _tf32(x)
    return big, _tf32(x - big)


def _dw_wide(h, z):
    """nerf_dw_kernel's tensor-core product over one point range: h [K, M],
    z [K, N] float32, K a multiple of 8. Per k8 step the three TF32
    products small·big' + big·small' + big·big', summed from zero (fp32,
    as the tensor cores chain three MMAs), then added to the fp32
    accumulator in order."""
    K, M = h.shape
    N = z.shape[1]
    acc = np.zeros((M, N), np.float32)
    batch = max(1, (1 << 22) // max(1, M * N))
    for s0 in range(0, K // 8, batch):
        hh = h[s0 * 8:(s0 + batch) * 8].reshape(-1, 8, M).transpose(0, 2, 1)
        zz = z[s0 * 8:(s0 + batch) * 8].reshape(-1, 8, N)
        hb, hs = (torch.from_numpy(np.ascontiguousarray(t)) for t in _split(hh))
        zb, zs = (torch.from_numpy(np.ascontiguousarray(t)) for t in _split(zz))
        sl = torch.bmm(hs, zb)
        sl = torch.baddbmm(sl, hb, zs)
        sl = torch.baddbmm(sl, hb, zb)
        for step in sl.numpy():   # in order, each add rounded to fp32
            acc = acc + step
    return acc


def _dw_narrow(h, z):
    """The CUDA-core product of a narrow head: fp32 fma in point order."""
    prod = h[:, :, None].astype(np.float64) * z[:, None, :]
    acc = np.zeros(prod.shape[1:], np.float32)
    return np.cumsum(np.concatenate([acc[None], prod.astype(np.float32)]), 0,
                     dtype=np.float32)[-1]


def _tc_desc(desc):
    """csrc/mlp_tile_tc.cuh Desc -> (hdr, gemm, narrow, kind)."""
    d = desc.numpy()
    G = fused_mlp.MAX_GEMMS
    return (d[:16], d[16:16 + 8 * G].reshape(G, 8),
            d[16 + 8 * G:16 + 8 * G + 12].reshape(3, 4), d[16 + 8 * G + 12:].view(np.int8))


def _bwd_desc(bdesc):
    """csrc/fused_mlp_bwd.cu BwdDesc -> (hdr, gemm, hseg, zseg)."""
    d = bdesc.numpy()
    G, ns = fused_mlp_bwd.MAX_BGEMMS, fused_mlp_bwd.N_SEG
    return (d[:8], d[8:8 + 8 * G].reshape(G, 8),
            d[8 + 8 * G:8 + 8 * G + 2 * ns].reshape(ns, 2), d[8 + 8 * G + 2 * ns:].reshape(ns, 2))


def _slice_planes(buf, w_off, Kp, Np, bf16):
    """A GEMM's [Kp, Np] weights back out of a tensor-core pack's slices:
    fp32, its (big, small) tf32 planes; bf16, (its bf16 plane,)."""
    if bf16:
        w16 = buf.view(torch.bfloat16)
        step = 2 * fused_mlp.slice_floats(Np, True)
        at = fused_mlp.slice_index_bf16(Np).reshape(-1)
        return (torch.stack([w16[2 * w_off + s * step + at] for s in range(Kp // 16)])
                .reshape(Kp, Np).float(),)
    v = buf[w_off:w_off + Kp // 8 * fused_mlp.slice_floats(Np)].view(Kp // 8, 2, 8 * Np)
    at = fused_mlp.slice_index(Np).reshape(-1)
    return tuple(v[:, plane, at].reshape(Kp, Np) for plane in (0, 1))


def _mm3_rn(a, big, small):
    """a [M, K] @ w [K, N] as mma_slice_rn forms it from w's split planes:
    a split in registers, each 8-row slice's three TF32 products (small·big'
    + big·small' + big·big') summed from zero, the slice sums added in fp32
    in order."""
    M, K = a.shape
    ab, as_ = (torch.from_numpy(t).view(M, K // 8, 8).transpose(0, 1) for t in _split(a.numpy()))
    # per slice [as | ab | ab] @ [big; small; big]: the three products in one sum
    a3 = torch.cat([as_, ab, ab], -1).contiguous()
    w3 = torch.cat([big.view(K // 8, 8, -1), small.view(K // 8, 8, -1),
                    big.view(K // 8, 8, -1)], 1)
    acc = torch.zeros(M, big.shape[1])
    for a_s, w_s in zip(a3, w3):
        acc = acc + a_s @ w_s
    return acc


def _sinf(a):
    """sinf of fp32 arguments, correctly rounded (the kernel's sinf is
    within 2 ulp over the whole range). torch's fp32 sin on the CPU is not
    used: it now and then runs one thread's share of the rows through a
    path 1.5e-4 off at the 2^9 frequencies' arguments."""
    return torch.sin(a.double()).float()


def _cosf(a):
    """cosf as _sinf."""
    return torch.cos(a.double()).float()


def _expf(a):
    """expf as _sinf."""
    return torch.exp(a.double()).float()


def _tile_setup(params, cfg, pts, vd, bf16=False, dx=True):
    """What the tile kernels (B1's training launch, B2's tile) read, on the
    CPU: the packs and descriptors, and per point of n_pad = n rounded up
    to the 128-point tile the encoder's record x (the point and its ray's
    direction, PointEnc; under IPE the Gaussian's mean and variances and
    the direction, IpeEnc; points past n zero, as the encoder's empty rows
    are) and the encoded inputs as the encoder forms them (f·x rounded
    once, then identity, sin or cos; IPE's attenuated kinds times
    exp(-f²σ²/2)). ``dx``: as for pack_backward_tc."""
    dt = torch.bfloat16 if bf16 else torch.float32
    wbuf, desc, _, _ = fused_mlp.pack_network_tc(params, cfg, "cpu", dt)
    wbt, bdesc = fused_mlp_bwd.pack_backward_tc(params, cfg, "cpu", dt, dx)
    enc = fused_mlp.encoder_buffer(cfg, "cpu")
    hdr, gemm, narrow, kind = _tc_desc(desc)
    D, W, P, V, OUT, VD, HS, _, NG = (int(v) for v in hdr[:9])
    w = cfg.point_width
    n = pts.size // w
    n_pad = -(-n // fused_mlp_bwd.TILE_P) * fused_mlp_bwd.TILE_P
    assert fused_mlp_bwd.TILE_P == 128
    x = torch.zeros(n_pad, w + 3)
    x[:n, :w] = torch.from_numpy(pts.reshape(-1, w))
    if VD:
        x[:n, w:] = torch.from_numpy(np.repeat(vd, pts.shape[-2], axis=0))
    m = fused_mlp.MAX_EMB
    src = enc[m:m + P + V].long()
    f = enc[:P + V]
    k = torch.from_numpy(kind[:P + V].astype(np.int64))
    xs = x[:, src]
    arg = f * xs
    emb = torch.where(k == 0, xs, torch.where((k == 1) | (k == 3), _sinf(arg), _cosf(arg)))
    if cfg.ipe:
        var = x[:, torch.clamp(src + 3, max=w + 2)]
        emb = torch.where(k >= 3, emb * _expf(-0.5 * (var * (f * f))), emb)
    return dict(wbuf=wbuf, wbt=wbt, bdesc=bdesc, gemm=gemm, narrow=narrow, D=D, P=P, V=V,
                OUT=OUT, VD=VD, HS=HS, NG=NG, n=n, n_pad=n_pad, x=x, src=src, f=f, k=k,
                emb=emb, bf16=bf16)


def _rows(buf, table, slot, n_pad):
    off, ld = (int(v) for v in table[slot])
    return buf[off * n_pad:(off + ld) * n_pad].view(n_pad, ld)


def _prod(st, a, buf, w_off, Kp, Np):
    """a @ the GEMM's [Kp, Np] weights in a pack, as the tile forms it:
    fp32 through the split planes with 8-row slice sums (_mm3_rn); bf16
    operands rounded, one product a 16-row slice, fp32 sums."""
    planes = _slice_planes(buf, w_off, Kp, Np, st["bf16"])
    return fused_mlp.bf16_round(a) @ planes[0] if st["bf16"] else _mm3_rn(a, *planes)


def _pad(a, width):
    return torch.nn.functional.pad(a, (0, width - a.shape[1]))


def _forward_to_h(st, hbuf):
    """The forward of tile_network over every tile, as B1's training launch
    (kSaveH) forms it and as B2's bf16 tile reruns it: the embedding to H's
    embedding segment (rows past n zero), each GEMM's act(acc + bias) to
    its H segment and the activation tile s.h (rounded under bf16) ->
    s.h after the last GEMM [n_pad, HS]."""
    rnd = fused_mlp.bf16_round if st["bf16"] else (lambda a: a)  # noqa: E731
    sk = 16 if st["bf16"] else 8
    n, n_pad, P, V, D = st["n"], st["n_pad"], st["P"], st["V"], st["D"]
    _, _, hseg, _ = _bwd_desc(st["bdesc"])
    emb = st["emb"]
    P4 = fused_mlp._round4(P)
    he = _rows(hbuf, hseg, fused_mlp_bwd.H_EMB, n_pad)
    he[:] = 0.0
    he[:n, :P] = rnd(emb[:n, :P])
    he[:n, P4:P4 + V] = rnd(emb[:n, P:])
    srcs = {fused_mlp.SRC_PTS: _pad(emb[:, :P], -(-P // sk) * sk),
            fused_mlp.SRC_DIRS: _pad(emb[:, P:], -(-V // sk) * sk)}
    t = torch.zeros(n_pad, st["HS"])   # the activation tile s.h
    wbuf = st["wbuf"]
    for gi in range(st["NG"]):
        w_off, b_off, Np, ns0, src0, ns1, src1, relu = (int(v) for v in st["gemm"][gi])
        a = torch.cat([t[:, :sk * ns] if s_ == fused_mlp.SRC_H else srcs[s_]
                       for s_, ns in ((src0, ns0), (src1, ns1)) if ns], -1)
        out = _prod(st, a, wbuf, w_off, sk * (ns0 + ns1), Np) + wbuf[b_off:b_off + Np]
        out = rnd(out.clamp_min(0.0) if relu else out)
        slot = 1 + gi if gi < D else (fused_mlp_bwd.H_FEATURE if gi == D else fused_mlp_bwd.H_HV)
        hr = _rows(hbuf, hseg, slot, n_pad)
        hr[:] = out[:, :hr.shape[1]]
        t[:, :Np] = out
    return t


def _emulate_b1_h(params, cfg, pts, vd):
    """Transcription of B1's training launch (nerf_points_tc_kernel<true>,
    nerf_points_ipe_kernel<true>: tile_network with kSaveH) on
    pack_network_tc's buffer and act_layout's segments -> (hbuf, n_pad):
    every layer input of every point, each GEMM's through the split planes
    with 8-row slice sums (_mm3_rn) and the epilogue's act(acc + bias).
    H starts NaN, as torch.empty may leave it, so a float the launch does
    not write shows."""
    st = _tile_setup(params, cfg, pts, vd)
    _, _, h_floats, _ = fused_mlp_bwd.act_layout(cfg)
    hbuf = torch.full((st["n_pad"] * h_floats,), float("nan"))
    _forward_to_h(st, hbuf)
    return hbuf.numpy(), st["n_pad"]


def _emulate_tile(params, cfg, pts, vd, g, bf16=False, rerun=None, dx=True):
    """Transcription of csrc/fused_mlp_bwd.cu's tile kernel (nerf_bwd_kernel,
    nerf_bwd_ipe_kernel under IPE, nerf_bwd_bf16_kernel under ``bf16``) on
    pack_network_tc's and pack_backward_tc's buffers and descriptors, over
    n_pad = n rounded up to the 128-point tile -> (hbuf, zbuf, dx [n, 6],
    n_pad). fp32: H from B1's training launch (_emulate_b1_h) and the
    backward sweep alone, the narrow heads' mask read from H, s.h starting
    NaN (the tile holds no activation) and padded with zeros to the first
    GEMM's K; ``rerun`` (the bf16 tile's route, default under bf16): the
    tile reruns the forward itself first (_forward_to_h), writing H, the
    narrow heads' mask read from s.h. Every GEMM's products through the
    split planes with 8-row slice sums (_mm3_rn); bf16: operands rounded,
    one product a 16-row slice, fp32 sums. H and dZ start NaN, as
    torch.empty may leave them, so a float the kernels do not write
    shows. ``dx`` False: nerf_bwd_kernel<false> over the backward pack
    without the GEMMs into the embedding (dx stays zero)."""
    rerun = bf16 if rerun is None else rerun
    rnd = fused_mlp.bf16_round if bf16 else (lambda a: a)  # noqa: E731
    st = _tile_setup(params, cfg, pts, vd, bf16, dx)
    n, n_pad, D, P, V, OUT, VD = (st[k] for k in ("n", "n_pad", "D", "P", "V", "OUT", "VD"))
    wbuf, narrow, x, src, f, k = (st[k] for k in ("wbuf", "narrow", "x", "src", "f", "k"))
    bhdr, bgemm, hseg, zseg = _bwd_desc(st["bdesc"])
    _, _, h_floats, z_floats = fused_mlp_bwd.act_layout(cfg)
    zbuf = torch.full((n_pad * z_floats,), float("nan"))
    if rerun:
        hbuf = torch.full((n_pad * h_floats,), float("nan"))
        t = _forward_to_h(st, hbuf)
    else:
        hb, n_b1 = _emulate_b1_h(params, cfg, pts, vd)
        assert n_b1 == n_pad
        hbuf = torch.from_numpy(hb)
        t = torch.full((n_pad, st["HS"]), float("nan"))
    gt = torch.zeros(n_pad, fused_mlp_bwd.G_LD)
    gr = torch.from_numpy(g.reshape(n, -1))
    if VD:
        gt[:n, :4], gt[:n, 4] = gr, gr[:, 3]
    else:
        gt[:n, :OUT] = gr
    gt = rnd(gt)
    _rows(zbuf, zseg, fused_mlp_bwd.Z_GR, n_pad)[:] = gt
    # the narrow heads' transposed products, fp32 in order, masked by hv
    # (h_{D-1}): from s.h after a rerun, else from H
    w_off, _, K, N = (int(v) for v in narrow[1 if VD else 2])
    wn = wbuf[w_off:w_off + N * K].view(N, K)
    zr = _rows(zbuf, zseg, fused_mlp_bwd.Z_DHV if VD else D - 1, n_pad)
    v = gt[:, :1] * wn[0]
    for o in range(1, N):
        v = v + gt[:, o:o + 1] * wn[o]
    mask = t[:, :K] if rerun else _rows(hbuf, hseg, fused_mlp_bwd.H_HV if VD else D, n_pad)[:, :K]
    v = torch.where(mask > 0, v, torch.zeros(()))
    zr[:] = _pad(v, zr.shape[1])
    cols = zr.shape[1] if rerun else -(-zr.shape[1] // 8) * 8
    t[:, :cols] = rnd(_pad(v, cols))
    dx = torch.zeros(n_pad, 6, dtype=torch.float64)
    for w_off, kind_, Np, ns, arg in (tuple(int(v) for v in r[:5])
                                      for r in bgemm[:int(bhdr[0])]):
        sk = 16 if bf16 else 8
        acc = _prod(st, t[:, :sk * ns], st["wbt"], w_off, sk * ns, Np)
        if kind_ == fused_mlp_bwd.BK_DEMB:
            base, width = (P, V) if arg else (0, P)
            for c in range(width):
                cc = base + c
                dim, fc, kc = int(src[cc]), float(f[cc]), int(k[cc])
                xa = x[:, dim]
                arg_ = fc * xa
                der = (torch.ones_like(xa) if kc == 0 else
                       fc * _cosf(arg_) if kc == 1 else -fc * _sinf(arg_))
                dx[:, dim] += (acc[:, c] * der).double()
            continue
        if kind_ == fused_mlp_bwd.BK_DFEATURE:
            zr = _rows(zbuf, zseg, fused_mlp_bwd.Z_DFEATURE, n_pad)
        else:
            if kind_ == fused_mlp_bwd.BK_DZ_ALPHA:
                wa_off, _, Ka, _ = (int(v) for v in narrow[0])
                acc[:, :Ka] = acc[:, :Ka] + gt[:, 4:5] * wbuf[wa_off:wa_off + Ka]
            hm = _rows(hbuf, hseg, 1 + arg, n_pad)
            acc = torch.where(_pad(hm, Np) > 0, acc, torch.zeros(()))
            zr = _rows(zbuf, zseg, arg, n_pad)
        zr[:] = acc[:, :zr.shape[1]]
        t[:, :Np] = rnd(acc)
    return hbuf.numpy(), zbuf.numpy(), dx[:n].numpy(), n_pad


def _dw_wide_bf16(h, z):
    """nerf_dw_bf16_kernel's product over one point range: h and z rounded
    to bf16, one product a 16-point step (exact in fp32, summed in fp32),
    the steps' sums added in order."""
    K, M = h.shape
    hb = fused_mlp.bf16_round(torch.from_numpy(h)).reshape(K // 16, 16, M).transpose(1, 2)
    zb = fused_mlp.bf16_round(torch.from_numpy(z)).reshape(K // 16, 16, -1)
    sl = torch.bmm(hb, zb).numpy()
    return np.cumsum(np.concatenate([np.zeros((1,) + sl.shape[1:], np.float32), sl]), 0,
                     dtype=np.float32)[-1]


def _emulate_b2(params, cfg, pts, vd, g, sms=132, buffers=None, bf16=False, rerun=None,
                dx=True):
    """Transcription of all of B2 -> (grads, dpts, ddirs) (under IPE or
    without ``dx`` dpts and ddirs None):

    - the tile kernel (_emulate_tile; ``rerun`` as there), which reads each
      layer input H that B1's training launch wrote, writes each post-mask
      cotangent dZ (float32) into the dZ buffer at act_layout's offsets for
      n_pad points and forms dx;
    - nerf_dw_kernel: every dw_jobs product over each split_ranges range
      (rows at or past n zero, as the kernel's staging fills them), split
      fp32 with k8 slice sums (_dw_wide; bf16: _dw_wide_bf16) or fp32 fma
      (_dw_narrow), biases fp32 sums in point order, into one partial copy
      of the packed gradients per range (padding zero);
    - the ranges summed in order by the wrapper's reduce_partials, and
      unpacked by its unpack_grads.

    ``buffers``, a dict, receives hbuf, zbuf, part and the split count."""
    with_dx = dx and not cfg.ipe
    hbuf, zbuf, dx, n_pad = _emulate_tile(params, cfg, pts, vd, g, bf16, rerun, with_dx)
    VD = cfg.use_viewdirs
    n = pts.size // cfg.point_width
    hseg, zseg, _, _ = fused_mlp_bwd.act_layout(cfg)

    def rows(buf, table, slot):
        off, ld = (int(v) for v in table[slot])
        return buf[off * n_pad:(off + ld) * n_pad].reshape(n_pad, ld)

    # ---- nerf_dw_kernel over the buffers, then the reduction ----
    jobs = fused_mlp_bwd.dw_jobs(cfg)
    tiles = fused_mlp_bwd.dw_tiles(jobs)
    _, wsize = fused_mlp.packed_layout(cfg)
    splits = fused_mlp_bwd.dw_splits(n_pad, len(tiles), sms)
    part = np.full((splits, wsize), np.nan, np.float32)
    for si, (kb, ke) in enumerate(fused_mlp_bwd.split_ranges(n_pad, splits)):
        for kind_, hslot, hcol, M, zslot, zcol, N, w_off, ld, b_off in jobs:
            h = rows(hbuf, hseg, hslot)[kb:ke, hcol:hcol + M].copy()
            z = rows(zbuf, zseg, zslot)[kb:ke, zcol:zcol + N].copy()
            h[max(0, n - kb):] = 0.0
            z[max(0, n - kb):] = 0.0
            wide = _dw_wide_bf16 if bf16 else _dw_wide
            dw = wide(h, z) if kind_ == fused_mlp_bwd.DW_WIDE else _dw_narrow(h, z)
            blk = part[si, w_off:w_off + M * ld].reshape(M, ld)
            blk[:] = 0.0
            blk[:, :N] = dw
            if b_off >= 0:
                part[si, b_off:b_off + ld] = 0.0
                part[si, b_off:b_off + N] = np.cumsum(
                    np.concatenate([np.zeros((1, N), np.float32), z]), 0,
                    dtype=np.float32)[-1]
    assert not np.isnan(part).any(), "a partial gradient was left unwritten"
    grads = fused_mlp_bwd.reduce_partials(torch.from_numpy(part), splits)
    if buffers is not None:
        buffers.update(hbuf=hbuf, zbuf=zbuf, part=part, splits=splits, n_pad=n_pad)
    tg = fused_mlp_bwd.unpack_grads(grads, cfg)
    if not with_dx:
        return tg, None, None
    ddirs = dx[:, 3:].reshape(pts.shape).sum(1) if VD else None
    return tg, dx[:, :3].reshape(pts.shape), ddirs


@pytest.mark.parametrize("kw", [
    dict(),                                        # small lego shape
    dict(use_viewdirs=False, output_ch=5),
    dict(i_embed=-1, W=30, D=2, skips=(0,)),
    dict(multires=15, multires_views=6, W=16),     # stonehenge encoder
    dict(D=5, skips=(1, 3), W=24, multires=6, multires_views=2),
])
def test_packed_backward_reproduces_plain(kw):
    """The packing, both descriptors, the encoder table and the gradient
    layout are right if B2's arithmetic on them gives autograd's gradients.
    Tolerance 1e-4 relative to max |grad|: float64 vs fp32."""
    _, _, tcfg, tp = _models(**kw)
    C = 4 if tcfg.use_viewdirs else tcfg.output_ch
    pts, vd, g = _points(n=4, S=9, C=C)
    vd = vd if tcfg.use_viewdirs else None
    got, dpts, ddirs = _emulate_b2(tp, tcfg, pts, vd, g)
    want, wpts, wdirs = fused_mlp_bwd.plain_mlp_backward(tp, tcfg, _t(pts), _t(vd), _t(g))
    _assert_grads_close(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dpts, wpts.numpy(), rtol=1e-4,
                               atol=1e-4 * max(1.0, float(wpts.abs().max())))
    if vd is not None:
        np.testing.assert_allclose(ddirs, wdirs.numpy(), rtol=1e-4,
                                   atol=1e-4 * max(1.0, float(wdirs.abs().max())))


# --- dispatch, guards, counts ----------------------------------------------


def test_cpu_tensors_take_the_plain_versions():
    _, _, tcfg, tp = _models()
    pts, vd, g = _points(n=3, S=5)
    before = (fused_mlp.POINT_LAUNCHES, fused_mlp_bwd.LAUNCHES)
    raw = fused_mlp.fused_nerf_forward(tp, tcfg, _t(pts), _t(vd))
    torch.testing.assert_close(raw, tnerf.apply_nerf(tp, tcfg, _t(pts), _t(vd)),
                               rtol=0, atol=0)
    got = fused_mlp_bwd.fused_mlp_backward(tp, tcfg, _t(pts), _t(vd), _t(g))
    want = fused_mlp_bwd.plain_mlp_backward(tp, tcfg, _t(pts), _t(vd), _t(g))
    for k in want[0]:
        torch.testing.assert_close(got[0][k], want[0][k], rtol=0, atol=0)
    raw = fused_mlp_bwd.fused_train_op(tp, tcfg, _t(pts), _t(vd))
    assert raw.shape == (3, 5, 4)
    assert (fused_mlp.POINT_LAUNCHES, fused_mlp_bwd.LAUNCHES) == before


def test_other_devices_raise():
    _, _, tcfg, tp = _models()
    pts, vd, g = (t.to("meta") for t in map(_t, _points(n=3, S=5)))
    with pytest.raises(ValueError, match="no kernel"):
        fused_mlp.fused_nerf_forward(tp, tcfg, pts, vd)
    with pytest.raises(ValueError, match="no kernel"):
        fused_mlp_bwd.fused_mlp_backward(tp, tcfg, pts, vd, g)
    with pytest.raises(ValueError, match="no kernel"):
        fused_mlp_bwd.fused_train_op(tp, tcfg, pts, vd)


def test_check_points_guards():
    _, _, tcfg, _ = _models()
    pts, vd, _ = map(_t, _points(n=3, S=5))
    assert fused_mlp.check_points(tcfg, pts, vd) == (15, 5)
    with pytest.raises(ValueError, match="viewdirs"):
        fused_mlp.check_points(tcfg, pts, None)
    with pytest.raises(ValueError, match="shape"):
        fused_mlp.check_points(tcfg, pts, vd[:2])
    with pytest.raises(ValueError, match="expected"):
        fused_mlp.check_points(tcfg, pts[..., :2].contiguous(), vd)


def test_kernel_sources_are_built():
    assert "fused_mlp_bwd" in common.KERNELS
    assert (common.CSRC / "fused_mlp_bwd.cu").exists()


def test_backward_fits_shared_memory_at_the_supported_widths():
    """One tile-kernel block keeps the [128][HS] activation tile, the
    cotangent tile, the encoder's rows, the dx sums, a ring of at least two
    weight slots (the widest slice of either pack) and the Desc, BwdDesc
    and ring barriers in shared memory: it must fit the 227 KB a block may
    use at the lego width and with the stonehenge encoder (whose wider
    embedding stays out of shared memory: the same bytes), with room for
    four slots at the lego width. Two nerf_dw_kernel blocks (three stages
    of 32-point H and dZ chunks each) must fit one SM's 228 KB."""
    lego = tnerf.NeRFConfig()
    stone = tnerf.NeRFConfig(multires=15, multires_views=6)
    assert fused_mlp_bwd.smem_bytes(lego) == fused_mlp_bwd.smem_bytes(stone)
    assert fused_mlp_bwd.smem_bytes(stone) <= fused_mlp_bwd.MAX_SMEM
    slot = fused_mlp_bwd.bwd_layout(lego)[2]
    assert slot == 16 * 256
    assert fused_mlp_bwd.smem_bytes(lego) + 4 * 2 * slot <= fused_mlp_bwd.MAX_SMEM
    small = tnerf.NeRFConfig(D=3, W=32, skips=(1,))
    assert fused_mlp_bwd.smem_bytes(small) < fused_mlp_bwd.smem_bytes(lego)
    words = 8 + fused_mlp_bwd.MAX_BGEMMS * 8 + 2 * fused_mlp_bwd.N_SEG * 2
    _, bdesc = fused_mlp_bwd.pack_backward_tc(
        tnerf.NeRF(lego).params(), lego, "cpu")
    assert bdesc.numel() == words
    dw = fused_mlp_bwd.dw_smem_bytes()
    assert dw == 4 * 3 * 2 * 32 * 136
    assert fused_mlp_bwd.DW_BLOCKS_PER_SM * dw <= 228 * 1024


def test_flop_counts_at_the_lego_width():
    """1,186,816 FLOP per point forward (8x256, skip at 4, viewdirs,
    multires 10/4); the backward is two forwards' worth: the input
    gradients and the weight gradients (B1's training launch formed the
    layer inputs, so B2 reruns no forward)."""
    cfg = tnerf.NeRFConfig()
    f = fused_mlp.flops_per_point(cfg)
    assert f == 1_186_816
    assert fused_mlp_bwd.flops_per_point_bwd(cfg) == 2 * f


def test_flop_counts_of_the_two_kernels():
    """nerf_dw_kernel does one forward's multiply-adds (every dW = H^T·dZ,
    the narrow heads' included), the tile kernel one forward's input-
    gradient products (the narrow heads' included; under IPE without the
    GEMMs into the embedding, since it forms no dx); together B2's
    count."""
    for cfg in (tnerf.NeRFConfig(), tnerf.NeRFConfig(D=3, W=64, skips=(1,),
                                                     use_viewdirs=False, output_ch=5),
                tnerf.MipNeRFConfig()):
        f = fused_mlp.flops_per_point(cfg)
        tile, dw = fused_mlp_bwd.flops_per_point_tile(cfg), fused_mlp_bwd.flops_per_point_dw(cfg)
        assert dw == f
        assert tile + dw == fused_mlp_bwd.flops_per_point_bwd(cfg)
    assert fused_mlp_bwd.flops_per_point_tile(tnerf.NeRFConfig()) == 1_186_816
    mip = tnerf.MipNeRFConfig()
    assert fused_mlp_bwd.flops_per_point_tile(mip) == fused_mlp.flops_per_point(mip) - 2 * (
        2 * 96 * 256 + 27 * 128)


def test_h_is_written_only_for_a_backward():
    """fused_train_op's B1 launch writes B2's H (saves_h) only where a
    backward will read it: fp32 or IPE, grad mode on, an input that needs a
    gradient; not under torch.no_grad(), not with no input requiring one,
    not in bf16 (its tile reruns the forward). On CPU tensors (the plain
    versions) fused_train_op under no_grad and fused_nerf_forward add
    nothing to SAVED_H_POINTS, nor does a training forward and backward."""
    _, _, tcfg, tp = _models()
    pts, vd, g = map(_t, _points(n=3, S=5))
    leaves = [v.clone().requires_grad_(True) for v in tp.values()]
    plain = list(tp.values())
    f32, bf = torch.float32, torch.bfloat16
    assert fused_mlp_bwd.saves_h(f32, [pts, vd] + leaves)
    assert not fused_mlp_bwd.saves_h(f32, [pts, vd] + plain)
    assert not fused_mlp_bwd.saves_h(bf, [pts, vd] + leaves)
    assert fused_mlp_bwd.saves_h(f32, [pts.requires_grad_(True), None] + plain)
    with torch.no_grad():
        assert not fused_mlp_bwd.saves_h(f32, [pts, vd] + leaves)
    pts = pts.detach()
    before = fused_mlp.SAVED_H_POINTS
    params = dict(zip(tp, leaves))
    with torch.no_grad():
        fused_mlp_bwd.fused_train_op(params, tcfg, pts, vd)
    fused_mlp.fused_nerf_forward(tp, tcfg, pts, vd)
    (fused_mlp_bwd.fused_train_op(params, tcfg, pts, vd) * g).sum().backward()
    assert fused_mlp.SAVED_H_POINTS == before
    with pytest.raises(ValueError, match="fp32"):
        fused_mlp.point_symbol(tcfg, True, train=True)
    assert fused_mlp.point_symbol(tcfg, False, train=True) == "nstt_points_train_tc"
    assert fused_mlp.point_symbol(tnerf.MipNeRFConfig(), False, True) == "nstt_points_train_ipe"


def _step_net(name):
    """(cfg, params, pts [n, S, 3 | 6], vd, g) of a training-step pass: the
    lego net at 150 points (two tiles, the last ragged), a small net with
    a skip and no viewdirs, and an IPE net (mip-NeRF's encoder at a small
    width) on Gaussians."""
    cfg = {"lego": tnerf.NeRFConfig(**LEGO),
           "skip_no_viewdirs": tnerf.NeRFConfig(D=3, W=64, skips=(1,), use_viewdirs=False,
                                                output_ch=5),
           "ipe": tnerf.MipNeRFConfig(D=4, W=64, skips=(1,), multires=4,
                                      multires_views=2)}[name]
    params = {k: v.detach() for k, v in tnerf.NeRF(
        cfg, generator=torch.Generator().manual_seed(7)).params().items()}
    C = fused_mlp.out_channels(cfg)
    pts, vd, g = _points(n=3, S=50, C=C, seed=8)
    if cfg.ipe:
        var = 1e-3 * np.random.default_rng(9).random(pts.shape).astype(np.float32)
        pts = np.concatenate([pts, var], -1)
    return cfg, params, pts, vd if cfg.use_viewdirs else None, g


@pytest.mark.parametrize("net", ["lego", "skip_no_viewdirs", "ipe"])
def test_saved_h_gives_the_rerun_bit_for_bit(net):
    """B2's tile over the layer inputs that B1's training launch wrote
    (_emulate_b1_h: tile_network's epilogues with kSaveH) against the tile
    that reruns the forward itself, as it did before B1 saved them: H, dZ,
    dx and every weight gradient bit for bit, and every float of H and dZ
    written. The saved-H tile starts from a NaN activation tile, so a
    column the backward read before anything wrote it would show."""
    cfg, params, pts, vd, g = _step_net(net)
    saved, rerun = {}, {}
    got = _emulate_b2(params, cfg, pts, vd, g, buffers=saved, rerun=False)
    want = _emulate_b2(params, cfg, pts, vd, g, buffers=rerun, rerun=True)
    assert saved["n_pad"] == rerun["n_pad"] == 256
    for buf in ("hbuf", "zbuf"):
        assert not np.isnan(saved[buf]).any()
        assert np.array_equal(saved[buf], rerun[buf]), buf
    assert list(got[0]) == list(want[0])
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k]), k
    if cfg.ipe:
        assert got[1] is None and got[2] is None and want[1] is None
        return
    np.testing.assert_array_equal(got[1], want[1])
    if vd is not None:
        np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("net", ["lego", "skip_no_viewdirs"])
def test_without_dx_the_weight_gradients_are_the_same_bits(net):
    """A training step whose points and directions need no gradient runs
    nerf_bwd_kernel<false> over the backward pack without the GEMMs into
    the embedding (bwd_gemms(cfg, dx=False)): H, dZ and every weight
    gradient bit for bit those of the tile that forms dx, no dx, and the
    tile's count less exactly those GEMMs' products."""
    cfg, params, pts, vd, g = _step_net(net)
    nodx, withdx = {}, {}
    got = _emulate_b2(params, cfg, pts, vd, g, buffers=nodx, dx=False)
    want = _emulate_b2(params, cfg, pts, vd, g, buffers=withdx)
    for buf in ("hbuf", "zbuf"):
        assert np.array_equal(nodx[buf], withdx[buf]), buf
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k]), k
    assert got[1] is None and got[2] is None and want[1] is not None
    gems = fused_mlp_bwd.bwd_gemms(cfg, dx=False)
    full = fused_mlp_bwd.bwd_gemms(cfg)
    assert [r for r in full if r[3] != fused_mlp_bwd.BK_DEMB] == gems
    assert len(full) - len(gems) == 1 + len(cfg.skips) + cfg.use_viewdirs
    shapes = fused_mlp.param_shapes(cfg)
    emb = sum(shapes[name + ".weight"][0] * N for name, _, N, kind, _ in full
              if kind == fused_mlp_bwd.BK_DEMB)
    assert (fused_mlp_bwd.flops_per_point_tile(cfg)
            - fused_mlp_bwd.flops_per_point_tile(cfg, dx=False)) == 2 * emb
    assert fused_mlp_bwd.backward_symbol(cfg, False, dx=False) == "nstt_mlp_backward_nodx"
    assert fused_mlp_bwd.backward_symbol(cfg, True, dx=False) == "nstt_mlp_backward_bf16"


def test_unpack_grads_inverts_the_packed_layout():
    _, _, tcfg, tp = _models()
    back = fused_mlp_bwd.unpack_grads(_pack_network_loop(tp, tcfg), tcfg)
    assert list(back) == list(fused_mlp.packed_layout(tcfg)[0])
    for k, v in tp.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)



# --- B2's two stages: layouts, tables, ranges, the reduction ---------------

# chip_smoke.py phase 5's odd architectures
PHASE5 = [dict(D=3, W=64, skips=(1,), use_viewdirs=False, output_ch=5),
          dict(D=8, W=256, skips=(4,), multires=15, multires_views=6),
          dict(D=2, W=30, skips=(0,), i_embed=-1),
          dict(D=5, W=128, skips=(1, 3), multires=6, multires_views=2)]
PHASE5_IDS = ["no_viewdirs_w64", "stonehenge", "identity_w30", "two_skips_w128"]
LEGO = dict(D=8, W=256, skips=(4,), multires=10, multires_views=4)


def _check_b2(got, want, dpts, wpts, ddirs, wdirs, tol=1e-4):
    _assert_grads_close(got, want, rtol=tol, atol=tol)
    np.testing.assert_allclose(dpts, np.asarray(wpts).reshape(dpts.shape), rtol=tol,
                               atol=tol * max(1.0, float(np.abs(wpts).max())))
    if wdirs is not None:
        np.testing.assert_allclose(ddirs, wdirs, rtol=tol,
                                   atol=tol * max(1.0, float(np.abs(wdirs).max())))


def _b2_case(kw, n, S, seed=4):
    jcfg, jp, tcfg, tp = _models(seed=1, **{**dict(multires=10, multires_views=4), **kw})
    C = 4 if tcfg.use_viewdirs else tcfg.output_ch
    pts, vd, g = _points(n=n, S=S, C=C, seed=seed)
    return jcfg, jp, tcfg, tp, pts, (vd if tcfg.use_viewdirs else None), g


def _plain64(tp, tcfg, pts, vd, g, masks=None):
    """plain_mlp_backward in float64 (on the ReLU decisions ``masks`` if
    given: chip_smoke.masked_backward) -> (grads, dpts, ddirs) as numpy /
    float64 tensors. At 19,500
    points the fp32 chain itself reads up to 1.6e-3 of max|grad| away
    from it on these seeded networks, far from the transcription's ~4e-7
    on the same branch."""
    d = lambda a: None if a is None else torch.from_numpy(np.asarray(a, np.float64))  # noqa: E731
    args = ({k: v.double() for k, v in tp.items()}, tcfg, d(pts), d(vd), d(g))
    grads, dpts, ddirs = (fused_mlp_bwd.plain_mlp_backward(*args) if masks is None
                          else chip_smoke.masked_backward(*args, masks))
    return grads, dpts.numpy(), None if ddirs is None else ddirs.numpy()


def _as64(grads):
    return {k: v.double() for k, v in grads.items()}


@pytest.mark.parametrize("kw", [LEGO] + PHASE5, ids=["lego"] + PHASE5_IDS)
def test_two_stage_b2_matches_plain_and_pallas(kw):
    """The transcription of both kernels and the reduction over the
    wrapper's buffers, tables and ranges at 37 x 7 points (a ragged last
    tile and chunk) against plain_mlp_backward in float64 and against the
    Pallas backward in interpret mode. Tolerance 1e-4 of each tensor's
    max |grad|; 5e-2 against Pallas with the stonehenge encoder, whose
    matmul-formed argument at frequency 2^14 puts that kernel 4e-2 from
    float64 (the transcription stays within 4e-7 of it). 259 points fill
    three 128-point tiles (n_pad 384)."""
    jcfg, jp, tcfg, tp, pts, vd, g = _b2_case(kw, 37, 7)
    bufs = {}
    got, dpts, ddirs = _emulate_b2(tp, tcfg, pts, vd, g, buffers=bufs)
    assert bufs["n_pad"] == 384 and bufs["splits"] >= 1
    want, wpts, wdirs = _plain64(tp, tcfg, pts, vd, g)
    _check_b2(_as64(got), want, dpts, wpts, ddirs, wdirs)
    jwant, dx = _pallas_backward(jcfg, jp, pts, vd, g)
    jdirs = None if vd is None else dx[:, 3:6].reshape(pts.shape).sum(1)
    tol = 5e-2 if kw.get("multires") == 15 else 1e-4
    _check_b2(got, jwant, dpts, dx[:, :3], ddirs, jdirs, tol=tol)


@pytest.mark.parametrize("kw", PHASE5, ids=PHASE5_IDS)
def test_two_stage_b2_at_300_rays_of_65(kw):
    """As above at 300 x 65 = 19,500 points, several point ranges each,
    against plain_mlp_backward in float64 on the transcription's ReLU
    decisions (chip_smoke.relu_masks of its H; tolerance 1e-4). At these
    points some pre-activations lie within fp32 rounding of 0, where the
    fp32 forward (the kernel's, and the plain fp32 chain's) switches a unit
    otherwise than float64 does, which moves the gradients below it by up
    to 1.6e-3 of their max; on the same branch the two differ by rounding
    alone. Every decision other than float64's lies within
    chip_smoke.RELU_SWITCH of its layer's max |pre-activation| of 0
    (chip_smoke.relu_switches), as phase 5 holds the kernel."""
    _, _, tcfg, tp, pts, vd, g = _b2_case(kw, 300, 65, seed=5)
    bufs = {}
    got, dpts, ddirs = _emulate_b2(tp, tcfg, pts, vd, g, buffers=bufs)
    assert bufs["splits"] > 1
    masks = [torch.from_numpy(m) for m in chip_smoke.relu_masks(
        tcfg, bufs["hbuf"], bufs["n_pad"], pts.size // 3)]
    _, z_worst = chip_smoke.relu_switches(
        tcfg, {k: v.double() for k, v in tp.items()}, torch.from_numpy(pts),
        None if vd is None else torch.from_numpy(vd), masks)
    assert z_worst <= chip_smoke.RELU_SWITCH
    want, wpts, wdirs = _plain64(tp, tcfg, pts, vd, g, masks)
    _check_b2(_as64(got), want, dpts, wpts, ddirs, wdirs)


# --- B2's tensor-core tile: its pack, its H / dZ, both instantiations -------

D4W64 = dict(D=4, W=64, skips=(1,), multires=6, multires_views=3)


@pytest.mark.parametrize("kw", [LEGO] + PHASE5 + [D4W64],
                         ids=["lego"] + PHASE5_IDS + ["d4w64"])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_backward_tc_pack_round_trips_and_pads_with_zeros(kw, bf16):
    """Unpacking pack_backward_tc gives back, for every input-gradient GEMM
    of bwd_gemms, its columns of the weight [out, in] as a [K = out, N]
    matrix: fp32 as their split (big, small) tf32 planes (tf32_split's, big
    + small within 2^-21 of W), bf16 rounded; every padded entry is zero
    and every other float of the buffer belongs to a GEMM. The descriptor
    holds each GEMM's offset, epilogue, Np (a power of two >= 32), slice
    count, argument, the ring slot and act_layout's segments."""
    _, _, tcfg, tp = _models(seed=6, **kw)
    tp = {k: v + 0.5 for k, v in tp.items()}   # no weight is zero
    dt = torch.bfloat16 if bf16 else torch.float32
    wbt, bdesc = fused_mlp_bwd.pack_backward_tc(tp, tcfg, "cpu", dt)
    layout, size, slot = fused_mlp_bwd.bwd_layout(tcfg, bf16)
    assert wbt.numel() == size and wbt.dtype == torch.float32
    hdr, gemm, hseg, zseg = _bwd_desc(bdesc)
    gems = fused_mlp_bwd.bwd_gemms(tcfg)
    assert (int(hdr[0]), int(hdr[1])) == (len(gems), slot)
    sk = 16 if bf16 else 8
    used = torch.zeros(size, dtype=torch.bool)
    where = torch.arange(size, dtype=torch.float32)
    for i, ((name, col0, N, kind, arg), (w_off, Kp, Np)) in enumerate(zip(gems, layout)):
        assert tuple(gemm[i][:6]) == (w_off, kind, Np, Kp // sk, arg, 0)
        assert w_off % 16 == 0 and Np >= 32 and Np & (Np - 1) == 0 and Np >= N
        w = tp[name + ".weight"][:, col0:col0 + N]
        K = w.shape[0]
        planes = _slice_planes(wbt, w_off, Kp, Np, bf16)
        if bf16:
            torch.testing.assert_close(planes[0][:K, :N], fused_mlp.bf16_round(w),
                                       rtol=0, atol=0)
        else:
            for a, b in zip(planes, fused_mlp.tf32_split(w)):
                torch.testing.assert_close(a[:K, :N], b, rtol=0, atol=0)
            assert ((planes[0][:K, :N] + planes[1][:K, :N] - w).abs()
                    <= w.abs() * 2.0 ** -21).all()
        for pl in planes:
            assert not pl[K:].any() and not pl[:, N:].any()
        n_floats = Kp // sk * fused_mlp.slice_floats(Np, bf16)
        used[w_off:w_off + n_floats] = True
        if not bf16:   # every float of the slices is an entry of one plane
            at = _slice_planes(where, w_off, Kp, Np, False)
            assert sorted(torch.cat([a.reshape(-1) for a in at]).long().tolist()) == list(
                range(w_off, w_off + n_floats))
    assert not wbt[~used].any()
    want_h, want_z, _, _ = fused_mlp_bwd.act_layout(tcfg)
    assert (hseg == want_h).all() and (zseg == want_z).all()


def _masked_tile_rows(tcfg, pts, vd, g, tp):
    """Float64 forward activations (h_l, feature, hv) and post-mask
    cotangents (dz_l, dfeature, dhv) of the network, by H / dZ slot, for
    the points of pts."""
    names = tnerf.torch_param_order(tcfg)
    n = pts.size // 3
    P, W = tcfg.input_ch, tcfg.W
    w = {k: tp[k].double() for k in names}
    with torch.enable_grad():
        pt = torch.from_numpy(pts.astype(np.float64))
        dv = None if vd is None else torch.from_numpy(vd.astype(np.float64))
        emb = tnerf.embed_inputs(tcfg, pt, dv).reshape(n, -1)

        def dense(name, x):
            return x @ w[name + ".weight"].t() + w[name + ".bias"]

        zs, hs = {}, {}
        h = emb[:, :P]
        for i in range(tcfg.D):
            z = dense(f"pts_linears.{i}", h).requires_grad_(True)
            zs[i] = z
            hs[1 + i] = torch.relu(z)
            h = torch.cat([emb[:, :P], hs[1 + i]], -1) if i in tcfg.skips else hs[1 + i]
        if tcfg.use_viewdirs:
            f = dense("feature_linear", h).requires_grad_(True)
            zv = dense("views_linears.0", torch.cat([f, emb[:, P:]], -1)).requires_grad_(True)
            zs[fused_mlp_bwd.Z_DFEATURE], zs[fused_mlp_bwd.Z_DHV] = f, zv
            hs[fused_mlp_bwd.H_FEATURE], hs[fused_mlp_bwd.H_HV] = f, torch.relu(zv)
            raw = torch.cat([dense("rgb_linear", hs[fused_mlp_bwd.H_HV]),
                             dense("alpha_linear", h)], -1)
        else:
            raw = dense("output_linear", h)
        keys = list(zs)
        dzs = torch.autograd.grad(raw, [zs[k] for k in keys],
                                  torch.from_numpy(g.reshape(n, -1).astype(np.float64)))
    return ({k: v.detach().numpy() for k, v in hs.items()},
            {k: d.numpy() for k, d in zip(keys, dzs)})


@pytest.mark.parametrize("use_vd", [True, False], ids=["viewdirs", "no_viewdirs"])
def test_tc_tile_writes_h_and_dz_at_act_layout(use_vd):
    """The tile's transcription at D = 4, W = 64, one skip, 259 points
    (three 128-point tiles, the last partly padded) writes every float of H
    and dZ for n_pad = 384 points; each layer input and each post-mask
    cotangent sits at act_layout's offsets, within 1e-4 of the float64
    network's (of each activation's max); the padded rows of dZ are zero,
    so the dW kernel's sums over them add nothing."""
    _, _, tcfg, tp = _models(seed=1, **{**D4W64, "use_viewdirs": use_vd,
                                        "output_ch": 4 if use_vd else 5})
    pts, vd, g = _points(n=37, S=7, C=4 if use_vd else 5, seed=4)
    vd = vd if use_vd else None
    hbuf, zbuf, dx, n_pad = _emulate_tile(tp, tcfg, pts, vd, g)
    n = 259
    assert n_pad == 384 and not np.isnan(hbuf).any() and not np.isnan(zbuf).any()
    hseg, zseg, _, _ = fused_mlp_bwd.act_layout(tcfg)

    def rows(buf, table, slot):
        off, ld = (int(v) for v in table[slot])
        return buf[off * n_pad:(off + ld) * n_pad].reshape(n_pad, ld)

    hs, dzs = _masked_tile_rows(tcfg, pts, vd, g, tp)
    for slot, want in hs.items():
        got = rows(hbuf, hseg, slot)
        np.testing.assert_allclose(got[:n, :want.shape[1]], want, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(want).max()))
        assert not got[:n, want.shape[1]:].any()
    for slot, want in dzs.items():
        got = rows(zbuf, zseg, slot)
        np.testing.assert_allclose(got[:n, :want.shape[1]], want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
        assert not got[:n, want.shape[1]:].any() and not got[n:].any()
    gr = rows(zbuf, zseg, fused_mlp_bwd.Z_GR)
    assert not gr[n:].any() and not rows(hbuf, hseg, fused_mlp_bwd.H_EMB)[n:].any()


def _pallas_backward_bf16(jcfg, jp, pts, vd, g):
    """The JAX bf16 B2 (fused_train_op((cfg, "bfloat16")) differentiated,
    interpret mode) -> (torch-layout grads, dpts, ddirs)."""
    if vd is not None:
        _, vjp = jax.vjp(lambda p, x, d: jbwd.fused_train_op((jcfg, "bfloat16"), p, x, d),
                         jp, jnp.asarray(pts), jnp.asarray(vd))
        jg, jdx, jdd = vjp(jnp.asarray(g))
    else:
        _, vjp = jax.vjp(lambda p, x: jbwd.fused_train_op((jcfg, "bfloat16"), p, x, None),
                         jp, jnp.asarray(pts))
        (jg, jdx), jdd = vjp(jnp.asarray(g)), None
    return (_j_grads_to_torch(jg), np.asarray(jdx),
            None if jdd is None else np.asarray(jdd))


@pytest.mark.parametrize("use_vd", [True, False], ids=["viewdirs", "no_viewdirs"])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_tc_tile_b2_matches_plain_and_pallas(use_vd, bf16):
    """All of B2 with the tensor-core tile (split fp32 with 8-row slice
    sums, or one bf16 product a 16-row slice) at D = 4, W = 64, one skip,
    259 points, against its plain version (plain_mlp_backward in float64;
    plain_mlp_backward_bf16) and against JAX's Pallas B2 in interpret mode
    (_make_bwd_kernel_closed; its bf16 instantiation through
    fused_train_op): every gradient, dpts and ddirs within 1e-4 of its max
    in fp32, 1e-2 in bf16 (an fp32 sum in another order flips a bf16
    rounding now and then)."""
    kw = {**D4W64, "use_viewdirs": use_vd, "output_ch": 4 if use_vd else 5}
    jcfg, jp, tcfg, tp = _models(seed=1, **kw)
    pts, vd, g = _points(n=37, S=7, C=4 if use_vd else 5, seed=4)
    vd = vd if use_vd else None
    got, dpts, ddirs = _emulate_b2(tp, tcfg, pts, vd, g, bf16=bf16)
    if bf16:
        want, wpts, wdirs = fused_mlp_bwd.plain_mlp_backward_bf16(tp, tcfg, _t(pts), _t(vd),
                                                                  _t(g))
        _check_b2(got, want, dpts, wpts.numpy(), ddirs,
                  None if wdirs is None else wdirs.numpy(), tol=1e-2)
        jwant, jpts, jdirs = _pallas_backward_bf16(jcfg, jp, pts, vd, g)
        _check_b2(got, jwant, dpts, jpts, ddirs, jdirs, tol=1e-2)
        return
    want, wpts, wdirs = _plain64(tp, tcfg, pts, vd, g)
    _check_b2(_as64(got), want, dpts, wpts, ddirs, wdirs)
    jwant, dx = _pallas_backward(jcfg, jp, pts, vd, g)
    jdirs = None if vd is None else dx[:, 3:6].reshape(pts.shape).sum(1)
    _check_b2(got, jwant, dpts, dx[:, :3], ddirs, jdirs)


@pytest.mark.parametrize("kw", [dict(), dict(use_viewdirs=False, output_ch=5),
                                dict(D=4, skips=(0, 2), W=48)])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_plain_backward_on_its_own_relu_decisions_is_the_plain_backward(kw, bf16):
    """chip_smoke's plain versions on given ReLU decisions
    (masked_backward, masked_backward_bf16) with ``masks`` set to the plain
    forward's own decisions (h > 0, hv's pre-activation > 0) give the plain
    versions' gradients (fp32: to rounding, the ReLU a product by the mask;
    bf16 bit for bit); with one unit of layer 0 switched off for one point
    only that point's dpts and the gradients the unit feeds move."""
    _, _, tcfg, tp = _models(**kw)
    C = 4 if tcfg.use_viewdirs else tcfg.output_ch
    pts, vd, g = map(_t, _points(n=4, S=9, C=C))
    vd = vd if tcfg.use_viewdirs else None
    n, P = 36, tcfg.input_ch
    emb = tnerf.embed_inputs(tcfg, pts, vd).reshape(n, -1)
    plain = fused_mlp_bwd.plain_mlp_backward_bf16 if bf16 else fused_mlp_bwd.plain_mlp_backward
    masked = chip_smoke.masked_backward_bf16 if bf16 else chip_smoke.masked_backward
    x, masks = emb[:, :P], []
    for i in range(tcfg.D):
        w, b = tp[f"pts_linears.{i}.weight"], tp[f"pts_linears.{i}.bias"]
        if bf16:
            x = fused_mlp.bf16_round(x)
            h = fused_mlp.bf16_round(torch.relu(x @ fused_mlp.bf16_round(w).t() + b))
        else:
            h = torch.relu(x @ w.t() + b)
        masks.append(h > 0)
        x = torch.cat([emb[:, :P], h], -1) if i in tcfg.skips else h
    if tcfg.use_viewdirs:
        rnd = fused_mlp.bf16_round if bf16 else (lambda a: a)  # noqa: E731

        def dense(name, a):
            return rnd(a) @ rnd(tp[name + ".weight"]).t() + tp[name + ".bias"]

        feature = rnd(dense("feature_linear", x))
        masks.append(dense("views_linears.0", torch.cat([feature, emb[:, P:]], -1)) > 0)
    want = plain(tp, tcfg, pts, vd, g)
    got = masked(tp, tcfg, pts, vd, g, masks)
    tol = 0 if bf16 else 1e-6
    _check_b2(got[0], want[0], got[1].numpy(), want[1].numpy(),
              None if vd is None else got[2].numpy(), None if vd is None else want[2].numpy(),
              tol=tol)
    on = masks[0].nonzero()[0]
    masks[0] = masks[0].clone()
    masks[0][on[0], on[1]] = False
    moved = masked(tp, tcfg, pts, vd, g, masks)
    dp = (moved[1] - want[1]).reshape(n, 3).abs().sum(-1)
    assert dp[on[0]] > 0 and (dp[torch.arange(n) != on[0]] <= 1e-5 * float(dp.max())).all()
    assert not torch.equal(moved[0]["pts_linears.0.weight"], want[0]["pts_linears.0.weight"])


def test_relu_masks_read_the_h_segments():
    """chip_smoke.relu_masks takes h_l > 0 from H's segment 1 + l and hv >
    0 from its hv segment, the first n rows and W (W / 2) columns of each."""
    cfg = tnerf.NeRFConfig(D=3, W=8, skips=(1,), multires=2, multires_views=1)
    hseg, _, hf, _ = fused_mlp_bwd.act_layout(cfg)
    n_pad, n = 128, 100
    hbuf = torch.randn(n_pad * hf, generator=torch.Generator().manual_seed(0))
    masks = chip_smoke.relu_masks(cfg, hbuf, n_pad, n)
    assert len(masks) == 4 and masks[-1].shape == (n, 4)
    for slot, m in zip([1, 2, 3, fused_mlp_bwd.H_HV], masks):
        off, ld = (int(v) for v in hseg[slot])
        want = hbuf[off * n_pad:(off + ld) * n_pad].view(n_pad, ld)[:n, :m.shape[1]] > 0
        assert torch.equal(m, want)


@pytest.mark.parametrize("n_pad,splits", [(64, 1), (64, 2), (64, 5), (320, 3),
                                          (65536, 12), (196608, 12), (19520, 7)])
def test_split_ranges_cover_every_point_exactly_once(n_pad, splits):
    """nerf_dw_kernel's ranges (the kernel's own formula, blockIdx.y) tile
    [0, n_pad) in order, in whole 32-point chunks; a range may be empty
    only when there are more ranges than chunks."""
    ranges = fused_mlp_bwd.split_ranges(n_pad, splits)
    assert len(ranges) == splits
    covered = np.zeros(n_pad, np.int64)
    end = 0
    for kb, ke in ranges:
        assert kb == end and ke >= kb and kb % fused_mlp_bwd.DW_KC == 0
        covered[kb:ke] += 1
        end = ke
    assert end == n_pad and (covered == 1).all()
    if splits <= n_pad // fused_mlp_bwd.DW_KC:
        assert all(ke > kb for kb, ke in ranges)


def test_dw_splits_fill_the_card_and_stay_in_range():
    """About two blocks an SM twice over at the lego width's 42 tiles (39
    wide, 3 narrow), never more ranges than chunks, at least one."""
    cfg = tnerf.NeRFConfig()
    n_tiles = len(fused_mlp_bwd.dw_tiles(fused_mlp_bwd.dw_jobs(cfg)))
    assert n_tiles == 42
    s = fused_mlp_bwd.dw_splits(196608, n_tiles, 132)
    assert s == 12 and 4 * 132 - n_tiles < s * n_tiles <= 4 * 132
    assert fused_mlp_bwd.dw_splits(64, n_tiles, 132) == 2
    assert fused_mlp_bwd.dw_splits(64, 10_000, 132) == 1


def test_reduction_sums_the_ranges_in_a_fixed_order():
    """reduce_partials (grad_reduce_kernel's plain version) is the left fold
    over ranges 0, 1, 2, ... in fp32: with 2^24, 1, -2^24 the order shows
    (this order gives 0, a pairwise or reversed sum 1), and repeated calls
    agree bit for bit."""
    part = torch.tensor([[2.0 ** 24, 3.0], [1.0, 4.0], [-(2.0 ** 24), 5.0]])
    out = fused_mlp_bwd.reduce_partials(part.reshape(-1), 3)
    assert out.tolist() == [0.0, 12.0]
    r = torch.randn(7, 1000, generator=torch.Generator().manual_seed(0)) * 1e3
    a = fused_mlp_bwd.reduce_partials(r.reshape(-1), 7)
    b = fused_mlp_bwd.reduce_partials(r.clone().reshape(-1), 7)
    want = r[0]
    for i in range(1, 7):
        want = want + r[i]
    assert torch.equal(a, b) and torch.equal(a, want)


@pytest.mark.parametrize("kw", [LEGO] + PHASE5, ids=["lego"] + PHASE5_IDS)
def test_dw_tiles_write_every_packed_gradient_once(kw):
    """Over all tiles of all products, every float of the packed gradient
    layout (weights, biases, row padding) is written exactly once, so a
    partial copy needs no zeroing; each product reads H and dZ columns
    inside its segment's row, 16-byte aligned."""
    cfg = tnerf.NeRFConfig(**kw)
    jobs = fused_mlp_bwd.dw_jobs(cfg)
    tiles = fused_mlp_bwd.dw_tiles(jobs)
    _, wsize = fused_mlp.packed_layout(cfg)
    hseg, zseg, _, _ = fused_mlp_bwd.act_layout(cfg)
    hits = np.zeros(wsize, np.int64)
    BM, BN = fused_mlp_bwd.DW_BM, fused_mlp_bwd.DW_BN
    for j, m0, n0 in tiles:
        kind, hslot, hcol, M, zslot, zcol, N, w_off, ld, b_off = jobs[j]
        wide = kind == fused_mlp_bwd.DW_WIDE
        n_end = min(ld, n0 + (BN if wide else ld))   # as the kernel's epilogue
        rows = np.arange(m0, min(M, m0 + BM))
        cols = np.arange(n0, n_end)
        hits[w_off + rows[:, None] * ld + cols[None, :]] += 1
        if b_off >= 0 and m0 == 0:
            hits[b_off + cols] += 1
        assert hseg[hslot, 0] >= 0 and zseg[zslot, 0] >= 0
        assert hcol % 4 == 0 and hcol + fused_mlp._round4(M) <= hseg[hslot, 1]
        assert (zcol + fused_mlp._round4(N) <= zseg[zslot, 1] if wide
                else zcol + N <= zseg[zslot, 1] and N <= 8)
    assert (hits == 1).all()


def test_act_layout_at_the_lego_width():
    """H: the embedding (92 floats), h_0..h_7, the feature (256 each) and hv
    (128); dZ: dz_0..dz_7, dfeature (256 each), dhv (128) and the cotangent
    tile (8): 19,856 bytes a point, ~3.9 GB at 196,608 points. Segments do
    not overlap; every stride is a multiple of 4 floats."""
    cfg = tnerf.NeRFConfig()
    hseg, zseg, hf, zf = fused_mlp_bwd.act_layout(cfg)
    assert (hf, zf) == (92 + 9 * 256 + 128, 9 * 256 + 128 + 8)
    assert 4 * (hf + zf) == 19_856
    assert 196_608 * 4 * (hf + zf) / 1e9 == pytest.approx(3.9, abs=0.01)
    for table, total in ((hseg, hf), (zseg, zf)):
        used = table[table[:, 0] >= 0]
        assert (used[:, 1] % 4 == 0).all() and (used[:, 0] % 4 == 0).all()
        spans = sorted((int(o), int(o + ld)) for o, ld in used)
        assert spans[0][0] == 0 and spans[-1][1] == total
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


# --- B2's host pack: one gather through a per-architecture source map -------


def _pack_network_loop(params, cfg):
    """The parameters in packed_layout (a slice assignment a matrix): the
    layout of B2's gradient buffer."""
    layout, size = fused_mlp.packed_layout(cfg)
    wbuf = torch.zeros(size, dtype=torch.float32)
    for name, (off, rows, cols, ld) in layout.items():
        t = params[name].detach()
        t = t.t() if t.dim() == 2 else t[None]
        wbuf[off:off + rows * ld].view(rows, ld)[:, :cols] = t
    return wbuf


def _pack_backward_loop(params, cfg, bf16=False):
    """pack_backward_tc's buffer built GEMM by GEMM and slice by slice with
    the K-major core-matrix index written out, the reference of the
    gathered pack: fp32, big plane then small plane a slice, (k, n) at (n
    // 8) 64 + (k // 4) 32 + (n % 8) 4 + k % 4; bf16, one plane of 16 rows,
    (k, n) at (n // 8) 128 + (k // 8) 64 + (n % 8) 8 + k % 8 bf16 values."""
    layout, size, _ = fused_mlp_bwd.bwd_layout(cfg, bf16)
    out = torch.zeros(2 * size if bf16 else size,
                      dtype=torch.bfloat16 if bf16 else torch.float32)
    for (name, col0, N, _, _), (w_off, Kp, Np) in zip(fused_mlp_bwd.bwd_gemms(cfg), layout):
        w = params[name + ".weight"].detach()[:, col0:col0 + N]
        blk = torch.zeros(Kp, Np)
        blk[:w.shape[0], :N] = w
        k = torch.arange(16 if bf16 else 8)[:, None]
        n = torch.arange(Np)[None, :]
        if bf16:
            at = (n // 8) * 128 + (k // 8) * 64 + (n % 8) * 8 + k % 8
            for sl in range(Kp // 16):
                out[2 * w_off + sl * 16 * Np + at] = blk[16 * sl:16 * sl + 16].to(torch.bfloat16)
            continue
        at = (n // 8) * 64 + (k // 4) * 32 + (n % 8) * 4 + k % 4
        for plane, val in enumerate(fused_mlp.tf32_split(blk)):
            for sl in range(Kp // 8):
                out[w_off + sl * 16 * Np + plane * 8 * Np + at] = val[8 * sl:8 * sl + 8]
    return out.view(torch.float32) if bf16 else out


PACK_ARCHS = [LEGO] + PHASE5 + [dict(D=5, skips=(1, 3), W=24, multires=6,
                                     multires_views=2)]


@pytest.mark.parametrize("kw", PACK_ARCHS, ids=["lego"] + PHASE5_IDS + ["two_skips_w24"])
def test_gathered_packs_are_the_per_matrix_packs_bit_for_bit(kw):
    """pack_backward_tc gathers through a source map made once per
    architecture; its buffer is the per-GEMM, per-slice pack's bit for bit
    in fp32 and in bf16, and a second call reuses the map and descriptor."""
    _, _, tcfg, tp = _models(seed=2, **kw)
    tp = {k: v + 0.25 for k, v in tp.items()}
    wbt, bdesc = fused_mlp_bwd.pack_backward_tc(tp, tcfg, "cpu")
    assert torch.equal(wbt, _pack_backward_loop(tp, tcfg))
    w16, _ = fused_mlp_bwd.pack_backward_tc(tp, tcfg, "cpu", torch.bfloat16)
    assert torch.equal(w16.view(torch.int32), _pack_backward_loop(tp, tcfg, True).view(torch.int32))
    wbt2, bdesc2 = fused_mlp_bwd.pack_backward_tc(tp, tcfg, "cpu")
    assert torch.equal(wbt2, wbt) and bdesc2 is bdesc


@pytest.mark.parametrize("module,symbol", [(fused_mlp_bwd, "nstt_mlp_backward"),
                                           (fused_mlp_bwd, "nstt_mlp_backward_bf16")])
def test_entry_argtypes_match_the_c_signature(module, symbol):
    """ctypes passes each argument as its argtype says: a pointer typed as
    an int would be cut to 32 bits. The wrapper's list matches the C
    entry's parameters one for one."""
    import ctypes
    src = (common.CSRC / "fused_mlp_bwd.cu").read_text()
    sig = src[src.index(f'extern "C" int {symbol}('):]
    params = [p.strip() for p in sig[sig.index("(") + 1:sig.index(")")].split(",")]
    kinds = [ctypes.c_void_p if "*" in p else
             ctypes.c_longlong if p.startswith("long long") else
             ctypes.c_int if p.startswith("int ") else None for p in params]
    assert None not in kinds and kinds == module._ARGS
