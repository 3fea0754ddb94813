"""The training kernels' modules on the CPU: B1 (ops/cuda/fused_mlp.py
fused_nerf_forward) and B2 (ops/cuda/fused_mlp_bwd.py).

A CUDA kernel cannot run here, so these tests hold what surrounds it:

- the plain versions against the JAX package's Pallas kernels, run as the
  JAX suite runs them on the CPU (interpret mode; one 512-point grid step
  of the backward at this size);
- the CPU dispatch of fused_nerf_forward, fused_mlp_backward and
  fused_train_op, and the guards;
- the packed forward and backward weights, descriptors and encoder table
  B2 reads, driven through a numpy transcription of its arithmetic
  (csrc/mlp_tile.cuh encode_points, csrc/fused_mlp_bwd.cu); B1's
  tensor-core arithmetic is emulated in tests/test_torch_tc_mlp.py.

The kernels themselves are held against the plain versions on the card by
chip_smoke.py (phase 5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    """B1's point-major encoder (csrc/mlp_tile_tc.cuh PointEnc) and B2's
    encode_points (csrc/mlp_tile.cuh) form f·x from the encoder table,
    rounded once: for every column that is exactly the plain embed's
    x * f."""
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
        acc = np.cumsum(np.concatenate([acc[None], sl.numpy()]), 0, dtype=np.float32)[-1]
    return acc


def _dw_narrow(h, z):
    """The CUDA-core product of a narrow head: fp32 fma in point order."""
    prod = h[:, :, None].astype(np.float64) * z[:, None, :]
    acc = np.zeros(prod.shape[1:], np.float32)
    return np.cumsum(np.concatenate([acc[None], prod.astype(np.float32)]), 0,
                     dtype=np.float32)[-1]


def _emulate_b2(params, cfg, pts, vd, g, sms=132, buffers=None):
    """numpy transcription of csrc/fused_mlp_bwd.cu on the packed forward
    weights, the PyTorch-layout segments, both descriptors and the dW
    tables -> (grads, dpts, ddirs):

    - the tile kernel in float64: forward, input gradients, dx; it writes
      each layer input H and post-mask cotangent dZ (float32) into the two
      buffers at act_layout's offsets for n_pad points (the rest NaN, as
      torch.empty may leave it, so a read past the points shows);
    - nerf_dw_kernel: every dw_jobs product over each split_ranges range
      (rows at or past n zero, as the kernel's staging fills them), split
      fp32 with k8 slice sums (_dw_wide) or fp32 fma (_dw_narrow), biases
      fp32 sums in point order, into one partial copy of the packed
      gradients per range (padding zero);
    - the ranges summed in order by the wrapper's reduce_partials, and
      unpacked by its unpack_grads.

    ``buffers``, a dict, receives hbuf, zbuf, part and the split count."""
    wbuf, desc, HS, ES = fused_mlp.pack_network(params, cfg, "cpu")
    wbt, bdesc = fused_mlp_bwd.pack_backward(params, cfg, "cpu")
    enc = fused_mlp.encoder_buffer(cfg, "cpu").numpy().astype(np.float64)
    wbuf, wbt = wbuf.numpy().astype(np.float64), wbt.numpy().astype(np.float64)
    desc, bdesc = desc.numpy(), bdesc.numpy()
    D, W, P, V, _, OUT, VD, P4, V4, SK, HS = (int(v) for v in desc[:11])
    layers = desc[16:144].reshape(32, 4)
    heads = desc[144:164].reshape(5, 4)
    kind = desc[164:].view(np.int8)
    seg = bdesc[:128].reshape(32, 2, 2)
    bh = bdesc[128:140].reshape(6, 2)
    nseg = fused_mlp_bwd.N_SEG
    hseg = bdesc[140:140 + 2 * nseg].reshape(nseg, 2)
    zseg = bdesc[140 + 2 * nseg:].reshape(nseg, 2)
    S = pts.shape[-2]
    x = pts.reshape(-1, 3).astype(np.float64)
    n = x.shape[0]
    n_pad = -(-n // fused_mlp_bwd.TILE_P) * fused_mlp_bwd.TILE_P
    _, _, h_floats, z_floats = fused_mlp_bwd.act_layout(cfg)
    hbuf = np.full(n_pad * h_floats, np.nan, np.float32)
    zbuf = np.full(n_pad * z_floats, np.nan, np.float32)

    def rows(buf, table, slot):
        off, ld = (int(v) for v in table[slot])
        return buf[off * n_pad:(off + ld) * n_pad].reshape(n_pad, ld)

    def put(buf, table, slot, a):
        r = rows(buf, table, slot)
        r[:n] = 0.0
        r[:n, :a.shape[1]] = a

    xd = np.repeat(vd, S, axis=0).astype(np.float64) if VD else np.zeros_like(x)
    xin = np.concatenate([x, xd], -1)

    cols = [c if c < P else -1 for c in range(P4)]
    cols += [P + c if c < V else -1 for c in range(V4)]
    emb = np.zeros((n, P4 + V4))
    def arg(f, xs):
        """f·x rounded once to fp32, as encode_points and embed form it"""
        return (np.float32(f) * xs.astype(np.float32)).astype(np.float64)

    for c, cc in enumerate(cols):
        if cc < 0:
            continue
        xs, f, k = xin[:, int(enc[256 + cc])], enc[cc], kind[cc]
        emb[:, c] = xs if k == 0 else (np.sin(arg(f, xs)) if k == 1 else np.cos(arg(f, xs)))
    put(hbuf, hseg, fused_mlp_bwd.H_EMB, emb)

    def fw(m):
        w, b, K, ld = (int(v) for v in m)
        return wbuf[w:w + K * ld].reshape(K, ld), wbuf[b:b + ld]

    def tw(entry, rows_):
        off, ld = (int(v) for v in entry)
        return wbt[off:off + rows_ * ld].reshape(rows_, ld)

    relu = lambda a: np.maximum(a, 0.0)  # noqa: E731
    hs = []
    for l in range(D):
        Wm, b = fw(layers[l])
        if l == 0:
            z = emb[:, :P] @ Wm[:P, :W]
        elif (SK >> l) & 1:
            z = emb[:, :P] @ Wm[:P, :W] + hs[-1] @ Wm[P:P + W, :W]
        else:
            z = hs[-1] @ Wm[:W, :W]
        hs.append(relu(z + b[:W]))
        put(hbuf, hseg, 1 + l, hs[-1])
    gr = g.reshape(n, -1).astype(np.float64)
    gt = np.zeros((n, fused_mlp_bwd.G_LD))
    if VD:
        gt[:, :4], gt[:, 4] = gr, gr[:, 3]
    else:
        gt[:, :OUT] = gr
    put(zbuf, zseg, fused_mlp_bwd.Z_GR, gt)
    demb = np.zeros_like(emb)
    W2 = W // 2
    if VD:
        Wf, bf = fw(heads[1])
        Wv, bv = fw(heads[2])
        feat = hs[-1] @ Wf[:, :W] + bf[:W]
        hv = relu(feat @ Wv[:W, :W2] + emb[:, P4:P4 + V] @ Wv[W:W + V, :W2] + bv[:W2])
        put(hbuf, hseg, fused_mlp_bwd.H_FEATURE, feat)
        put(hbuf, hseg, fused_mlp_bwd.H_HV, hv)
        dhv = (gr[:, :3] @ tw(bh[4], 3)[:, :W2]) * (hv > 0)
        put(zbuf, zseg, fused_mlp_bwd.Z_DHV, dhv)
        demb[:, P4:P4 + V] += dhv @ tw(bh[3], W2)[:, :V]
        dfeat = dhv @ tw(bh[2], W2)[:, :W]
        put(zbuf, zseg, fused_mlp_bwd.Z_DFEATURE, dfeat)
        dh = dfeat @ tw(bh[1], W)[:, :W] + gr[:, 3:4] @ tw(bh[0], 1)[:, :W]
    else:
        dh = gr @ tw(bh[5], OUT)[:, :W]
    for l in reversed(range(D)):
        dz = dh * (hs[l] > 0)
        put(zbuf, zseg, l, dz)
        from_emb = l == 0 or (SK >> l) & 1
        if from_emb:
            demb[:, :P] += dz @ tw(seg[l, 0], W)[:, :P]
        if l > 0:
            dh = dz @ tw(seg[l, 1], W)[:, :W]
    dx = np.zeros((n, 6))
    for c, cc in enumerate(cols):
        if cc < 0:
            continue
        s, f, k = int(enc[256 + cc]), enc[cc], kind[cc]
        der = 1.0 if k == 0 else (f * np.cos(arg(f, xin[:, s])) if k == 1
                                  else -f * np.sin(arg(f, xin[:, s])))
        dx[:, s] += demb[:, c] * der

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
            dw = _dw_wide(h, z) if kind_ == fused_mlp_bwd.DW_WIDE else _dw_narrow(h, z)
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
    """One tile-kernel block keeps X, Y, the encoding, its gradient, the
    cotangent tile, a 16-row weight tile and the NetDesc and BwdDesc (now
    with the H / dZ segments) in shared memory: it must fit the 227 KB a
    block may use at the lego width and with the stonehenge encoder. Two
    nerf_dw_kernel blocks (three stages of 32-point H and dZ chunks each)
    must fit one SM's 228 KB."""
    lego = tnerf.NeRFConfig()
    stone = tnerf.NeRFConfig(multires=15, multires_views=6)
    assert fused_mlp_bwd.smem_bytes(lego) < fused_mlp_bwd.smem_bytes(stone)
    assert fused_mlp_bwd.smem_bytes(stone) <= fused_mlp_bwd.MAX_SMEM
    words = 32 * 2 * 2 + 6 * 2 + 2 * fused_mlp_bwd.N_SEG * 2
    _, bdesc = fused_mlp_bwd.pack_backward(
        tnerf.NeRF(lego).params(), lego, "cpu")
    assert bdesc.numel() == words
    dw = fused_mlp_bwd.dw_smem_bytes()
    assert dw == 4 * 3 * 2 * 32 * 136
    assert fused_mlp_bwd.DW_BLOCKS_PER_SM * dw <= 228 * 1024


def test_flop_counts_at_the_lego_width():
    """1,186,816 FLOP per point forward (8x256, skip at 4, viewdirs,
    multires 10/4); the backward is three forwards less the narrow heads'
    rematerialisation."""
    cfg = tnerf.NeRFConfig()
    f = fused_mlp.flops_per_point(cfg)
    assert f == 1_186_816
    assert fused_mlp_bwd.flops_per_point_bwd(cfg) == 3 * f - 2 * (256 + 128 * 3)


def test_flop_counts_of_the_two_kernels():
    """nerf_dw_kernel does one forward's multiply-adds (every dW = H^T·dZ,
    the narrow heads' included), the tile kernel the remaining two forwards
    less the narrow heads' rematerialisation; together B2's count."""
    for cfg in (tnerf.NeRFConfig(), tnerf.NeRFConfig(D=3, W=64, skips=(1,),
                                                     use_viewdirs=False, output_ch=5)):
        f = fused_mlp.flops_per_point(cfg)
        tile, dw = fused_mlp_bwd.flops_per_point_tile(cfg), fused_mlp_bwd.flops_per_point_dw(cfg)
        assert dw == f
        assert tile + dw == fused_mlp_bwd.flops_per_point_bwd(cfg)
    assert fused_mlp_bwd.flops_per_point_tile(tnerf.NeRFConfig()) == 2 * 1_186_816 - 2 * 640


def test_unpack_grads_inverts_the_packed_layout():
    _, _, tcfg, tp = _models()
    wbuf, _, _, _ = fused_mlp.pack_network(tp, tcfg, "cpu")
    back = fused_mlp_bwd.unpack_grads(wbuf, tcfg)
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


def _plain64(tp, tcfg, pts, vd, g):
    """plain_mlp_backward in float64 -> (grads, dpts, ddirs) as numpy /
    float64 tensors. At 19,500 points the fp32 chain itself reads up to
    1.6e-3 of max|grad| away from it on these seeded networks, far from
    the transcription's ~4e-7."""
    d = lambda a: None if a is None else torch.from_numpy(np.asarray(a, np.float64))  # noqa: E731
    grads, dpts, ddirs = fused_mlp_bwd.plain_mlp_backward(
        {k: v.double() for k, v in tp.items()}, tcfg, d(pts), d(vd), d(g))
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
    float64 (the transcription stays within 4e-7 of it)."""
    jcfg, jp, tcfg, tp, pts, vd, g = _b2_case(kw, 37, 7)
    bufs = {}
    got, dpts, ddirs = _emulate_b2(tp, tcfg, pts, vd, g, buffers=bufs)
    assert bufs["n_pad"] == 320 and bufs["splits"] >= 1
    want, wpts, wdirs = _plain64(tp, tcfg, pts, vd, g)
    _check_b2(_as64(got), want, dpts, wpts, ddirs, wdirs)
    jwant, dx = _pallas_backward(jcfg, jp, pts, vd, g)
    jdirs = None if vd is None else dx[:, 3:6].reshape(pts.shape).sum(1)
    tol = 5e-2 if kw.get("multires") == 15 else 1e-4
    _check_b2(got, jwant, dpts, dx[:, :3], ddirs, jdirs, tol=tol)


@pytest.mark.parametrize("kw", PHASE5, ids=PHASE5_IDS)
def test_two_stage_b2_at_300_rays_of_65(kw):
    """As above at 300 x 65 = 19,500 points, several point ranges each,
    against plain_mlp_backward in float64 (tolerance 1e-4)."""
    _, _, tcfg, tp, pts, vd, g = _b2_case(kw, 300, 65, seed=5)
    bufs = {}
    got, dpts, ddirs = _emulate_b2(tp, tcfg, pts, vd, g, buffers=bufs)
    assert bufs["splits"] > 1
    want, wpts, wdirs = _plain64(tp, tcfg, pts, vd, g)
    _check_b2(_as64(got), want, dpts, wpts, ddirs, wdirs)


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
    """The earlier per-matrix pack (a slice assignment a matrix), the
    reference of the gathered one."""
    layout, size = fused_mlp.packed_layout(cfg)
    wbuf = torch.zeros(size, dtype=torch.float32)
    for name, (off, rows, cols, ld) in layout.items():
        t = params[name].detach()
        t = t.t() if t.dim() == 2 else t[None]
        wbuf[off:off + rows * ld].view(rows, ld)[:, :cols] = t
    return wbuf


def _pack_backward_loop(params, cfg):
    """The earlier per-segment pack (a pad a segment and a cat), the
    reference of the gathered one."""
    import torch.nn.functional as F
    P, W = cfg.input_ch, cfg.W
    pieces = []

    def add(t):
        ld = fused_mlp._round4(t.shape[1])
        pieces.append(F.pad(t.detach(), (0, ld - t.shape[1])).reshape(-1))

    for i in range(cfg.D):
        w = params[f"pts_linears.{i}.weight"]
        if i == 0:
            add(w)
        elif (i - 1) in cfg.skips:
            add(w[:, :P]), add(w[:, P:])
        else:
            add(w)
    if cfg.use_viewdirs:
        wv = params["views_linears.0.weight"]
        add(params["alpha_linear.weight"]), add(params["feature_linear.weight"])
        add(wv[:, :W]), add(wv[:, W:]), add(params["rgb_linear.weight"])
    else:
        add(params["output_linear.weight"])
    return torch.cat(pieces)


PACK_ARCHS = [LEGO] + PHASE5 + [dict(D=5, skips=(1, 3), W=24, multires=6,
                                     multires_views=2)]


@pytest.mark.parametrize("kw", PACK_ARCHS, ids=["lego"] + PHASE5_IDS + ["two_skips_w24"])
def test_gathered_packs_are_the_per_matrix_packs_bit_for_bit(kw):
    """pack_network and pack_backward gather through source maps made once
    per architecture; the buffers are the old per-matrix packs' bit for
    bit, and the NetDesc is unchanged."""
    _, _, tcfg, tp = _models(seed=2, **kw)
    tp = {k: v + 0.25 for k, v in tp.items()}
    wbuf, desc, HS, ES = fused_mlp.pack_network(tp, tcfg, "cpu")
    assert torch.equal(wbuf, _pack_network_loop(tp, tcfg))
    wbt, bdesc = fused_mlp_bwd.pack_backward(tp, tcfg, "cpu")
    assert torch.equal(wbt, _pack_backward_loop(tp, tcfg))
    assert HS == fused_mlp._round4(tcfg.W)
    assert int(desc[10]) == HS and ES == int(desc[7]) + int(desc[8])
    # a second call reuses the cached maps (keyed by the config)
    wbuf2, desc2, _, _ = fused_mlp.pack_network(tp, tcfg, "cpu")
    assert torch.equal(wbuf2, wbuf) and desc2 is desc


@pytest.mark.parametrize("module,symbol", [(fused_mlp_bwd, "nstt_mlp_backward")])
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
