"""The training kernels' modules on the CPU: B1 (ops/cuda/fused_mlp.py
fused_nerf_forward) and B2 (ops/cuda/fused_mlp_bwd.py).

A CUDA kernel cannot run here, so these tests hold what surrounds it:

- the plain versions against the JAX package's Pallas kernels, run as the
  JAX suite runs them on the CPU (interpret mode; one 512-point grid step
  of the backward at this size);
- the CPU dispatch of fused_nerf_forward, fused_mlp_backward and
  fused_train_op, and the guards;
- the packed forward and backward weights, descriptors and encoder table
  the kernels read, driven through a numpy transcription of the kernels'
  arithmetic (csrc/mlp_tile.cuh encode_points, csrc/fused_mlp_bwd.cu).

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
    """encode_points forms f·x from the encoder table, rounded once: for
    every column that is exactly the plain embed's x * f."""
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


def _emulate_b2(params, cfg, pts, vd, g):
    """numpy (float64) transcription of csrc/fused_mlp_bwd.cu on the packed
    forward weights, the PyTorch-layout segments and both descriptors ->
    (grads, dpts, ddirs), gradients written into the packed layout and
    unpacked by the wrapper's own unpack_grads."""
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
    bh = bdesc[128:].reshape(6, 2)
    S = pts.shape[-2]
    x = pts.reshape(-1, 3).astype(np.float64)
    n = x.shape[0]
    xd = np.repeat(vd, S, axis=0).astype(np.float64) if VD else np.zeros_like(x)
    xin = np.concatenate([x, xd], -1)

    cols = [c if c < P else -1 for c in range(P4)]
    cols += [P + c if c < V else -1 for c in range(V4)]
    emb = np.zeros((n, P4 + V4))
    for c, cc in enumerate(cols):
        if cc < 0:
            continue
        xs, f, k = xin[:, int(enc[256 + cc])], enc[cc], kind[cc]
        emb[:, c] = xs if k == 0 else (np.sin(f * xs) if k == 1 else np.cos(f * xs))

    grads = np.zeros_like(wbuf)

    def fw(m):
        w, b, K, ld = (int(v) for v in m)
        return wbuf[w:w + K * ld].reshape(K, ld), wbuf[b:b + ld]

    def gw(m):
        w, b, K, ld = (int(v) for v in m)
        return grads[w:w + K * ld].reshape(K, ld), grads[b:b + ld]

    def tw(entry, rows):
        off, ld = (int(v) for v in entry)
        return wbt[off:off + rows * ld].reshape(rows, ld)

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
    gr = g.reshape(n, -1).astype(np.float64)
    demb = np.zeros_like(emb)
    W2 = W // 2
    if VD:
        Wf, bf = fw(heads[1])
        Wv, bv = fw(heads[2])
        feat = hs[-1] @ Wf[:, :W] + bf[:W]
        hv = relu(feat @ Wv[:W, :W2] + emb[:, P4:P4 + V] @ Wv[W:W + V, :W2] + bv[:W2])
        Gr, Gbr = gw(heads[3])
        Gr[:W2, :3] += hv.T @ gr[:, :3]
        Gbr[:3] += gr[:, :3].sum(0)
        dhv = (gr[:, :3] @ tw(bh[4], 3)[:, :W2]) * (hv > 0)
        Gv, Gbv = gw(heads[2])
        Gv[:W, :W2] += feat.T @ dhv
        Gv[W:W + V, :W2] += emb[:, P4:P4 + V].T @ dhv
        Gbv[:W2] += dhv.sum(0)
        demb[:, P4:P4 + V] += dhv @ tw(bh[3], W2)[:, :V]
        dfeat = dhv @ tw(bh[2], W2)[:, :W]
        Gf, Gbf = gw(heads[1])
        Gf[:, :W] += hs[-1].T @ dfeat
        Gbf[:W] += dfeat.sum(0)
        Ga, Gba = gw(heads[0])
        Ga[:, :1] += hs[-1].T @ gr[:, 3:4]
        Gba[:1] += gr[:, 3].sum(0)
        dh = dfeat @ tw(bh[1], W)[:, :W] + gr[:, 3:4] @ tw(bh[0], 1)[:, :W]
    else:
        Go, Gbo = gw(heads[4])
        Go[:, :OUT] += hs[-1].T @ gr
        Gbo[:OUT] += gr.sum(0)
        dh = gr @ tw(bh[5], OUT)[:, :W]
    for l in reversed(range(D)):
        dz = dh * (hs[l] > 0)
        Gl, Gbl = gw(layers[l])
        Gbl[:W] += dz.sum(0)
        from_emb = l == 0 or (SK >> l) & 1
        if from_emb:
            Gl[:P, :W] += emb[:, :P].T @ dz
            demb[:, :P] += dz @ tw(seg[l, 0], W)[:, :P]
        if l > 0:
            koff = P if from_emb else 0
            Gl[koff:koff + W, :W] += hs[l - 1].T @ dz
            dh = dz @ tw(seg[l, 1], W)[:, :W]
    dx = np.zeros((n, 6))
    for c, cc in enumerate(cols):
        if cc < 0:
            continue
        s, f, k = int(enc[256 + cc]), enc[cc], kind[cc]
        der = 1.0 if k == 0 else (f * np.cos(f * xin[:, s]) if k == 1
                                  else -f * np.sin(f * xin[:, s]))
        dx[:, s] += demb[:, c] * der
    tg = fused_mlp_bwd.unpack_grads(torch.from_numpy(grads.astype(np.float32)), cfg)
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
    """One B2 block keeps X, Y, the encoding, its gradient, the cotangent
    tile and a 16-row weight tile in shared memory: it must fit the 227 KB
    a block may use at the lego width and with the stonehenge encoder."""
    lego = tnerf.NeRFConfig()
    stone = tnerf.NeRFConfig(multires=15, multires_views=6)
    assert fused_mlp_bwd.smem_bytes(lego) < fused_mlp_bwd.smem_bytes(stone)
    assert fused_mlp_bwd.smem_bytes(stone) <= fused_mlp_bwd.MAX_SMEM


def test_flop_counts_at_the_lego_width():
    """1,186,816 FLOP per point forward (8x256, skip at 4, viewdirs,
    multires 10/4); the backward is three forwards less the narrow heads'
    rematerialisation."""
    cfg = tnerf.NeRFConfig()
    f = fused_mlp.flops_per_point(cfg)
    assert f == 1_186_816
    assert fused_mlp_bwd.flops_per_point_bwd(cfg) == 3 * f - 2 * (256 + 128 * 3)


def test_unpack_grads_inverts_the_packed_layout():
    _, _, tcfg, tp = _models()
    wbuf, _, _, _ = fused_mlp.pack_network(tp, tcfg, "cpu")
    back = fused_mlp_bwd.unpack_grads(wbuf, tcfg)
    assert list(back) == list(fused_mlp.packed_layout(tcfg)[0])
    for k, v in tp.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)
