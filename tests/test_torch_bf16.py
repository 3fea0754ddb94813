"""``--precision bf16`` on the CPU, against the JAX package: the plain bf16
network (``models/nerf.apply_nerf(..., torch.bfloat16)``), the plain
versions of the bf16 instantiations of kernels B1, B2, B3 and B4, their
pack, the remat backward of B3 and B4, and a bf16 training step and a bf16
rendered frame through the CLIs' configs.

The JAX functions run as the JAX suite runs them on the CPU (Pallas in
interpret mode). Inputs come from numpy seeds at D = 4, W = 64, a skip,
viewdirs and a few hundred points. Tolerance, unless a test says
otherwise: 1e-2 x max(1, max|ref|) in max abs error, a few bf16 ulps (an
fp32 sum in another order than XLA's flips a bf16 rounding now and then).

The CUDA kernels themselves are held against these plain versions on the
card by chip_smoke.py (phase 15).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_shared_tpu.apps.train import render_only as jax_render_only
from nerf_shared_tpu.config import config_parser as jax_parser
from nerf_shared_tpu.factory import create_nerf_models
from nerf_shared_tpu.factory import get_renderer as jax_get_renderer
from nerf_shared_tpu.models import nerf as jnerf
from nerf_shared_tpu.ops.pallas import fused_mlp as jfm
from nerf_shared_tpu.ops.pallas import fused_mlp_bwd as jbwd
from nerf_shared_tpu.ops.pallas import fused_render as jfr
from nerf_shared_tpu.render.renderer import render_rays as j_render_rays
from nerf_shared_tpu.train import pipeline as jpipe
from nerf_shared_tpu.train.state import create_train_state as j_create_state
from nerf_shared_tpu.train.step import pack_ray_batch as j_pack
from nerf_shared_tpu.utils.checkpoints import save_tar as jax_save_tar
from nerf_shared_tpu.utils.metrics import img2mse as j_img2mse
from nerf_shared_tpu_torch.apps.serve import serve_parser
from nerf_shared_tpu_torch.apps.train import build_eval_engine, render_only
from nerf_shared_tpu_torch.config import config_parser, resolve_fused_backward
from nerf_shared_tpu_torch.factory import get_renderer
from nerf_shared_tpu_torch.models import nerf as tnerf
from nerf_shared_tpu_torch.ops.cuda import fused_mlp, fused_mlp_bwd, fused_render
from nerf_shared_tpu_torch.render.renderer import RenderConfig
from nerf_shared_tpu_torch.train import pipeline as tpipe
from nerf_shared_tpu_torch.train.state import create_train_state
from nerf_shared_tpu_torch.train.step import make_train_step
from tests.test_e2e import _write_config, _write_scene

BF = torch.bfloat16
TOL = 1e-2
KW = dict(D=4, W=64, skips=(1,), multires=6, multires_views=3)


def _models(seed=0, **kw):
    kw = {**KW, **kw}
    jcfg = jnerf.NeRFConfig(**kw)
    jp = jnerf.init_nerf_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jp, tnerf.NeRFConfig(**kw), tnerf.params_from_jax(jax.device_get(jp))


def _rays(n=16, S=24, seed=3):
    """Seeded rays o, d [n, 3] (d unit), depths z [n, S] in [2, 6]."""
    rng = np.random.default_rng(seed)
    ro = (rng.standard_normal((n, 3)) * 0.1).astype(np.float32)
    rd = rng.standard_normal((n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    z = np.sort(rng.random((n, S)) * 4 + 2, -1).astype(np.float32)
    return ro, rd, z


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


# --- the plain bf16 network ----------------------------------------------------


@pytest.mark.parametrize("use_vd", [True, False])
def test_apply_nerf_bf16_is_the_jax_bf16_network(use_vd):
    """The port's apply_nerf in bf16 casts weights, biases and the embedding
    and rounds every product and bias add, as JAX's does: 0 differences
    seen at this size; held at the stated tolerance."""
    jcfg, jp, tcfg, tp = _models(use_viewdirs=use_vd, output_ch=4 if use_vd else 5)
    ro, rd, z = _rays()
    pts = ro[:, None] + rd[:, None] * z[..., None]
    vd = rd if use_vd else None
    want = jnerf.apply_nerf(jp, jcfg, jnp.asarray(pts), None if vd is None else jnp.asarray(vd),
                            compute_dtype=jnp.bfloat16)
    got = tnerf.apply_nerf(tp, tcfg, _t(pts), _t(vd), BF)
    assert got.dtype == torch.float32
    _close(got, want)
    # and it is not the fp32 network
    assert float((got - tnerf.apply_nerf(tp, tcfg, _t(pts), _t(vd))).abs().max()) > 1e-4


def test_apply_nerf_bf16_keeps_the_parameters_fp32():
    _, _, tcfg, tp = _models()
    ro, rd, z = _rays(n=2, S=3)
    w = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    pts = _t(ro[:, None] + rd[:, None] * z[..., None])
    tnerf.apply_nerf(w, tcfg, pts, _t(rd), BF).sum().backward()
    assert all(v.dtype == torch.float32 and v.grad.dtype == torch.float32 for v in w.values())


# --- the plain versions of the bf16 kernels against the Pallas kernels ------------


@pytest.mark.parametrize("use_vd", [True, False])
def test_plain_b1_bf16_matches_pallas(use_vd):
    jcfg, jp, tcfg, tp = _models(use_viewdirs=use_vd, output_ch=4 if use_vd else 5)
    ro, rd, z = _rays()
    pts = ro[:, None] + rd[:, None] * z[..., None]
    vd = rd if use_vd else None
    want = jfm.fused_nerf_forward(jp, jcfg, jnp.asarray(pts),
                                  None if vd is None else jnp.asarray(vd),
                                  compute_dtype=jnp.bfloat16)
    with torch.no_grad():
        got = fused_mlp.fused_nerf_forward(tp, tcfg, _t(pts), _t(vd), BF)
    _close(got, want)
    # the kernel's arithmetic, not the plain network's: closer to Pallas
    plain_net = tnerf.apply_nerf(tp, tcfg, _t(pts), _t(vd), BF)
    err_k = float((got - torch.from_numpy(np.asarray(want))).abs().max())
    err_n = float((plain_net - torch.from_numpy(np.asarray(want))).abs().max())
    assert err_k <= err_n


def test_plain_b3_bf16_matches_pallas():
    jcfg, jp, tcfg, tp = _models(seed=1)
    ro, rd, z = _rays(seed=4)
    want = jfm.fused_nerf_forward_rays(jp, jcfg, jnp.asarray(ro), jnp.asarray(rd),
                                       jnp.asarray(z), jnp.asarray(rd),
                                       compute_dtype=jnp.bfloat16)
    with torch.no_grad():
        got = fused_mlp.fused_nerf_forward_rays(tp, tcfg, _t(ro), _t(rd), _t(z), _t(rd), BF)
    _close(got, want)


@pytest.mark.parametrize("white", [True, False])
def test_plain_b4_bf16_matches_pallas(white):
    """rgb, disp, acc, weights and depth; the composite is fp32 in both."""
    jcfg, jp, tcfg, tp = _models(seed=2)
    ro, rd, z = _rays(seed=5)
    want = jfr.fused_render_rays(jp, jcfg, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z),
                                 jnp.asarray(rd), white_bkgd=white,
                                 compute_dtype=jnp.bfloat16)
    with torch.no_grad():
        got = fused_render.fused_render_rays(tp, tcfg, _t(ro), _t(rd), _t(z), _t(rd),
                                             white_bkgd=white, compute_dtype=BF)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("use_vd", [True, False])
def test_plain_b2_bf16_matches_pallas_gradients(use_vd):
    """Every parameter gradient, dpts and ddirs of fused_train_op((cfg,
    "bfloat16")) (B1 forward, the B2 backward, interpret mode), each to
    1e-2 of its max: the roundings of dz, g and the activations are the
    same, the sums over points in another order."""
    jcfg, jp, tcfg, tp = _models(seed=3, use_viewdirs=use_vd, output_ch=4 if use_vd else 5)
    ro, rd, z = _rays(seed=6)
    pts = (ro[:, None] + rd[:, None] * z[..., None]).astype(np.float32)
    C = 4 if use_vd else 5
    g = np.random.default_rng(7).standard_normal(pts.shape[:-1] + (C,)).astype(np.float32)
    if use_vd:
        _, vjp = jax.vjp(lambda p, x, d: jbwd.fused_train_op((jcfg, "bfloat16"), p, x, d),
                         jp, jnp.asarray(pts), jnp.asarray(rd))
        jg, jdx, jdd = vjp(jnp.asarray(g))
    else:
        _, vjp = jax.vjp(lambda p, x: jbwd.fused_train_op((jcfg, "bfloat16"), p, x, None),
                         jp, jnp.asarray(pts))
        (jg, jdx), jdd = vjp(jnp.asarray(g)), None
    grads, dpts, ddirs = fused_mlp_bwd.fused_mlp_backward(tp, tcfg, _t(pts),
                                                          _t(rd) if use_vd else None, _t(g), BF)
    want = tnerf.params_from_jax(jax.device_get(jg))
    assert set(grads) == set(want)
    for k, w in want.items():
        _close(grads[k], w.numpy())
    _close(dpts, jdx)
    if use_vd:
        _close(ddirs, jdd)
    else:
        assert ddirs is None


def test_b2_bf16_is_not_the_fp32_backward():
    """The bf16 plain version rounds: it leaves the fp32 gradients by more
    than fp32 rounding, and by less than the JAX bar's 2% in norm."""
    _, _, tcfg, tp = _models(seed=3)
    ro, rd, z = _rays(seed=6)
    pts = _t(ro[:, None] + rd[:, None] * z[..., None])
    g = _t(np.random.default_rng(7).standard_normal((16, 24, 4)))
    b16 = fused_mlp_bwd.fused_mlp_backward(tp, tcfg, pts, _t(rd), g, BF)[0]
    b32 = fused_mlp_bwd.fused_mlp_backward(tp, tcfg, pts, _t(rd), g)[0]
    diffs = [float((b16[k] - b32[k]).norm() / b32[k].norm()) for k in b32]
    assert max(diffs) > 1e-4
    assert all(abs(float(b16[k].norm() / b32[k].norm()) - 1) < 2e-2 for k in b32)


# --- B3's and B4's bf16 backward: the JAX remat twin -------------------------------


# the twins' bias gradients are bf16 sums over the points, which XLA
# accumulates in bf16 and PyTorch in fp32: 2.4% apart at 128 points here
# (about one rounding of 2^-9 per level of a pairwise sum of 128 terms,
# 7 levels); every other gradient of the twins agrees to fp32 rounding
TWIN_BIAS_TOL = 4e-2


def _close_twin_grads(w, jgrads):
    want = tnerf.params_from_jax(jax.device_get(jgrads))
    for k, v in want.items():
        _close(w[k].grad, v.numpy(), TWIN_BIAS_TOL if k.endswith(".bias") else TOL)


def test_b3_bf16_backward_is_the_remat_twin():
    """The gradient of B3 in bf16 with respect to the parameters, the rays,
    the depths and the view directions is JAX's custom_vjp backward:
    autograd of apply_nerf in bf16 on o + z·d (bias gradients to
    TWIN_BIAS_TOL)."""
    jcfg, jp, tcfg, tp = _models(seed=4)
    ro, rd, z = _rays(n=8, S=16, seed=8)
    g = np.random.default_rng(9).standard_normal((8, 16, 4)).astype(np.float32)
    _, vjp = jax.vjp(lambda p, o, d, zz, v: jfm.fused_nerf_forward_rays(
        p, jcfg, o, d, zz, v, compute_dtype=jnp.bfloat16),
        jp, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z), jnp.asarray(rd))
    jg, jo, jd, jz, jv = vjp(jnp.asarray(g))
    w = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    ins = [_t(a).requires_grad_(True) for a in (ro, rd, z, rd)]
    raw = fused_mlp.fused_nerf_forward_rays(w, tcfg, *ins, compute_dtype=BF)
    raw.backward(_t(g))
    _close_twin_grads(w, jg)
    for t, jw in zip(ins, (jo, jd, jz, jv)):
        _close(t.grad, jw)


def test_b4_bf16_backward_is_the_remat_twin():
    """B4 in bf16 differentiated through rgb and acc (the training
    composite's outputs): JAX's backward, autograd of apply_nerf in bf16
    and raw2outputs (bias gradients to TWIN_BIAS_TOL)."""
    jcfg, jp, tcfg, tp = _models(seed=5)
    ro, rd, z = _rays(n=8, S=16, seed=10)
    rng = np.random.default_rng(11)
    g_rgb = rng.standard_normal((8, 3)).astype(np.float32)
    g_acc = rng.standard_normal(8).astype(np.float32)

    def jloss(p, o, d):
        rgb, _, acc, _, _ = jfr.fused_render_rays(p, jcfg, o, d, jnp.asarray(z),
                                                  jnp.asarray(rd), white_bkgd=True,
                                                  compute_dtype=jnp.bfloat16)
        return jnp.sum(rgb * g_rgb) + jnp.sum(acc * g_acc)

    jg, jo, jd = jax.grad(jloss, argnums=(0, 1, 2))(jp, jnp.asarray(ro), jnp.asarray(rd))
    w = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    o, d = _t(ro).requires_grad_(True), _t(rd).requires_grad_(True)
    rgb, _, acc, _, _ = fused_render.fused_render_rays(w, tcfg, o, d, _t(z), _t(rd),
                                                       white_bkgd=True, compute_dtype=BF)
    ((rgb * _t(g_rgb)).sum() + (acc * _t(g_acc)).sum()).backward()
    _close_twin_grads(w, jg)
    _close(o.grad, jo)
    _close(d.grad, jd)


# --- the bf16 pack and a transcription of the bf16 tile -----------------------------


def _desc(desc):
    d = desc.numpy()
    G = fused_mlp.MAX_GEMMS
    return d[:16], d[16:16 + 8 * G].reshape(G, 8), d[16 + 8 * G:16 + 8 * G + 12].reshape(3, 4)


def _slices(wbuf, w_off, Kp, Np):
    """A GEMM's [Kp, Np] bf16 weights back out of its 16-row slices
    (fused_mlp.slice_floats(..., bf16=True), slice_index_bf16)."""
    w16 = wbuf.view(torch.bfloat16)
    step = 2 * fused_mlp.slice_floats(Np, True)
    at = fused_mlp.slice_index_bf16(Np).reshape(-1)
    return torch.stack([w16[2 * w_off + s * step + at] for s in range(Kp // 16)]).reshape(
        Kp, Np).float()


def bf16_tile(wbuf, desc, emb):
    """raw [M, OUT] of csrc/mlp_tile_tc.cuh's bf16 tile on the pack, from
    fp32 encoder outputs emb [M, P + V]: each GEMM segment's input rounded
    to bf16 and padded to a multiple of 16, its bf16 weights from the
    slices, products summed in fp32, the fp32 bias added, the ReLU, the
    output rounded to bf16; the narrow heads in fp32 on the pack's rounded
    weights and biases."""
    hdr, gemm, narrow = _desc(desc)
    D, W, P, V, OUT, VD, HS, SLOT, NG = (int(v) for v in hdr[:9])
    e = fused_mlp.bf16_round(emb)
    P16, V16 = (P + 15) // 16 * 16, (V + 15) // 16 * 16
    srcs = {fused_mlp.SRC_PTS: torch.nn.functional.pad(e[:, :P], (0, P16 - P)),
            fused_mlp.SRC_DIRS: torch.nn.functional.pad(e[:, P:], (0, V16 - V))}
    raw = torch.zeros(emb.shape[0], 8)

    def head(row, x, col):
        w_off, b_off, K, N = (int(v) for v in narrow[row])
        raw[:, col:col + N] = (x[:, :K] @ wbuf[w_off:w_off + N * K].view(N, K).t()
                               + wbuf[b_off:b_off + N])

    h = None
    for gi in range(NG):
        w_off, b_off, Np, ns0, src0, ns1, src1, relu = (int(v) for v in gemm[gi])
        Kp = 16 * (ns0 + ns1)
        a = torch.cat([h[:, :16 * ns] if s == fused_mlp.SRC_H else srcs[s]
                       for s, ns in ((src0, ns0), (src1, ns1)) if ns], -1)
        assert a.shape[1] == Kp
        out = a @ _slices(wbuf, w_off, Kp, Np) + wbuf[b_off:b_off + Np]
        h = fused_mlp.bf16_round(out.clamp_min(0.0) if relu else out)
        if gi == D - 1:
            head(0, h, 3) if VD else head(2, h, 0)
    if VD:
        head(1, h, 0)
    return raw[:, :OUT]


@pytest.mark.parametrize("kw", [dict(), dict(use_viewdirs=False, output_ch=5),
                                dict(D=2, W=30, skips=(0,), i_embed=-1),
                                dict(D=8, W=256, skips=(4,), multires=10, multires_views=4)],
                         ids=["d4w64", "no_viewdirs", "identity_w30", "lego"])
def test_bf16_tile_on_the_pack_matches_plain_and_pallas(kw):
    """The bf16 tile's arithmetic walked over pack_network_tc(..., torch.bfloat16)'s
    buffer and descriptor, on the point-major encoder's table, equals the
    plain version of bf16 B1 to fp32 rounding and the Pallas bf16 kernel
    within the tolerance."""
    jcfg, jp, tcfg, tp = _models(seed=6, **kw)
    ro, rd, z = _rays(n=6, S=8, seed=12)
    pts = (ro[:, None] + rd[:, None] * z[..., None]).astype(np.float32)
    vd = rd if tcfg.use_viewdirs else None
    wbuf, desc, HS, SLOT = fused_mlp.pack_network_tc(tp, tcfg, "cpu", torch.bfloat16)
    assert (HS, SLOT) == fused_mlp.tc_strides(tcfg, True)
    emb = tnerf.embed_inputs(tcfg, _t(pts), _t(vd)).reshape(48, -1)
    got = bf16_tile(wbuf, desc, emb).reshape(6, 8, -1)
    plain = fused_mlp.plain_nerf_forward(tp, tcfg, _t(pts), _t(vd), torch.bfloat16)
    torch.testing.assert_close(got, plain, rtol=0,
                               atol=1e-5 * max(1.0, float(plain.abs().max())))
    want = jfm.fused_nerf_forward(jp, jcfg, jnp.asarray(pts),
                                  None if vd is None else jnp.asarray(vd),
                                  compute_dtype=jnp.bfloat16)
    _close(got, want)


def test_bf16_pack_holds_the_rounded_weights_and_zero_padding():
    """Each GEMM's slices hold its weights rounded to bf16, segment by
    segment, padding zero; biases fp32 as they are; the narrow heads'
    weights and biases rounded (JAX's pack_params casts them); the
    descriptor counts 16-row slices; the fp32 pack is unchanged by the
    bf16 one (the same call twice gives the same bytes)."""
    _, _, tcfg, tp = _models(seed=7)
    fp32_before = fused_mlp.pack_network_tc(tp, tcfg, "cpu")[0].clone()
    wbuf, desc, _, SLOT = fused_mlp.pack_network_tc(tp, tcfg, "cpu", torch.bfloat16)
    layout, size = fused_mlp.tc_layout(tcfg, True)
    assert wbuf.numel() == size and wbuf.dtype == torch.float32
    _, gemm, narrow = _desc(desc)
    for gi, (name, segs, N, _) in enumerate(fused_mlp.tc_gemms(tcfg)):
        w_off, b_off, Kp, Np = layout[name]
        blk = _slices(wbuf, w_off, Kp, Np)
        W = tp[name + ".weight"]
        row = col = 0
        for _, k in segs:
            torch.testing.assert_close(blk[row:row + k, :N],
                                       fused_mlp.bf16_round(W[:, col:col + k].t()),
                                       rtol=0, atol=0)
            assert not blk[row + k:row + (k + 15) // 16 * 16].any()
            row, col = row + (k + 15) // 16 * 16, col + k
        assert not blk[:, N:].any()
        assert torch.equal(wbuf[b_off:b_off + N], tp[name + ".bias"])
        assert int(gemm[gi][3] + gemm[gi][5]) == Kp // 16
        assert max(SLOT, fused_mlp.slice_floats(Np, True)) == SLOT
    for row_, name, K, N in fused_mlp.tc_narrow_heads(tcfg):
        w_off, b_off, _, _ = layout[name]
        assert torch.equal(wbuf[w_off:w_off + N * K],
                           fused_mlp.bf16_round(tp[name + ".weight"]).reshape(-1))
        assert torch.equal(wbuf[b_off:b_off + N], fused_mlp.bf16_round(tp[name + ".bias"]))
    assert torch.equal(fused_mlp.pack_network_tc(tp, tcfg, "cpu")[0], fp32_before)


def test_b2_bf16_packs_round_the_weights_and_keep_the_biases():
    """B2's tile kernel reads B1's bf16 pack (GEMM weights rounded, biases
    fp32, the narrow heads rounded) and the bf16 backward pack, whose
    16-row slices hold each input-gradient GEMM's weights rounded to bf16:
    the fp32 weights' bf16 roundings, zero padding."""
    _, _, tcfg, tp = _models(seed=8)
    wbuf, _, _, _ = fused_mlp.pack_network_tc(tp, tcfg, "cpu", BF)
    layout, _ = fused_mlp.tc_layout(tcfg, True)
    for name, _, N, _ in fused_mlp.tc_gemms(tcfg):
        _, b_off, _, _ = layout[name]
        assert torch.equal(wbuf[b_off:b_off + N], tp[name + ".bias"]), name
    t16, _ = fused_mlp_bwd.pack_backward_tc(tp, tcfg, "cpu", BF)
    blayout, _, _ = fused_mlp_bwd.bwd_layout(tcfg, True)
    for (name, col0, N, _, _), (w_off, Kp, Np) in zip(fused_mlp_bwd.bwd_gemms(tcfg), blayout):
        blk = _slices(t16, w_off, Kp, Np)
        w = tp[name + ".weight"][:, col0:col0 + N]
        assert torch.equal(blk[:w.shape[0], :N], fused_mlp.bf16_round(w)), name
        assert not blk[w.shape[0]:].any() and not blk[:, N:].any()


def test_compute_dtype_other_than_fp32_or_bf16_raises():
    _, _, tcfg, tp = _models()
    ro, rd, z = _rays(n=2, S=3)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused_mlp.fused_nerf_forward_rays(tp, tcfg, _t(ro), _t(rd), _t(z), _t(rd),
                                          torch.float16)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        RenderConfig(precision="fp16")


# --- a bf16 training step and a bf16 frame through the CLIs ---------------------------


SMALL = dict(netdepth=4, netdepth_fine=4, netwidth=32, netwidth_fine=32, N_samples=8,
             N_importance=8, multires=4, multires_views=2)


@pytest.fixture(scope="module")
def bf16_cfg(tmp_path_factory):
    """A tiny blender scene, its config, and a JAX checkpoint at step 7."""
    root = str(tmp_path_factory.mktemp("torch_bf16"))
    datadir, logdir = os.path.join(root, "scene"), os.path.join(root, "logs")
    os.makedirs(datadir)
    _write_scene(datadir)
    cfg = _write_config(root, datadir, logdir, expname="bf16", **SMALL)
    jargs = jax_parser().parse_args(["--config", cfg])
    coarse, fine = create_nerf_models(jargs, jax.random.PRNGKey(5))
    jax_save_tar(os.path.join(logdir, "bf16", "000007.tar"),
                 {"coarse": jax.device_get(coarse.params),
                  "fine": jax.device_get(fine.params)}, None, 7)
    return cfg


def test_bf16_frame_through_the_cli_matches_jax(bf16_cfg):
    """render_only --precision bf16 of the checkpoint's test views: the
    port's plain bf16 network on the CPU against the JAX package's, to
    1e-2 (a few bf16 ulps through two passes and an inverse-CDF resample);
    the served engine reads the same flag."""
    argv = ["--config", bf16_cfg, "--render_only", "--render_test", "--chunk", "100",
            "--precision", "bf16"]
    _, want = jax_render_only(jax_parser().parse_args(argv), return_rgbs=True)
    targs = serve_parser().parse_args(argv + ["--device", "cpu"])
    _, got = render_only(targs, return_rgbs=True)
    assert got.shape == want.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    _, fp32 = render_only(serve_parser().parse_args(
        [a for a in argv if a not in ("--precision", "bf16")] + ["--device", "cpu"]),
        return_rgbs=True)
    assert np.abs(got - fp32).max() > 1e-5
    eng = build_eval_engine(targs)
    assert eng.renderer.cfg.precision == "bf16"


def _key_words(key):
    return torch.from_numpy(np.asarray(jax.random.key_data(key)).astype(np.int64))


def test_bf16_training_step_through_the_cli_config_matches_jax(bf16_cfg):
    """One training step with --precision bf16: the render config as the
    port's trainer builds it from the CLI flags (factory.get_renderer, the
    step's kernel flags cleared; on the CPU the plain bf16 network) against
    the JAX trainer's (its get_renderer with the same flags), from the same
    weights (params_from_jax), the sampler's key words and the stratified
    and inverse-CDF draws pinned through the overrides seam: the loss to
    1e-3 relative, every gradient to 1e-2 of its max."""
    flags = ["--config", bf16_cfg, "--precision", "bf16"]
    targs = config_parser().parse_args(flags + ["--device", "cpu"])
    jargs = jax_parser().parse_args(flags)
    bds = {"near": 2.0, "far": 6.0}
    trend = get_renderer(targs, bds, "cpu")
    assert trend.cfg.precision == "bf16"
    tr = dataclasses.replace(trend.cfg, use_pallas=False, fused_composite=False,
                             fused_backward=resolve_fused_backward(targs, "cpu"))
    jr = dataclasses.replace(jax_get_renderer(jargs, bds).cfg, use_pallas=False,
                             fused_backward=False)
    assert jr.precision == "bf16"

    jcfg = jnerf.NeRFConfig(D=4, W=32, skips=(4,), multires=4, multires_views=2, output_ch=5)
    jstate = j_create_state(jax.random.PRNGKey(3), jcfg, jcfg, lrate=5e-4, lrate_decay=250)
    tcfg = tnerf.NeRFConfig(D=4, W=32, skips=(4,), multires=4, multires_views=2, output_ch=5)
    tstate = create_train_state(tcfg, tcfg, "cpu", lrate=5e-4, lrate_decay=250)
    params = jax.device_get(jstate.params)
    with torch.no_grad():
        for branch, m in tstate.branches():
            m.load_state_dict(tnerf.params_from_jax(params[branch]))

    rng = np.random.default_rng(13)
    images = rng.random((3, 8, 8, 3)).astype(np.float32)
    poses = np.stack([np.eye(4)[:3] + 0.05 * rng.standard_normal((3, 4))
                      for _ in range(3)]).astype(np.float32)
    poses[:, 2, 3] += 4.0
    K = np.array([[10.0, 0, 4.0], [0, 10.0, 4.0], [0, 0, 1]])
    jspec = jpipe.PixelSamplerSpec.from_K(8, 8, K, 16, single_image=True)
    tspec = tpipe.PixelSamplerSpec.from_K(8, 8, K, 16, single_image=True)
    S, Ni = tr.N_samples, tr.N_importance
    ov = {"t_rand": rng.random((16, S)).astype(np.float32),
          "u": rng.random((16, Ni)).astype(np.float32)}
    key = jax.random.PRNGKey(21)
    ro, rd, tgt = jpipe.sample_ray_batch(key, jnp.asarray(images), jnp.asarray(poses),
                                         jstate.step, jspec)
    jb = j_pack(ro, rd, jr, 8, 8, float(K[0, 0]))
    jov = {k: jnp.asarray(v) for k, v in ov.items()}

    def jloss(p):
        ret = j_render_rays(p["coarse"], p["fine"], jb, jax.random.PRNGKey(0), jr, jcfg,
                            jcfg, overrides=jov)
        return j_img2mse(ret["rgb_map"], tgt) + j_img2mse(ret["rgb0"], tgt)

    jl, jg = jax.value_and_grad(jloss)(jstate.params)
    k_img, k_y, k_x = jax.random.split(key, 3)
    draws = {"img_idx": int(jax.random.randint(k_img, (), 0, 3)),
             "key_y": _key_words(k_y), "key_x": _key_words(k_x)}
    step = make_train_step(tr, tcfg, tcfg, tspec)
    aux = step(tstate, torch.from_numpy(images), torch.from_numpy(poses),
               torch.Generator().manual_seed(0), draws=draws,
               overrides={k: torch.from_numpy(v) for k, v in ov.items()})
    assert float(aux["loss"]) == pytest.approx(float(jl), rel=1e-3)
    for branch, m in tstate.branches():
        want = tnerf.params_from_jax(jax.device_get(jg[branch]))
        for k, p in m.named_parameters():
            _close(p.grad, want[k].numpy())
