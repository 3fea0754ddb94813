"""The port's fast render engines on the CPU, against the JAX package:
guided sampling (render/renderer.py), the gated renderer (render/gated.py),
the occupancy grid (render/occupancy.py) and froxels (render/froxels.py),
and the engines behind apps/train.build_eval_engine and apps/serve.py.

Small sizes: D=2, W=32 networks, G <= 16 grids, frames of 16-24 pixels,
perturb 0. Inputs come from numpy seeds; weights cross from JAX through
models/nerf.params_from_jax. Tolerances: render maps within 1e-5 (the two
packages run the same fp32 formulas, summed in other orders); grid bits and
candidate selections exact; grid sigma within 1e-5. Depths placed by the
inverse CDF (z_vals, z_std) within 1e-3: sample_pdf divides by a CDF step
that can be as small as its 1e-5 floor, which turns last-digit differences
of the cumsum into ~1e-4 of depth.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_shared_tpu.apps.train import render_only as jax_render_only
from nerf_shared_tpu.config import config_parser as jax_parser
from nerf_shared_tpu.factory import create_nerf_models
from nerf_shared_tpu.models import nerf as jnerf
from nerf_shared_tpu.render import froxels as JF
from nerf_shared_tpu.render import gated as JG
from nerf_shared_tpu.render import occupancy as JO
from nerf_shared_tpu.render import renderer as JR
from nerf_shared_tpu.utils.checkpoints import save_tar as jax_save_tar
from nerf_shared_tpu_torch.apps import train as tapp
from nerf_shared_tpu_torch.apps.serve import RenderService, serve_parser
from nerf_shared_tpu_torch.factory import get_renderer
from nerf_shared_tpu_torch.models import nerf as tnerf
from nerf_shared_tpu_torch.render import froxels as TF
from nerf_shared_tpu_torch.render import gated as TG
from nerf_shared_tpu_torch.render import occupancy as TO
from nerf_shared_tpu_torch.render import renderer as TR
from tests.test_e2e import _write_config, _write_scene

MAPS = ("rgb_map", "disp_map", "acc_map")
BASE = dict(N_samples=8, N_importance=8, near=2.0, far=6.0, perturb=0.0,
            white_bkgd=True)


def _model(seed=0):
    kw = dict(D=2, W=32, multires=4, multires_views=2, skips=(0,))
    jcfg = jnerf.NeRFConfig(**kw)
    jp = jnerf.init_nerf_params(jax.random.PRNGKey(seed), jcfg)
    return (jp, jcfg), (tnerf.params_from_jax(jax.device_get(jp)),
                        tnerf.NeRFConfig(**kw))


def _rcfgs(**kw):
    cfg = {**BASE, **kw}
    return JR.RenderConfig(**cfg), TR.RenderConfig(**cfg)


def _rays(n, seed=0, origin_scale=0.1):
    rng = np.random.default_rng(seed)
    ro = rng.standard_normal((n, 3)).astype(np.float32) * origin_scale
    rd = rng.standard_normal((n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return np.concatenate([ro, rd, np.full((n, 1), 2, np.float32),
                           np.full((n, 1), 6, np.float32), rd], -1)


def _grids(G=8, p=0.3, lo=-6.0, hi=6.0, seed=8, with_sigma=True):
    """The same random occupancy grid (with a random density) for both
    packages."""
    rng = np.random.default_rng(seed)
    bits = rng.random((G, G, G)) < p
    sigma = (rng.random((G, G, G)) * 3).astype(np.float32) * bits
    lo3, hi3 = np.full(3, lo, np.float32), np.full(3, hi, np.float32)
    j = JO.OccupancyGrid(jnp.asarray(bits), jnp.asarray(lo3), jnp.asarray(hi3),
                         jnp.asarray(sigma) if with_sigma else None)
    t = TO.OccupancyGrid(torch.from_numpy(bits), torch.from_numpy(lo3),
                         torch.from_numpy(hi3),
                         torch.from_numpy(sigma) if with_sigma else None)
    return j, t


def _full(val=True):
    return TO.OccupancyGrid(torch.full((4, 4, 4), val),
                            torch.full((3,), -99.0), torch.full((3,), 99.0))


def _close(got, want, keys=MAPS, tol=1e-5):
    for k in keys:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=tol, atol=tol, err_msg=k)


# --- occupancy grid ------------------------------------------------------


def test_lookup_and_lookup_sigma_match_jax():
    rng = np.random.default_rng(1)
    grid = rng.random((5, 6, 7)) > 0.6
    sigma = rng.random((5, 6, 7)).astype(np.float32)
    lo = np.array([-1.0, 0.0, 2.0], np.float32)
    hi = np.array([1.0, 3.0, 2.5], np.float32)
    pts = rng.uniform(-2, 4, size=(300, 3)).astype(np.float32)
    j = JO.OccupancyGrid(jnp.asarray(grid), jnp.asarray(lo), jnp.asarray(hi),
                         jnp.asarray(sigma))
    t = TO.OccupancyGrid(*(torch.from_numpy(a) for a in (grid, lo, hi, sigma)))
    np.testing.assert_array_equal(TO.lookup(t, torch.from_numpy(pts)).numpy(),
                                  np.asarray(JO.lookup(j, jnp.asarray(pts))))
    np.testing.assert_array_equal(
        TO.lookup_sigma(t, torch.from_numpy(pts)).numpy(),
        np.asarray(JO.lookup_sigma(j, jnp.asarray(pts))))


def test_build_grid_matches_jax_without_jitter():
    """n_jitter 0 probes the cell centers in both packages: equal bits,
    sigma within 1e-5; the B1 seam (use_pallas, plain version on the CPU)
    builds the same grid."""
    (jp, jcfg), (tp, tcfg) = _model()
    jr, tr = _rcfgs()
    lo, hi = np.full(3, -3.0, np.float32), np.full(3, 3.0, np.float32)
    want = JO.build_occupancy_grid(jp, jcfg, jr, jnp.asarray(lo), jnp.asarray(hi),
                                   resolution=16, n_jitter=0,
                                   alpha_threshold=1e-2, block=1024)
    for rcfg in (tr, TR.RenderConfig(**{**BASE, "use_pallas": True})):
        got = TO.build_occupancy_grid(tp, tcfg, rcfg, lo, hi, resolution=16,
                                      n_jitter=0, alpha_threshold=1e-2,
                                      block=1024)
        frac = got.occupied_fraction()
        assert 0.0 < frac < 1.0, frac
        np.testing.assert_array_equal(got.grid.numpy(), np.asarray(want.grid))
        np.testing.assert_allclose(got.sigma.numpy(), np.asarray(want.sigma),
                                   rtol=1e-5, atol=1e-5)


def test_pinned_jitter_and_maintainer():
    """A zero jitter tensor is the center probe; a wrong-shaped one raises.
    The maintainer rebuilds only for a newer step."""
    _, (tp, tcfg) = _model()
    rcfg = TR.RenderConfig(**BASE)
    kw = dict(resolution=8, alpha_threshold=1e-2, block=200)
    center = TO.build_occupancy_grid(tp, tcfg, rcfg, [-3] * 3, [3] * 3,
                                     n_jitter=0, **kw)
    pinned = TO.build_occupancy_grid(tp, tcfg, rcfg, [-3] * 3, [3] * 3,
                                     n_jitter=2, jitter=torch.zeros(2, 512, 3),
                                     **kw)
    np.testing.assert_array_equal(center.grid.numpy(), pinned.grid.numpy())
    np.testing.assert_array_equal(center.sigma.numpy(), pinned.sigma.numpy())
    with pytest.raises(ValueError, match="jitter"):
        TO.build_occupancy_grid(tp, tcfg, rcfg, [-3] * 3, [3] * 3, n_jitter=2,
                                jitter=torch.zeros(1, 512, 3), **kw)
    m = TO.OccupancyMaintainer(rcfg, tcfg, [-3] * 3, [3] * 3, resolution=8)
    a = m.get(tp, 10)
    assert m.get(tp, 10) is a and m.get(tp, 11) is not a


def test_aabb_from_poses_matches_jax():
    rng = np.random.default_rng(4)
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    poses[:, :3, 3] = rng.standard_normal((3, 3)) * 4
    K = np.array([[20.0, 0, 8], [0, 20.0, 8], [0, 0, 1]])
    got = TO.aabb_from_poses(16, 16, K, poses, 2.0, 6.0)
    want = JO.aabb_from_poses(16, 16, K, poses, 2.0, 6.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("select", ["sort", "onehot", "weighted"])
def test_topk_selections_match_jax(select):
    rng = np.random.default_rng(11)
    R, C, K = 40, 24, 8
    z = np.sort(rng.random((R, C)).astype(np.float32) * 4 + 2, -1)
    occ = rng.random((R, C)) < 0.4
    sig = (rng.random((R, C)) * 2).astype(np.float32)
    far = np.full((R, 1), 6.0, np.float32)
    if select == "weighted":
        want = JO._topk_weighted_occupied(*(jnp.asarray(a) for a in (z, sig, occ)),
                                          K, jnp.asarray(far))
        got = TO._topk_weighted_occupied(*(torch.from_numpy(a) for a in (z, sig, occ)),
                                         K, torch.from_numpy(far))
    else:
        want = JO._topk_nearest_occupied(jnp.asarray(z), jnp.asarray(occ), K,
                                         jnp.asarray(far), select)
        got = TO._topk_nearest_occupied(torch.from_numpy(z), torch.from_numpy(occ),
                                        K, torch.from_numpy(far), select)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def test_rank_pack_topk_matches_jax():
    rng = np.random.default_rng(12)
    mask = rng.random((30, 40)) < 0.5
    w = rng.random((30, 40)).astype(np.float32) * (rng.random((30, 40)) < 0.7)
    want = JO.rank_pack_topk(jnp.asarray(mask), jnp.asarray(w), 9)
    got = TO.rank_pack_topk(torch.from_numpy(mask), torch.from_numpy(w), 9)
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))


@pytest.mark.parametrize("gate_rays,n_fine,select", [
    (False, 0, "sort"), (True, 0, "sort"), (False, 4, "weighted"),
    (True, 4, "onehot")])
def test_render_flat_rays_occ_matches_jax(gate_rays, n_fine, select):
    (jp, jcfg), (tp, tcfg) = _model(seed=2)
    jr, tr = _rcfgs()
    jg, tg = _grids()
    rb = _rays(48, seed=7, origin_scale=2.0)
    kw = dict(chunk=16, n_candidates=24, n_keep=12, select=select,
              gate_rays=gate_rays, n_fine=n_fine)
    want = JO.render_flat_rays_occ(jnp.asarray(rb), (jp, jcfg), jg, jr, **kw)
    got = TO.render_flat_rays_occ(torch.from_numpy(rb), (tp, tcfg), tg, tr, **kw)
    np.testing.assert_array_equal(got["n_active"].numpy(),
                                  np.asarray(want["n_active"]))
    _close(got, want)
    if gate_rays:
        assert 0.0 < got["active_ray_fraction"] < 1.0
        assert np.float32(got["active_ray_fraction"]) == want["active_ray_fraction"]


@pytest.mark.parametrize("mode,gate_rays,p", [
    ("grid", False, 0.1), ("grid", True, 0.1), ("froxel", False, 0.1),
    ("froxel", False, 0.0)])
def test_occ_fine_depths_are_the_ones_rendered(mode, gate_rays, p):
    """With n_fine the occupancy renders return the depths their fine pass
    evaluated (``z_vals``): the plain network and raw2outputs at those
    depths, with rays that kept no occupied candidate masked, give back
    their colour and opacity. (An empty grid: every ray is background.)"""
    from nerf_shared_tpu_torch.ops.compositing import raw2outputs
    from nerf_shared_tpu_torch.ops.cuda.fused_mlp import plain_nerf_forward_rays

    _, (tp, tcfg) = _model(seed=4)
    H = W = 24
    K, c2w = _cam(H, W)
    _, tg = _grids(lo=-1.0, hi=1.0, p=p)
    r = TR.Renderer(**BASE)
    n_keep, n_fine = 4, 4
    _, out = r.render_image_occ(H, W, K, c2w, (tp, tcfg), tg, chunk=100,
                                n_candidates=16, n_keep=n_keep, mode=mode, tile=4,
                                gate_rays=gate_rays, n_fine=n_fine)
    z = out["z_vals"].reshape(H * W, -1)
    assert z.shape[1] == n_keep + n_fine and torch.isfinite(z).all()
    assert (z[:, 1:] >= z[:, :-1]).all()
    rays, _ = r._pack_rays(H, W, K, None, torch.from_numpy(c2w))
    ro, rd, vd = rays[:, 0:3], rays[:, 3:6], rays[:, -3:]
    live = (out["n_active"].reshape(-1) > 0)[:, None].expand_as(z)
    assert bool(live.any()) == (p > 0)
    raw = TO._masked_sigma(plain_nerf_forward_rays(tp, tcfg, ro, rd, z, vd), live)
    rgb, _, acc, _, _ = raw2outputs(raw, z, rd, white_bkgd=True)
    np.testing.assert_allclose(rgb.numpy(), out["rgb_map"].reshape(-1, 3).numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(acc.numpy(), out["acc_map"].reshape(-1).numpy(),
                               rtol=0, atol=1e-6)


def test_all_occupied_grid_is_dense_and_empty_grid_is_background():
    _, (tp, tcfg) = _model()
    rb = torch.from_numpy(_rays(20))
    rcfg = TR.RenderConfig(**BASE)
    fast = TO.render_flat_rays_occ(rb, (tp, tcfg), _full(), rcfg, chunk=8,
                                   n_candidates=12, n_keep=12)
    dense = TR.render_rays(tp, None, rb, TR.RenderConfig(
        **{**BASE, "N_samples": 12, "N_importance": 0}), tcfg, None)
    assert (fast["n_active"] == 12).all()
    _close(fast, dense, tol=1e-6)
    empty = TO.render_flat_rays_occ(rb, (tp, tcfg), _full(False), rcfg, chunk=8,
                                    n_candidates=12, n_keep=8)
    assert (empty["n_active"] == 0).all()
    np.testing.assert_allclose(empty["rgb_map"].numpy(), 1.0)
    np.testing.assert_allclose(empty["acc_map"].numpy(), 0.0)


# --- froxels -------------------------------------------------------------


def _cam(H=16, W=16, ndc=False):
    K = np.array([[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1]])
    c2w = np.eye(4, dtype=np.float32)[:3]
    if not ndc:
        c2w[2, 3] = 4.0
    return K, c2w


@pytest.mark.parametrize("ndc", [False, True])
def test_build_froxels_matches_jax(ndc):
    H, W = (18, 22) if ndc else (16, 16)
    K, c2w = _cam(H, W, ndc)
    jg, tg = _grids(lo=-1.05 if ndc else -1.0, hi=1.05 if ndc else 1.0, p=0.1)
    near, far = (0.0, 1.0) if ndc else (2.0, 6.0)
    want = JF.build_froxels(jg, H, W, K, jnp.asarray(c2w), near, far,
                            n_depth=16, tile=4, ndc=ndc)
    got = TF.build_froxels(tg, H, W, K, torch.from_numpy(c2w), near, far,
                           n_depth=16, tile=4, ndc=ndc, n_keep=4)
    assert 0 < int(got.bits.sum()) < got.bits.numel()
    np.testing.assert_array_equal(got.bits.numpy(), np.asarray(want.bits))
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("skip_empty,ndc,n_fine,with_sigma", [
    (True, False, 0, True), (False, False, 0, False), (True, True, 0, True),
    (True, False, 4, False)])
def test_render_image_froxels_matches_jax(skip_empty, ndc, n_fine, with_sigma):
    (jp, jcfg), (tp, tcfg) = _model(seed=3)
    H, W = (18, 22) if ndc else (24, 24)
    K, c2w = _cam(H, W, ndc)
    rc = dict(ndc=True, near=0.0, far=1.0) if ndc else {}
    jr, tr = _rcfgs(**rc)
    jg, tg = _grids(lo=-1.05 if ndc else -1.0, hi=1.05 if ndc else 1.0, p=0.1,
                    with_sigma=with_sigma)
    kw = dict(n_depth=16, n_keep=4, tile=4, chunk=100, skip_empty=skip_empty,
              n_fine=n_fine)
    want = JF.render_image_froxels((jp, jcfg), jg, jr, H, W, K,
                                   jnp.asarray(c2w), **kw)
    got = TF.render_image_froxels((tp, tcfg), tg, tr, H, W, K,
                                  torch.from_numpy(c2w), **kw)
    assert got["rgb_map"].shape == (H, W, 3)
    np.testing.assert_array_equal(got["n_active"].numpy(),
                                  np.asarray(want["n_active"]))
    _close(got, want)


def test_froxel_identities():
    """All-occupied with K == C is the dense coarse render; an empty grid
    renders the background; skipping empty tiles changes nothing."""
    _, (tp, tcfg) = _model()
    rcfg = TR.RenderConfig(**BASE)
    H = W = 16
    K, c2w = _cam(H, W)
    out = TF.render_image_froxels((tp, tcfg), _full(), rcfg, H, W, K,
                                  torch.from_numpy(c2w), n_depth=12, n_keep=12,
                                  tile=4, dilate=0)
    r = TR.Renderer(**{**BASE, "N_samples": 12, "N_importance": 0})
    rays, _ = r._pack_rays(H, W, K, None, torch.from_numpy(c2w))
    dense = TR.render_rays(tp, None, rays, r.cfg, tcfg, None)
    assert (out["n_active"] == 12).all()
    _close({k: out[k].reshape(dense[k].shape) for k in MAPS}, dense)
    empty = TF.render_image_froxels((tp, tcfg), _full(False), rcfg, H, W, K,
                                    torch.from_numpy(c2w), n_depth=8, n_keep=4,
                                    tile=4, dilate=0)
    np.testing.assert_allclose(empty["rgb_map"].numpy(), 1.0)
    _, tg = _grids(lo=-1.0, hi=1.0, p=0.05)
    a, b = (TF.render_image_froxels((tp, tcfg), tg, rcfg, 32, 32, *_cam(32, 32),
                                    n_depth=16, n_keep=4, tile=4, skip_empty=s)
            for s in (False, True))
    for k in (*MAPS, "n_active"):
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(), err_msg=k)


def test_froxel_preset_validator_is_shared():
    """The degenerate presets (n_keep * 8 < n_depth) raise in the validator,
    in build_froxels and in render_image_froxels."""
    TF.check_froxel_preset(128, 16)
    with pytest.raises(ValueError, match="degenerate"):
        TF.check_froxel_preset(128, 8)
    _, (tp, tcfg) = _model()
    K, c2w = _cam()
    with pytest.raises(ValueError, match="degenerate"):
        TF.build_froxels(_full(), 16, 16, K, torch.from_numpy(c2w), 2.0, 6.0,
                         n_depth=64, n_keep=4)
    with pytest.raises(ValueError, match="degenerate"):
        TF.render_image_froxels((tp, tcfg), _full(), TR.RenderConfig(**BASE),
                                16, 16, K, torch.from_numpy(c2w), n_depth=64,
                                n_keep=4)


# --- gated and guided ----------------------------------------------------


def test_render_flat_rays_gated_matches_jax():
    (jpc, jcfg), (tpc, tcfg) = _model(seed=0)
    (jpf, _), (tpf, _) = _model(seed=1)
    jr, tr = _rcfgs()
    rb = _rays(40, seed=5, origin_scale=2.0)
    acc0 = TR.render_rays(tpc, tpf, torch.from_numpy(rb), tr, tcfg, tcfg)["acc0"]
    threshold = float(acc0.median())
    want = JG.render_flat_rays_gated(jnp.asarray(rb), (jpc, jcfg), (jpf, jcfg),
                                     jr, jcfg, jcfg, chunk=16, threshold=threshold)
    got = TG.render_flat_rays_gated(torch.from_numpy(rb), (tpc, tcfg), (tpf, tcfg),
                                    tr, tcfg, tcfg, chunk=16, threshold=threshold)
    assert 0.0 < got["active_fraction"] < 1.0
    assert np.float32(got["active_fraction"]) == want["active_fraction"]
    _close(got, want, keys=(*MAPS, "rgb0", "acc0"))
    _close(got, want, keys=("z_std",), tol=1e-3)


def test_gate_zero_is_dense():
    _, (tpc, tcfg) = _model(seed=0)
    _, (tpf, _) = _model(seed=1)
    rcfg = TR.RenderConfig(**BASE)
    rb = torch.from_numpy(_rays(24, seed=6))
    gated = TG.render_flat_rays_gated(rb, (tpc, tcfg), (tpf, tcfg), rcfg, tcfg,
                                      tcfg, chunk=8, threshold=0.0)
    dense = TR.render_rays(tpc, tpf, rb, rcfg, tcfg, tcfg)
    assert gated["active_fraction"] == 1.0
    _close(gated, dense, keys=(*MAPS, "z_std"), tol=1e-6)


def test_guided_branch_matches_jax():
    (jpc, jcfg), (tpc, tcfg) = _model(seed=0)
    (jpf, _), (tpf, _) = _model(seed=1)
    jr, tr = _rcfgs(guided=16)
    rb = _rays(32)
    want = JR.render_rays(jpc, jpf, jnp.asarray(rb), jax.random.PRNGKey(0), jr,
                          jcfg, jcfg, retweights=True)
    got = TR.render_rays(tpc, tpf, torch.from_numpy(rb), tr, tcfg, tcfg,
                         retweights=True)
    assert got["z_vals"].shape == (32, 16)
    _close(got, want, keys=(*MAPS, "rgb0", "weights"))
    _close(got, want, keys=("z_vals", "z_std"), tol=1e-3)


def test_guided_needs_the_hierarchy():
    with pytest.raises(ValueError, match="N_importance"):
        TR.RenderConfig(**{**BASE, "N_importance": 0, "guided": 8})
    args = serve_parser().parse_args(["--N_importance", "0",
                                      "--render_guided", "8"])
    with pytest.raises(ValueError, match="N_importance"):
        get_renderer(args, {"near": 2.0, "far": 6.0}, "cpu")


# --- the kernel seams ----------------------------------------------------


def test_apply_model_takes_b1_under_use_pallas(monkeypatch):
    """_apply_model sends points through fused_nerf_forward (kernel B1)
    under use_pallas, including the grid probe's one ray of block points
    with a single view direction."""
    _, (tp, tcfg) = _model()
    calls = []
    real = TR.fused_nerf_forward

    def spy(params, cfg, pts, viewdirs, *rest):
        calls.append((tuple(pts.shape), tuple(viewdirs.shape)))
        return real(params, cfg, pts, viewdirs, *rest)

    monkeypatch.setattr(TR, "fused_nerf_forward", spy)
    pts = torch.from_numpy(np.random.default_rng(0).uniform(
        -3, 3, (1, 4096, 3)).astype(np.float32))
    dirs = torch.full((1, 3), 3 ** -0.5)
    on = TR.RenderConfig(**{**BASE, "use_pallas": True})
    raw = TR._apply_model(tp, tcfg, pts, dirs, on)
    torch.testing.assert_close(raw, tnerf.apply_nerf(tp, tcfg, pts, dirs),
                               rtol=0, atol=0)
    assert calls == [((1, 4096, 3), (1, 3))]
    TR._apply_model(tp, tcfg, pts, dirs, TR.RenderConfig(**BASE))
    assert len(calls) == 1
    TO.build_occupancy_grid(tp, tcfg, on, [-3] * 3, [3] * 3, resolution=16,
                            n_jitter=2, block=1024)
    assert calls[1:] == [((1, 1024, 3), (1, 3))] * 8


def test_every_render_path_composites_through_the_seam(monkeypatch):
    """Under use_pallas each composite of the dense, guided, gated,
    occupancy and froxel paths goes through composite_fused (kernel B5);
    with sigma noise the dense path takes raw2outputs."""
    _, (tp, tcfg) = _model()
    calls = []
    real = TR.composite_fused

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(TR, "composite_fused", spy)
    on = TR.RenderConfig(**{**BASE, "use_pallas": True})
    rb = torch.from_numpy(_rays(20, origin_scale=2.0))
    TR.render_rays(tp, tp, rb, on, tcfg, tcfg)
    assert len(calls) == 2
    TR.render_rays(tp, tp, rb, TR.RenderConfig(**{**BASE, "use_pallas": True,
                                                  "guided": 4}), tcfg, tcfg)
    assert [c[1] for c in calls[2:]] == [8, 4]
    TG.render_flat_rays_gated(rb, (tp, tcfg), (tp, tcfg), on, tcfg, tcfg,
                              chunk=8, threshold=0.0)
    assert len(calls) == 4 + 3 + 3
    del calls[:]
    _, tg = _grids()
    TO.render_flat_rays_occ(rb, (tp, tcfg), tg, on, chunk=8, n_candidates=12,
                            n_keep=6, n_fine=4)
    assert [c[1] for c in calls] == [6, 10] * 3
    del calls[:]
    TF.render_image_froxels((tp, tcfg), _full(), on, 8, 8, *_cam(8, 8),
                            n_depth=8, n_keep=4, tile=4, chunk=64)
    assert [c[1] for c in calls] == [4]
    del calls[:]
    TR.render_rays(tp, tp, rb, TR.RenderConfig(**{**BASE, "use_pallas": True,
                                                  "raw_noise_std": 1.0}),
                   tcfg, tcfg, generator=torch.Generator().manual_seed(0))
    assert calls == []


# --- the engines behind render_only and the service ----------------------


@pytest.fixture(scope="module")
def scene_cfg(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_fast"))
    datadir, logdir = os.path.join(root, "scene"), os.path.join(root, "logs")
    os.makedirs(datadir)
    _write_scene(datadir)
    cfg = _write_config(root, datadir, logdir, expname="fast")
    jargs = jax_parser().parse_args(["--config", cfg])
    coarse, fine = create_nerf_models(jargs, jax.random.PRNGKey(3))
    jax_save_tar(os.path.join(logdir, "fast", "000005.tar"),
                 {"coarse": jax.device_get(coarse.params),
                  "fine": jax.device_get(fine.params)}, None, 5)
    return cfg


@pytest.mark.parametrize("flags,engine", [
    ([], "dense"),
    (["--render_guided", "8"], "dense"),
    (["--render_gate", "1e-3"], "gated"),
    (["--occ_grid", "16", "--occ_candidates", "8", "--occ_keep", "8",
      "--occ_fine", "4"], "occ-froxel"),
    (["--occ_grid", "16", "--occ_candidates", "8", "--occ_keep", "8",
      "--occ_mode", "grid", "--occ_select", "weighted"], "occ-grid"),
])
def test_engines_serve_frames(scene_cfg, flags, engine):
    args = serve_parser().parse_args(["--config", scene_cfg, "--device", "cpu",
                                      "--chunk", "128"] + flags)
    service = RenderService(args)
    info = service.info()
    assert info["engine"] == engine
    assert info["occ_fine"] == (4 if "--occ_fine" in flags else 0)
    assert (service.engine.occ_grid is not None) == engine.startswith("occ")
    rgb = service.render_spherical(30.0, -20.0, 4.0)
    assert rgb.shape == (16, 16, 3) and np.isfinite(rgb).all()


@pytest.mark.parametrize("flags", [["--render_gate", "0.05"],
                                   ["--render_guided", "8"]])
def test_gated_and_guided_render_only_match_jax(scene_cfg, flags):
    argv = ["--config", scene_cfg, "--render_only", "--render_test",
            "--chunk", "100"] + flags
    _, want = jax_render_only(jax_parser().parse_args(argv), return_rgbs=True)
    _, got = tapp.render_only(serve_parser().parse_args(argv + ["--device", "cpu"]),
                              return_rgbs=True)
    assert got.shape == want.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_trainer_hooks_render_through_a_maintained_grid(scene_cfg, monkeypatch):
    """With --occ_grid the i_img hook renders through a grid the
    OccupancyMaintainer rebuilds from the current fine network."""
    steps = []
    real = TO.OccupancyMaintainer.get

    def spy(self, params, step):
        steps.append(step)
        return real(self, params, step)

    monkeypatch.setattr(TO.OccupancyMaintainer, "get", spy)
    args = serve_parser().parse_args([
        "--config", scene_cfg, "--device", "cpu", "--expname", "fast_occ",
        "--N_iters", "4", "--i_img", "2", "--i_weights", "0", "--i_print", "0",
        "--occ_grid", "8", "--occ_candidates", "8", "--occ_keep", "8"])
    state = tapp.train(args)
    assert state.step == 4 and steps == [2, 4]
    assert args.render_gate == 0.0 and tapp._grid_select(args) == "sort"
