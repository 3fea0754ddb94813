"""The port's pose-estimation app against the JAX package on the CPU: five
steps of ``make_pose_opt_step`` in both parameterisations (the JAX app's
real jitted step at perturb 0, and its arithmetic with pinned stratified
draws at perturb 1), the learning-rate schedule, the kernel route's
dispatch, ``pose_errors``, ``perturbation_matrix`` and ``apply_image_noise``,
the interest region (the dilation exact, the port's own keypoint detector
against OpenCV's SIFT), and ``pose_cli.main`` end to end on checkpoints
written by either package.

Pixel indices come from the JAX step's own key and are handed to the port
through the ``overrides`` seam (``idx``), as are the stratified ``t_rand``
and inverse-CDF ``u`` draws, numpy-seeded, where both sides take them."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_shared_tpu.apps import pose_cli as jcli
from nerf_shared_tpu.apps import pose_estimation as jpe
from nerf_shared_tpu.config import config_parser as jax_parser
from nerf_shared_tpu.factory import get_train_state as j_get_train_state
from nerf_shared_tpu.models import nerf as jnerf
from nerf_shared_tpu.render.renderer import RenderConfig as JRenderConfig
from nerf_shared_tpu.render.renderer import render_rays as j_render_rays
from nerf_shared_tpu.train.step import pack_ray_batch as j_pack
from nerf_shared_tpu.utils import checkpoints as jckpt
from nerf_shared_tpu.utils.metrics import img2mse as j_img2mse
from nerf_shared_tpu_torch.apps import pose_cli as tcli
from nerf_shared_tpu_torch.apps import pose_estimation as tpe
from nerf_shared_tpu_torch.apps import train as tapp
from nerf_shared_tpu_torch.models import nerf as tnerf
from nerf_shared_tpu_torch.render import renderer as trenderer
from nerf_shared_tpu_torch.render.renderer import RenderConfig
from tests.test_e2e import _write_config, _write_scene

KW = dict(D=2, W=32, skips=(4,), use_viewdirs=True, multires=4, multires_views=2,
          output_ch=5)
H = W = 16
B = 32


def _setup(seed=0):
    """Shared frozen networks, an image, interest coordinates, a start
    pose and the intrinsics (a 16x16 camera on a radius-4 ring)."""
    jcfg = jnerf.NeRFConfig(**KW)
    kc, kf = jax.random.split(jax.random.PRNGKey(seed))
    jp = {"coarse": jax.device_get(jnerf.init_nerf_params(kc, jcfg)),
          "fine": jax.device_get(jnerf.init_nerf_params(kf, jcfg))}
    tp = {b: tnerf.params_from_jax(v) for b, v in jp.items()}
    rng = np.random.default_rng(seed)
    image = rng.random((H, W, 3)).astype(np.float32)
    ys, xs = np.mgrid[:H, :W]
    coords = np.stack([xs.ravel(), ys.ravel()], -1)[rng.permutation(H * W)[:150]]
    start = np.eye(4, dtype=np.float32)
    start[:3, 3] = [0.2, -0.1, 4.0]
    pcfg_kw = dict(batch_size=B, lrate=0.01, n_steps=5, H=H, W=W, fx=14.0, fy=14.5,
                   cx=W / 2, cy=H / 2)
    return jcfg, jp, tnerf.NeRFConfig(**KW), tp, image, coords, start, pcfg_kw


def _init(mode):
    """The same near-zero initial pose parameters on both sides."""
    vals = tpe.init_pose_params(torch.Generator().manual_seed(3), mode)
    return ({k: jnp.asarray(v.detach().numpy()) for k, v in vals.items()}, vals)


def _assert_pose_close(jpp, tpp, start, tol=1e-5):
    want = np.asarray(jpe.apply_pose(jpp, jnp.asarray(start)))
    got = tpe.apply_pose(tpp, torch.from_numpy(start)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    for k in jpp:
        np.testing.assert_allclose(tpp[k].detach().numpy(), np.asarray(jpp[k]), rtol=0, atol=tol)


@pytest.mark.parametrize("mode", ["screw", "se3"])
def test_five_pose_steps_match_the_jax_step(mode):
    """The JAX app's own jitted step at perturb 0 (it then draws only its
    pixels, from its key): pose within 1e-5 absolute, loss within 1e-5
    relative, at every one of five steps."""
    jcfg, jp, tcfg, tp, image, coords, start, pkw = _setup()
    rkw = dict(N_samples=8, N_importance=8, near=2.0, far=6.0, perturb=0.0)
    jpcfg, tpcfg = jpe.PoseOptConfig(**pkw), tpe.PoseOptConfig(**pkw)
    tx, jstep = jpe.make_pose_opt_step(JRenderConfig(**rkw), jcfg, jcfg, jpcfg)
    new_opt, tstep = tpe.make_pose_opt_step(RenderConfig(**rkw), tcfg, tcfg, tpcfg)
    jpp, tpp = _init(mode)
    jopt, topt = tx.init(jpp), new_opt(tpp)
    for k in range(5):
        key = jax.random.fold_in(jax.random.PRNGKey(11), k)
        jpp, jopt, jl = jstep(jpp, jopt, jnp.asarray(coords), jnp.asarray(image),
                              jnp.asarray(start), jp, key)
        idx = np.asarray(jax.random.randint(jax.random.split(key)[0], (B,), 0, len(coords)))
        tl = tstep(tpp, topt, torch.from_numpy(coords), torch.from_numpy(image),
                   torch.from_numpy(start), tp, torch.Generator(),
                   overrides={"idx": torch.from_numpy(idx)})
        assert float(tl) == pytest.approx(float(jl), rel=1e-5), k
        _assert_pose_close(jpp, tpp, start)
        assert topt.param_groups[0]["lr"] == pytest.approx(0.01 * 0.8 ** (k / 100), rel=1e-12)


@pytest.mark.parametrize("mode", ["screw", "se3"])
def test_five_stratified_pose_steps_match_jax_with_pinned_draws(mode):
    """perturb 1 (the stratified draw stays on, as in the JAX app): the JAX
    step's arithmetic (apply_pose, _rays_for_pixels, pack_ray_batch,
    render_rays, mse and its optax Adam) with the pixel indices, t_rand and
    u pinned on both sides. Tolerances as above."""
    jcfg, jp, tcfg, tp, image, coords, start, pkw = _setup(seed=1)
    rkw = dict(N_samples=8, N_importance=8, near=2.0, far=6.0, perturb=1.0)
    jr = JRenderConfig(**rkw)
    jpcfg, tpcfg = jpe.PoseOptConfig(**pkw), tpe.PoseOptConfig(**pkw)
    tx, _ = jpe.make_pose_opt_step(jr, jcfg, jcfg, jpcfg)
    new_opt, tstep = tpe.make_pose_opt_step(RenderConfig(**rkw), tcfg, tcfg, tpcfg)
    jpp, tpp = _init(mode)
    jopt, topt = tx.init(jpp), new_opt(tpp)
    rng = np.random.default_rng(5)

    @jax.jit
    def loss_and_grad(pp, xy, ov):
        def loss_fn(pp):
            target = jnp.asarray(image)[xy[:, 1], xy[:, 0]]
            ro, rd = jpe._rays_for_pixels(xy, jpe.apply_pose(pp, jnp.asarray(start)), jpcfg)
            ret = j_render_rays(jp["coarse"], jp["fine"], j_pack(ro, rd, jr, H, W, jpcfg.fx),
                                jax.random.PRNGKey(0), jr, jcfg, jcfg, overrides=ov)
            return j_img2mse(ret["rgb_map"], target)

        return jax.value_and_grad(loss_fn)(pp)

    for k in range(5):
        idx = rng.integers(0, len(coords), B)
        ov = {"t_rand": rng.random((B, 8)).astype(np.float32),
              "u": rng.random((B, 8)).astype(np.float32)}
        jl, g = loss_and_grad(jpp, jnp.asarray(coords[idx]),
                              {k2: jnp.asarray(v) for k2, v in ov.items()})
        updates, jopt = tx.update(g, jopt, jpp)
        jpp = jax.tree_util.tree_map(lambda a, b: a + b, jpp, updates)
        tl = tstep(tpp, topt, torch.from_numpy(coords), torch.from_numpy(image),
                   torch.from_numpy(start), tp, torch.Generator(),
                   overrides={"idx": torch.from_numpy(idx),
                              **{k2: torch.from_numpy(v) for k2, v in ov.items()}})
        assert float(tl) == pytest.approx(float(jl), rel=1e-5), k
        _assert_pose_close(jpp, tpp, start)


def test_pose_step_routes_the_networks_through_the_training_op(monkeypatch):
    """With fused_backward (the card's default route) the pose step sends
    both networks through fused_train_op, never the ray kernel B3 (even
    under use_pallas), and composites through composite_fused (B5 on the
    card); with frozen weights only the points and directions need a
    gradient. Without it (the renderer's config, the JAX app's route) the
    coarse pass goes through B3's wrapper and B5's, the fine one through
    B4's under fused_composite. On the CPU every wrapper is its plain version, so both routes
    give the same loss and pose."""
    jcfg, jp, tcfg, tp, image, coords, start, pkw = _setup(seed=2)
    calls = {"train_op": 0, "rays": 0, "render": 0, "composite": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(trenderer, "fused_train_op",
                        counting("train_op", trenderer.fused_train_op))
    monkeypatch.setattr(trenderer, "fused_nerf_forward_rays",
                        counting("rays", trenderer.fused_nerf_forward_rays))
    monkeypatch.setattr(trenderer, "composite_fused",
                        counting("composite", trenderer.composite_fused))
    monkeypatch.setattr(trenderer, "fused_render_rays",
                        counting("render", trenderer.fused_render_rays))
    frozen = {b: {k: v.detach() for k, v in sd.items()} for b, sd in tp.items()}
    out = {}
    for fused in (True, False):
        rcfg = RenderConfig(N_samples=8, N_importance=8, near=2.0, far=6.0, perturb=0.0,
                            use_pallas=True, fused_composite=True, fused_backward=fused)
        new_opt, step = tpe.make_pose_opt_step(rcfg, tcfg, tcfg, tpe.PoseOptConfig(**pkw))
        pp = _init("screw")[1]
        opt = new_opt(pp)
        for c in calls:
            calls[c] = 0
        loss = step(pp, opt, torch.from_numpy(coords), torch.from_numpy(image),
                    torch.from_numpy(start), frozen, torch.Generator().manual_seed(1))
        out[fused] = (float(loss), {k: v.detach().clone() for k, v in pp.items()})
        want = ({"train_op": 2, "rays": 0, "render": 0, "composite": 2} if fused else
                {"train_op": 0, "rays": 1, "render": 1, "composite": 1})
        assert calls == want, fused
    assert out[True][0] == pytest.approx(out[False][0], rel=1e-6)
    for k in out[True][1]:
        torch.testing.assert_close(out[True][1][k], out[False][1][k], rtol=0, atol=1e-7)


def test_pose_errors_perturbation_and_noise_match_jax():
    """Exact: the same numpy code on the same inputs."""
    rng = np.random.default_rng(4)
    for args in ((0, 0, 0, 0), (3.0, -2.0, 4.0, 0.1), (170.0, 45.0, -80.0, -1.5)):
        np.testing.assert_array_equal(tcli.perturbation_matrix(*args),
                                      jcli.perturbation_matrix(*args))
    for _ in range(5):
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        a, b = np.eye(4), np.eye(4)
        a[:3, :3], b[:3, :3] = q, jcli.perturbation_matrix(10, 170, -20, 0)[:3, :3] @ q
        a[:3, 3], b[:3, 3] = rng.standard_normal(3), rng.standard_normal(3)
        assert tpe.pose_errors(a, b) == jpe.pose_errors(a, b)
    img = (rng.random((12, 10, 3)) * 255).astype(np.uint8)
    for kind in ("None", "gauss", "salt", "pepper", "sp", "poisson"):
        for kw in (dict(), dict(sigma=0.1, amount=0.2, delta_brightness=0.1, seed=3)):
            np.testing.assert_array_equal(tcli.apply_image_noise(img, kind, **kw),
                                          jcli.apply_image_noise(img, kind, **kw))


def test_cli_parser_has_the_jax_pose_flags(monkeypatch):
    """The JAX pose CLI's flags with its defaults; --device cuda by default,
    raising without a card."""
    from nerf_shared_tpu.config import config_parser as jparser
    from nerf_shared_tpu_torch.config import config_parser as tparser

    def flags(p):
        return {a.dest: a.default for a in p._actions}

    jf = flags(jcli.extend_parser_for_pose(jparser()))
    tf = flags(tcli.extend_parser_for_pose(tparser()))
    pose = set(jf) - set(flags(jparser()))
    assert pose and all(tf[k] == jf[k] for k in pose)
    assert tf["device"] == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main([])


# --- the interest region -------------------------------------------------------


def _hard_scene_views():
    from benchmarks import hard_scene

    out = []
    for size, eye in ((100, (0.0, 1.5, 4.0)), (160, (-3.0, 2.0, 2.5)), (200, (2.5, 1.0, 3.0))):
        c2w = hard_scene._look_at(np.array(eye))
        rgb = hard_scene.render_gt(c2w, size, size, 1.1 * size)
        out.append((np.clip(rgb, 0, 1) * 255).astype(np.uint8))
    return out


def test_dilation_of_the_jax_keypoints_equals_jax_exactly():
    """Given OpenCV's keypoints (the JAX find_POI), the port's dilation is
    the JAX interest region bit for bit, at the default and other kernels."""
    pytest.importorskip("cv2")
    for img in _hard_scene_views()[:2]:
        poi = jpe.find_POI(img)
        for dil, k in ((3, 5), (1, 3), (2, 4)):
            want = jpe.interest_region_coords(img, dil, k)
            got = tpe.dilate_points(poi, img.shape[0], img.shape[1], dil, k)
            np.testing.assert_array_equal(got, want)


def test_keypoint_detector_reaches_opencv_sift():
    """The port's DoG detector against cv2's SIFT on renders of
    benchmarks/hard_scene.py's scene: the gray image equal, the
    interest-region masks at IoU >= 0.85 (measured 1.0000, 1.0000, 0.9992
    at 100, 160 and 200 pixels: every OpenCV keypoint found, at most one
    more), and the other strategies as in JAX."""
    cv2 = pytest.importorskip("cv2")
    ious = []
    for img in _hard_scene_views():
        np.testing.assert_array_equal(tpe.rgb_to_gray_u8(img),
                                      cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))
        masks = []
        for mod in (jpe, tpe):
            c = mod.interest_region_coords(img)
            m = np.zeros(img.shape[:2], bool)
            m[c[:, 1], c[:, 0]] = True
            masks.append(m)
        ious.append((masks[0] & masks[1]).sum() / (masks[0] | masks[1]).sum())
        want, got = set(map(tuple, jpe.find_POI(img))), set(map(tuple, tpe.find_POI(img)))
        assert len(want & got) >= 0.9 * len(want)
        np.testing.assert_array_equal(tpe.interest_region_coords(img, sampling_strategy="random"),
                                      jpe.interest_region_coords(img, sampling_strategy="random"))
    assert min(ious) >= 0.85, ious
    flat = np.zeros((16, 16, 3), np.uint8)
    np.testing.assert_array_equal(tpe.interest_region_coords(flat),
                                  jpe.interest_region_coords(flat))
    assert tpe.interest_region_coords(flat).shape == (256, 2)


# --- the CLI end to end -----------------------------------------------------------


def test_pose_cli_recovers_on_checkpoints_from_either_package(tmp_path, capsys):
    """tests/test_pose_cli.py's recipe (the tiny ring scene at 20x20, D2/W32,
    150 steps at lr 5e-3, N_rand 256): the port trains a .tar; the JAX
    package loads it and writes its own .ckpt.npz of the same weights.
    pose_cli.main on each (delta_theta 4, delta_t 0.1, 40 steps, 128 rays):
    finite poses, and the loss and the rotation error fall."""
    root = str(tmp_path)
    datadir, logdir = os.path.join(root, "scene"), os.path.join(root, "logs")
    os.makedirs(datadir)
    _write_scene(datadir, size=20, n_train=5)
    cfg = _write_config(root, datadir, logdir, N_iters=150, i_print=50, i_weights=150,
                        N_rand=256, lrate=5e-3)
    tapp.main(["--config", cfg, "--device", "cpu", "--ckpt_format", "tar"])
    jargs = jax_parser().parse_args(["--config", cfg])
    jstate, start = jckpt.load_checkpoint(j_get_train_state(jargs), jargs)
    assert start == 150
    jckpt.save_checkpoints(logdir, "from_jax", jstate, 150, fmt="native")
    capsys.readouterr()
    pose_argv = ["--device", "cpu", "--batch_size", "128", "--pose_n_steps", "40",
                 "--delta_theta", "4.0", "--delta_t", "0.1"]
    for extra in ([], ["--expname", "from_jax"]):
        pose, history = tcli.main(["--config", cfg] + pose_argv + extra)
        out = capsys.readouterr().out
        assert ("from_jax/000150.ckpt.npz" in out) == bool(extra)
        assert pose.shape == (4, 4) and np.isfinite(pose).all()
        assert history[-1]["loss"] < history[0]["loss"]
        assert history[-1]["rot_error_deg"] < 0.75 * history[0]["rot_error_deg"]
