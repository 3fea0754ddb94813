"""mip-NeRF in the port (``--model_type mipnerf``) against the plain
reference ``tests/plain/mipnerf.py``, written from the published
description: the frustum Gaussians, the integrated positional encoding
(the plain one and the kernels' column table), the resampled edges, the
interval composite, and one training step's loss, gradients and parameter
change on seeded weights, at 2-4 rays x 8 intervals and a 3x32 MLP.

The tests marked ``card`` skip without an NVIDIA card; where there is one
they run with ``python -m pytest --noconftest -m card
tests/test_torch_mipnerf.py`` (this file imports no JAX): kernels B1 and
B2 with their IPE encoder against the plain network, and a full-size step
under ``set_sync_debug_mode("error")``.
"""

import dataclasses
import filecmp
import importlib.util
import math
import os

import numpy as np
import pytest
import torch

from nerf_shared_tpu_torch.config import config_parser
from nerf_shared_tpu_torch.factory import (
    coarse_loss_weight,
    get_renderer,
    get_train_state,
    nerf_configs,
)
from nerf_shared_tpu_torch.models.nerf import MipNeRFConfig, apply_mlp, embed_inputs
from nerf_shared_tpu_torch.ops import mip
from nerf_shared_tpu_torch.ops.compositing import composite_intervals
from nerf_shared_tpu_torch.ops.cuda.fused_mlp import encoder_tables
from nerf_shared_tpu_torch.ops.rays import cone_radii, frame_radii, get_rays
from nerf_shared_tpu_torch.ops.sampling import resample_intervals
from nerf_shared_tpu_torch.train.pipeline import PixelSamplerSpec
from nerf_shared_tpu_torch.train.state import MipSchedule
from nerf_shared_tpu_torch.train.step import make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_plain():
    spec = importlib.util.spec_from_file_location(
        "plain_mipnerf", os.path.join(ROOT, "tests", "plain", "mipnerf.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load_plain()
H = W = 12
K = [[14.0, 0.0, 6.0], [0.0, 14.0, 6.0], [0.0, 0.0, 1.0]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _args(*extra, depth=3, width=32, n=8, rays=4):
    return config_parser().parse_args(
        ["--model_type", "mipnerf", "--dataset_type", "blender", "--use_viewdirs",
         "--white_bkgd", "--no_batching", "--netdepth", str(depth), "--netwidth", str(width),
         "--N_samples", str(n), "--N_importance", str(n), "--N_rand", str(rays),
         "--device", "cpu", "--no_reload", *extra])


def _net(args) -> dict:
    """The reference's sizes and recipe: the flags' depth, width and rate,
    the rest the program's constants."""
    c, s = MipNeRFConfig, MipSchedule
    return {"depth": args.netdepth, "width": args.netwidth,
            "min_deg_point": c.min_deg_point, "max_deg_point": c.multires,
            "deg_view": c.multires_views, "density_bias": c.density_bias,
            "rgb_padding": c.rgb_padding, "resample_padding": c.resample_padding,
            "coarse_loss_mult": c.coarse_loss_mult, "lr_init": args.lrate,
            "lr_final": s.lr_final, "max_steps": s.max_steps,
            "lr_delay_steps": s.delay_steps, "lr_delay_mult": s.delay_mult}


def _rays(n, seed):
    g = torch.Generator().manual_seed(seed)
    o = torch.randn(n, 3, generator=g)
    d = torch.randn(n, 3, generator=g)
    t = torch.sort(2.0 + 4.0 * torch.rand(n, 9, generator=g), dim=-1).values
    radii = 0.01 + 0.02 * torch.rand(n, 1, generator=g)
    return o, d, t, radii


def _seeded_params(net, seed):
    """Leaves in the reference's layout, He-uniform, biases small."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in ref.param_shapes(net).items():
        fan_in = shape[0] if name.endswith(".kernel") else 1
        bound = math.sqrt(6.0 / fan_in) if name.endswith(".kernel") else 0.1
        out[name] = (torch.rand(shape, generator=g) * 2 - 1) * bound
    return out


def test_frustum_gaussians_are_the_references():
    o, d, t, radii = _rays(4, 0)
    want_mean, want_cov = ref.cast_rays(t, o, d, radii)
    got = mip.cast_rays(t, o, d, radii)
    assert got.shape == (4, 8, 6)
    torch.testing.assert_close(got[..., :3], want_mean, rtol=0, atol=0)
    torch.testing.assert_close(got[..., 3:], want_cov, rtol=0, atol=0)


def test_ipe_is_the_references_in_the_programs_column_order():
    args = _args()
    net = _net(args)
    o, d, t, radii = _rays(3, 1)
    gauss = mip.cast_rays(t, o, d, radii)
    want = ref.integrated_pos_enc(gauss[..., :3], gauss[..., 3:], 0, 16)
    got = mip.ipe(gauss[..., :3], gauss[..., 3:], 0, 16)
    assert got.shape[-1] == 96
    torch.testing.assert_close(got[..., ref.point_columns(net)], want, rtol=0, atol=0)
    vd = torch.nn.functional.normalize(d, dim=-1)
    ccfg, _ = nerf_configs(args)
    emb = embed_inputs(ccfg, gauss, vd)
    views = ref.pos_enc(vd, 0, 4, True)
    torch.testing.assert_close(emb[:, 0, 96:][:, ref.view_columns(net)], views, rtol=0, atol=0)


def test_ipe_encoder_table_forms_the_plain_columns():
    """The kernels' IpeEnc column by column from ``encoder_tables``: input
    0-2 the mean (its variance at +3), 6-8 the direction; kinds 0-4."""
    ccfg, _ = nerf_configs(_args())
    src, scale, kind = encoder_tables(ccfg)
    assert len(src) == ccfg.input_ch + ccfg.input_ch_views == 96 + 27
    o, d, t, radii = _rays(2, 2)
    gauss = mip.cast_rays(t, o, d, radii)
    vd = torch.nn.functional.normalize(d, dim=-1)
    rec = torch.cat([gauss, vd[:, None, :].expand(2, 8, 3)], dim=-1)
    cols = []
    for i, f, k in zip(src, scale, kind):
        x = rec[..., int(i)]
        if k == 0:
            cols.append(x)
            continue
        arg = x * torch.tensor(f, dtype=torch.float32)
        s = torch.sin(arg) if k in (1, 3) else torch.cos(arg)
        if k >= 3:
            s = s * torch.exp(-0.5 * (rec[..., int(i) + 3] * torch.tensor(f * f)))
        cols.append(s)
    assert set(kind[:96].tolist()) == {3, 4} and set(kind[96:].tolist()) == {0, 1, 2}
    torch.testing.assert_close(torch.stack(cols, -1), embed_inputs(ccfg, gauss, vd),
                               rtol=0, atol=0)


@pytest.mark.parametrize("det", [False, True])
def test_resampled_edges_are_the_references(det):
    _, _, t, _ = _rays(4, 3)
    g = torch.Generator().manual_seed(4)
    w = torch.rand(4, 8, generator=g)
    w[0] = 0.0   # an empty ray: the 1e-5 padding
    w[1, 3] = 5.0
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    got = resample_intervals(t, w, 0.01, det=det, generator=g1)
    want = ref.resample_edges(t, w, 0.01, not det, g2)
    assert got.shape == t.shape and bool((got[:, 1:] >= got[:, :-1]).all())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_interval_composite_is_the_references():
    o, d, t, _ = _rays(4, 6)
    g = torch.Generator().manual_seed(7)
    raw = torch.randn(4, 8, 4, generator=g) * 2
    rgb, disp, acc, weights, depth = composite_intervals(raw, t, d, -1.0, 0.001, True)
    rgb_a = torch.sigmoid(raw[..., :3]) * 1.002 - 0.001
    dens = torch.nn.functional.softplus(raw[..., 3:] - 1.0)
    want_rgb, want_w = ref.volumetric_rendering(rgb_a, dens, t, d, True)
    torch.testing.assert_close(rgb, want_rgb, rtol=0, atol=0)
    torch.testing.assert_close(weights, want_w, rtol=0, atol=0)
    assert bool((depth >= t[:, 0]).all() and (depth <= t[:, -1]).all())
    torch.testing.assert_close(disp, 1.0 / depth)


def test_weight_mapping_round_trips_and_keeps_the_network():
    args = _args(depth=6, width=16)
    net = _net(args)
    ccfg, _ = nerf_configs(args)
    p = _seeded_params(net, 8)
    state = ref.to_program(p, net)
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in get_train_state(args, "cpu").coarse.params().items()}
    back = ref.from_program(state, net)
    for k in p:
        assert torch.equal(back[k], p[k])
    o, d, t, radii = _rays(3, 9)
    gauss = mip.cast_rays(t, o, d, radii)
    vd = torch.nn.functional.normalize(d, dim=-1)
    rgb, dens = ref.mlp(p, net, ref.integrated_pos_enc(gauss[..., :3], gauss[..., 3:], 0, 16),
                        ref.pos_enc(vd, 0, 4, True)[:, None, :].expand(3, 8, 27))
    raw = apply_mlp(state, ccfg, embed_inputs(ccfg, gauss, vd))
    torch.testing.assert_close(raw, torch.cat([rgb, dens], -1), rtol=1e-5, atol=1e-5)


def _scene(args):
    g = torch.Generator().manual_seed(11)
    images = torch.rand(3, H, W, 3, generator=g)
    poses = torch.eye(4)[:3].repeat(3, 1, 1)
    poses[:, :, 3] = torch.tensor([0.0, 0.0, 4.0]) + 0.2 * torch.randn(3, 3, generator=g)
    scene = {"H": H, "W": W, "K": K, "near": 2.0, "far": 6.0, "N_samples": args.N_samples,
             "N_importance": args.N_importance, "N_rand": args.N_rand, "white_bkgd": True}
    return images, poses, scene


def _program_steps(args, p, net, images, poses, n_steps, coarse_weight=None):
    ccfg, fcfg = nerf_configs(args)
    state = get_train_state(args, "cpu", cfgs=(ccfg, fcfg))
    with torch.no_grad():
        for k, v in ref.to_program(p, net).items():
            state.coarse.params()[k].copy_(v)
    rcfg = dataclasses.replace(get_renderer(args, {"near": 2.0, "far": 6.0}, "cpu").cfg,
                               use_pallas=False, fused_backward=False)
    spec = PixelSamplerSpec.from_K(H, W, K, args.N_rand, single_image=True)
    cw = coarse_loss_weight(args) if coarse_weight is None else coarse_weight
    step = make_train_step(rcfg, ccfg, fcfg, spec, coarse_weight=cw)
    losses, first = [], None
    for i in range(1, n_steps + 1):
        gen = torch.Generator().manual_seed((7 << 32) + i)
        losses.append(float(step(state, images, poses, gen)["loss"]))
        if first is None:
            st = state.optimizer.state
            first = {k: st[v]["exp_avg"] / 0.1 for (_, k), v in state.named_parameters().items()}
    return state, losses, first


def test_one_step_matches_the_reference():
    args = _args()
    net = _net(args)
    images, poses, scene = _scene(args)
    p0 = _seeded_params(net, 12)
    state, losses, grads = _program_steps(args, p0, net, images, poses, 2)
    assert state.fine is None
    params = {k: v.clone() for k, v in p0.items()}
    gens = [torch.Generator().manual_seed((7 << 32) + i) for i in (1, 2)]
    out = ref.train_steps(params, net, scene, images, poses, gens)
    np.testing.assert_allclose(losses, out["loss"], rtol=1e-5)
    want_g = ref.to_program(out["grad"], net)
    for k, g in grads.items():
        torch.testing.assert_close(g, want_g[k], rtol=1e-4, atol=1e-7)
    moved = ref.to_program(params, net)
    start = ref.to_program(p0, net)
    for k, v in state.coarse.params().items():
        change, want = v.detach() - start[k], moved[k] - start[k]
        assert float(torch.linalg.vector_norm(want)) > 0
        torch.testing.assert_close(change, want, rtol=1e-3, atol=1e-9)


def test_both_passes_train_the_one_network():
    """The coarse and the fine pass each reach every leaf of the one
    network: the first gradient moves with the coarse MSE's weight, and
    without it (weight 0) the fine pass alone still reaches every leaf."""
    args = _args()
    net = _net(args)
    images, poses, _ = _scene(args)
    p0 = _seeded_params(net, 13)
    state, _, g01 = _program_steps(args, p0, net, images, poses, 1)
    assert [b for b, _ in state.branches()] == ["coarse"]
    _, _, g0 = _program_steps(args, p0, net, images, poses, 1, coarse_weight=0.0)
    _, _, g1 = _program_steps(args, p0, net, images, poses, 1, coarse_weight=1.0)
    for k in g01:
        assert float(g0[k].abs().sum()) > 0
        coarse = g1[k] - g0[k]
        assert float(coarse.abs().sum()) > 0
        torch.testing.assert_close(g01[k], g0[k] + 0.1 * coarse, rtol=1e-4, atol=1e-7)


def test_cone_radii_are_a_pixels_spacing():
    c2w = torch.eye(4)[:3]
    _, rays_d = get_rays(H, W, K, c2w)
    radii = frame_radii(rays_d)
    assert radii.shape == (H, W, 1)
    torch.testing.assert_close(radii, torch.full_like(radii, 2 / math.sqrt(12) / 14.0))
    torch.testing.assert_close(cone_radii(rays_d[:-1], rays_d[1:]), radii[:-1])


def test_plain_reference_and_its_benchmark_copy_are_identical():
    assert filecmp.cmp(os.path.join(ROOT, "tests", "plain", "mipnerf.py"),
                       os.path.join(ROOT, "portbench", "reference", "mipnerf.py"),
                       shallow=False)


def test_plain_reference_imports_nothing_of_either_package():
    import ast

    tree = ast.parse(open(os.path.join(ROOT, "tests", "plain", "mipnerf.py")).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "math", "typing", "torch"}


@pytest.mark.parametrize("flag", [["--precision", "bf16"], ["--refine_poses", "True"],
                                  ["--fused_composite", "True"], ["--occ_grid", "16"],
                                  ["--N_importance", "4"], ["--appearance", "True"]])
def test_unsupported_flags_raise(flag):
    """Each raises before a step: the flags the render config cannot see in
    ``nerf_configs``, the rest in the renderer a card would build."""
    args = _args(*flag)
    with pytest.raises((SystemExit, ValueError), match="mipnerf"):
        nerf_configs(args)
        get_renderer(args, {"near": 2.0, "far": 6.0}, "cuda")


def test_ray_kernels_decline_ipe():
    from nerf_shared_tpu_torch.ops.cuda.fused_mlp import fused_nerf_forward_rays
    from nerf_shared_tpu_torch.ops.cuda.fused_render import fused_render_rays

    args = _args()
    ccfg, _ = nerf_configs(args)
    params = get_train_state(args, "cpu").coarse.params()
    o, d, t, _ = _rays(2, 14)
    for fn, name in ((fused_nerf_forward_rays, "B3"), (fused_render_rays, "B4")):
        with pytest.raises(ValueError, match=f"kernel {name}.*B1"):
            fn(params, ccfg, o, d, t, d)


def _write_scene(root, size=16):
    """A tiny blender scene: a red disc on transparent black, 4 train, 1
    val and 2 test views on a ring."""
    import json

    from nerf_shared_tpu_torch.data.images import imwrite_u8

    for split, n in (("train", 4), ("val", 1), ("test", 2)):
        frames = []
        os.makedirs(os.path.join(root, split), exist_ok=True)
        for i in range(n):
            yy, xx = np.mgrid[:size, :size]
            blob = ((yy - size / 2) ** 2 + (xx - size / 2) ** 2) < (size / 3) ** 2
            img = np.zeros((size, size, 4), np.uint8)
            img[..., 0], img[..., 3] = blob * 200, blob * 255
            rel = f"{split}/r_{i}"
            imwrite_u8(os.path.join(root, rel + ".png"), img)
            pose = np.eye(4)
            pose[0, 3], pose[2, 3] = 4 * np.sin(2 * np.pi * i / n), 4 * np.cos(2 * np.pi * i / n)
            frames.append({"file_path": rel, "transform_matrix": pose.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.8, "near": 2.0, "far": 6.0, "frames": frames}, f)


def test_entry_points_train_resume_render_and_serve(tmp_path):
    """``--model_type mipnerf`` through the port's entry points on the CPU:
    apps/train.py trains and saves, resumes, renders with render_only, and
    the service's engine renders a pose."""
    from nerf_shared_tpu_torch.apps import train as app
    from nerf_shared_tpu_torch.apps.serve import RenderService, serve_parser

    _write_scene(tmp_path / "scene")
    cfg = dict(expname="mip", basedir=tmp_path / "logs", datadir=tmp_path / "scene",
               dataset_type="blender", model_type="mipnerf", training=True,
               no_batching=True, use_viewdirs=True, white_bkgd=True, N_samples=8,
               N_importance=8, N_rand=64, netdepth=3, netwidth=32, lrate=5e-3,
               testskip=1, N_iters=8, i_print=4, i_weights=8, i_testset=0,
               i_img=0, i_video=0, chunk=256)
    path = tmp_path / "mip.txt"
    path.write_text("".join(f"{k} = {v}\n" for k, v in cfg.items()))
    base = ["--config", str(path), "--device", "cpu"]
    app.main(base)
    state = app.main(base + ["--N_iters", "10"])
    assert state.step == 10 and state.fine is None
    _, rgbs = app.render_only(app.config_parser().parse_args(
        base + ["--render_only", "--render_test"]), return_rgbs=True)
    assert rgbs.shape == (2, 16, 16, 3) and np.isfinite(rgbs).all()
    args = serve_parser().parse_args(base)
    service = RenderService(args, engine=app.build_eval_engine(args))
    try:
        frame = service.engine.render_poses(np.eye(4, dtype=np.float32)[None, :3] + np.array(
            [[0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 4.0]], np.float32))
    finally:
        service.close()
    assert frame.shape == (1, 16, 16, 3) and np.isfinite(frame).all()


# --------------------------------------------------------------------- card

def _gaussians(n_rays, S, seed, device):
    o, d, t, radii = _rays(n_rays, seed)
    t = torch.sort(2.0 + 4.0 * torch.rand(n_rays, S + 1, generator=torch.Generator()
                                          .manual_seed(seed)), -1).values
    gauss = mip.cast_rays(t, o, d, radii * 0.05)
    vd = torch.nn.functional.normalize(d, dim=-1)
    return gauss.to(device), vd.to(device)


def _lego_width_state(device):
    args = _args(depth=8, width=256, n=128, rays=4096)
    ccfg, _ = nerf_configs(args)
    state = get_train_state(args, device)
    net = _net(args)
    with torch.no_grad():
        for k, v in ref.to_program(_seeded_params(net, 21), net).items():
            state.coarse.params()[k].copy_(v)
    return args, ccfg, state


@pytest.mark.card
def test_b1_and_b2_ipe_against_the_plain_network(card):
    """B1 and B2 with IPE against float64: within twice the error of the
    plain fp32 network (TF32 off), leaf by leaf (a deep ReLU network's
    gradients in fp32 sit ~1e-3 from float64 either way)."""
    from nerf_shared_tpu_torch.models.nerf import apply_nerf
    from nerf_shared_tpu_torch.ops.cuda import fused_mlp, fused_mlp_bwd

    torch.backends.cuda.matmul.allow_tf32 = False
    _, ccfg, state = _lego_width_state(card)
    params = {k: v.detach() for k, v in state.coarse.params().items()}
    gauss, vd = _gaussians(512, 128, 22, card)
    l0, p0 = fused_mlp.POINT_LAUNCHES_IPE, fused_mlp.IPE_POINTS
    raw = fused_mlp.launch_points(params, ccfg, gauss, vd)
    assert (fused_mlp.POINT_LAUNCHES_IPE - l0, fused_mlp.IPE_POINTS - p0) == (1, 512 * 128)
    pd = {k: v.double() for k, v in params.items()}

    def rel(a, b):
        return float(torch.linalg.vector_norm(a.double() - b) / torch.linalg.vector_norm(b))

    want = apply_nerf(pd, ccfg, gauss.double(), vd.double())
    assert rel(raw, want) <= 2 * rel(apply_nerf(params, ccfg, gauss, vd), want) + 1e-6
    g = torch.randn(raw.shape, generator=torch.Generator(device=card).manual_seed(3),
                    device=card)
    b0 = fused_mlp_bwd.LAUNCHES_IPE
    grads, dpts, ddirs = fused_mlp_bwd.launch_backward(params, ccfg, gauss, vd, g)
    assert fused_mlp_bwd.LAUNCHES_IPE - b0 == 1 and dpts is None and ddirs is None
    with torch.enable_grad():
        leaves = {k: v.clone().requires_grad_(True) for k, v in pd.items()}
        want_g = torch.autograd.grad(
            (apply_nerf(leaves, ccfg, gauss.double(), vd.double()) * g.double()).sum(),
            list(leaves.values()))
        leaves32 = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        plain_g = torch.autograd.grad((apply_nerf(leaves32, ccfg, gauss, vd) * g).sum(),
                                      list(leaves32.values()))
    for k, w, p32 in zip(leaves, want_g, plain_g):
        assert rel(grads[k], w) <= 2 * rel(p32, w) + 1e-5, k


@pytest.mark.card
def test_mip_train_step_makes_no_host_sync(card):
    """One mipnerf-lego step (4096 rays, 128 + 128 intervals, B1 and B2
    with IPE) under ``set_sync_debug_mode("error")``, after a first step
    that builds the kernels."""
    from nerf_shared_tpu_torch.config import resolve_fused_backward

    args, ccfg, state = _lego_width_state(card)
    rcfg = dataclasses.replace(get_renderer(args, {"near": 2.0, "far": 6.0}, card).cfg,
                               use_pallas=False, fused_backward=resolve_fused_backward(
                                   config_parser().parse_args(
                                       ["--model_type", "mipnerf"]), card))
    assert rcfg.fused_backward and rcfg.mip
    Hc = Wc = 800
    Kc = [[1111.1, 0.0, 400.0], [0.0, 1111.1, 400.0], [0.0, 0.0, 1.0]]
    spec = PixelSamplerSpec.from_K(Hc, Wc, Kc, 4096, single_image=True)
    step = make_train_step(rcfg, ccfg, None, spec, coarse_weight=0.1)
    g = torch.Generator().manual_seed(0)
    images = torch.rand(2, Hc, Wc, 3, generator=g).to(card)
    poses = torch.eye(4)[:3].repeat(2, 1, 1)
    poses[:, :, 3] = torch.tensor([0.0, 0.0, 4.0])
    poses = poses.to(card)
    step(state, images, poses, g)
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        aux = step(state, images, poses, g)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    assert torch.isfinite(aux["loss"]).item()
