"""The port's EMA eval weights and the whole slice on the CPU, against the
JAX package.

- Three training steps with --proposal, --distortion_loss_weight,
  --loss_sampling and --ema_decay through JAX's make_fused_train_step and
  the port's train_step, every draw pinned from JAX's keys (the pixel
  draw and the weighted tail through ``draws``, the stratified jitter and
  inverse-CDF u through ``overrides``): after each step the loss and its
  parts, the parameters, the EMA shadow and the loss map. Tolerances as
  test_torch_train.py's trajectory: the loss to 1e-5 relative, the
  parameters to 1e-6 except entries whose gradient came within 1e-6 of
  zero without being zero (at most 2 lr a step there, and the shadow a
  tenth of that); the loss map to 1e-6.
- The ``ema/`` sidecar both ways (the port writes, JAX's load_native_ema
  reads; JAX writes, the port's read_native_ema and restore_train_state
  read), a pre-EMA file restarting the shadow, the shadow surviving a
  resume under --ckpt_format both (the port reads the .ckpt.npz sibling).
- build_eval_engine / render_only rendering the EMA weights, against JAX's
  render_only on a .ckpt.npz; /info's "ema".
- The triplane upsample restarting the shadow and keeping the loss map.
- apps/train.main with all four flags on the CPU: train, resume, render.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_shared_tpu.apps.train import render_only as jax_render_only
from nerf_shared_tpu.config import config_parser as jax_parser
from nerf_shared_tpu.models import nerf as jnerf
from nerf_shared_tpu.render.renderer import RenderConfig as JRenderConfig
from nerf_shared_tpu.train import loss_sampling as JL
from nerf_shared_tpu.train import pipeline as jpipe
from nerf_shared_tpu.train.state import create_train_state as j_create_state
from nerf_shared_tpu.train.step import make_fused_train_step
from nerf_shared_tpu.utils import checkpoints as jckpt
from nerf_shared_tpu_torch.apps import train as tapp
from nerf_shared_tpu_torch.apps.serve import RenderService, serve_parser
from nerf_shared_tpu_torch.config import config_parser
from nerf_shared_tpu_torch.models import nerf as tnerf
from nerf_shared_tpu_torch.models import triplane as ttri
from nerf_shared_tpu_torch.render.renderer import RenderConfig
from nerf_shared_tpu_torch.train import loss_sampling as TL
from nerf_shared_tpu_torch.train import pipeline as tpipe
from nerf_shared_tpu_torch.train.state import create_train_state
from nerf_shared_tpu_torch.train.step import make_train_step
from nerf_shared_tpu_torch.utils import checkpoints as tckpt
from tests.test_e2e import _write_config, _write_scene
from tests.test_torch_loss_sampling import weighted_draws
from tests.test_torch_proposal import FINE_KW, PROP_KW, to_torch
from tests.test_torch_train import _scene

H = W = 8
N, N_IMG, TILE = 16, 3, 4
DECAY = 0.9


def _states(seed=7):
    """A proposal coarse + MLP fine: JAX's TrainState with the EMA and a
    uniform loss map in its aux_state, the port's with the same."""
    jp, jf = jnerf.NeRFConfig(**PROP_KW), jnerf.NeRFConfig(**FINE_KW)
    js = j_create_state(jax.random.PRNGKey(seed), jp, jf, lrate=5e-3, lrate_decay=250)
    js = js.replace(aux_state={
        "ema": {k: jax.tree_util.tree_map(jnp.copy, js.params[k]) for k in ("coarse", "fine")},
        "loss_map": JL.init_loss_map(N_IMG, H, W, TILE)})
    tp, tf = tnerf.NeRFConfig(**PROP_KW), tnerf.NeRFConfig(**FINE_KW)
    ts = create_train_state(tp, tf, "cpu", lrate=5e-3, lrate_decay=250)
    params = jax.device_get(js.params)
    for b, m in ts.branches():
        m.load_state_dict(to_torch(params[b]), strict=True)
    ts.init_ema()
    ts.loss_map = TL.init_loss_map(N_IMG, H, W, TILE)
    return (jp, jf, js), (tp, tf, ts)


def test_three_steps_with_all_four_options_match_jax():
    (jp, jf, js), (tp, tf, ts) = _states()
    images, poses, K = _scene(n=N_IMG, H=H, W=W, seed=4)
    kw = dict(single_image=True, precrop_iters=1, precrop_frac=0.5)
    jspec = jpipe.PixelSamplerSpec.from_K(H, W, K, N, **kw)
    tspec = tpipe.PixelSamplerSpec.from_K(H, W, K, N, **kw)
    rcfg = dict(N_samples=8, N_importance=8, use_viewdirs=True, white_bkgd=True,
                near=2.0, far=6.0, perturb=1.0, proposal=True)
    opts = dict(prop_reg=1.0, dist_reg=0.01, ema_decay=DECAY)
    jstep = make_fused_train_step(JRenderConfig(**rcfg), jp, jf, jspec, donate=False,
                                  loss_sampling=JL.LossSamplingSpec(tile=TILE), **opts)
    tstep = make_train_step(RenderConfig(**rcfg), tp, tf, tspec,
                            loss_sampling=TL.LossSamplingSpec(tile=TILE), **opts)
    fragile = {}
    for i in range(3):
        key = jax.random.PRNGKey(60 + i)
        js, jaux = jstep(js, jnp.asarray(images), jnp.asarray(poses), key)
        k_sample, k_render = jax.random.split(key)
        k_strat, k_u, _, _ = jax.random.split(k_render, 4)
        ov = {"t_rand": torch.from_numpy(np.array(jax.random.uniform(k_strat, (N, 8)))),
              "u": torch.from_numpy(np.array(jax.random.uniform(k_u, (N, 8))))}
        taux = tstep(ts, torch.from_numpy(images), torch.from_numpy(poses),
                     torch.Generator().manual_seed(i),
                     draws=weighted_draws(k_sample, N_IMG, N, TILE), overrides=ov)
        for k in ("loss", "img_loss", "prop_loss", "dist_loss", "psnr"):
            # the first step from equal weights: every part to 1e-5; then
            # the near-zero-gradient entries have moved apart (up to 2 lr),
            # which moves the two regularizers (histograms of the same
            # weights) more: 1e-4 relative (2.3e-5 seen)
            rel = 1e-5 if i == 0 or k in ("loss", "img_loss", "psnr") else 1e-4
            assert float(taux[k]) == pytest.approx(float(jaux[k]), rel=rel), (i, k)
        assert "ray_err" not in taux
        jparams = jax.device_get(js.params)
        jema = jax.device_get(js.aux_state["ema"])
        for b, m in ts.branches():
            want, want_e = to_torch(jparams[b]), to_torch(jema[b])
            for k, p in m.named_parameters():
                g = p.grad
                f = fragile.get((b, k), torch.zeros_like(g, dtype=torch.bool))
                f = fragile[(b, k)] = f | ((g.abs() < 1e-6) & (g != 0))
                d = (p.detach() - want[k]).abs()
                assert float(torch.where(f, 0.0, d).max()) <= 1e-6, (i, b, k)
                assert float(d.max()) <= 2 * 5e-3 * (i + 1), (i, b, k)
                de = (ts.ema[b][k] - want_e[k]).abs()
                assert float(torch.where(f, 0.0, de).max()) <= 1e-6, (i, b, k)
                assert float(de.max()) <= 0.2 * 5e-3 * (i + 1), (i, b, k)
        np.testing.assert_allclose(ts.loss_map.numpy(), np.asarray(js.aux_state["loss_map"]),
                                   rtol=0, atol=1e-6)
    assert ts.step == ts.count == 3 == int(js.step)
    assert float((ts.loss_map - 1.0).abs().max()) > 1e-3
    e = ts.ema["fine"]["pts_linears.0.weight"]
    p = ts.fine.params()["pts_linears.0.weight"].detach()
    assert float((e - p).abs().max()) > 1e-4


def _stepped(seed=3):
    """A port state whose parameters and shadow differ (two unit steps)."""
    _, (_, _, ts) = _states(seed=seed)
    for _ in range(2):
        for p in ts.parameters():
            p.grad = torch.ones_like(p)
        ts.apply_gradients()
        ts.update_ema(DECAY)
    ts.step = 2
    return ts


def _args(root, *extra):
    return config_parser().parse_args(["--basedir", root, "--expname", "e",
                                       "--device", "cpu", *extra])


def test_ema_sidecar_port_to_jax(tmp_path):
    ts = _stepped()
    paths = tckpt.save_checkpoints(str(tmp_path), "e", ts, 2, fmt="both")
    npz = next(p for p in paths if p.endswith(".npz"))
    jema = jckpt.load_native_ema(npz)
    assert set(jema) == {"coarse", "fine"}
    for b, shadow in ts.ema.items():
        want = to_torch(jema[b])
        for k, v in shadow.items():
            torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    params, _, _ = jckpt.load_native(npz)
    assert float(np.abs(params["fine"]["pts_linears"][0]["w"]
                        - jema["fine"]["pts_linears"][0]["w"]).max()) > 1e-4
    assert jckpt.load_native_ema(next(p for p in paths if p.endswith(".tar"))) is None


def test_ema_sidecar_jax_to_port(tmp_path):
    """JAX's save_checkpoints with an EMA in its aux_state -> the port's
    read_native_ema and a resume with --ema_decay restore the shadow
    exactly."""
    (jp, jf, js), _ = _states(seed=5)
    grads = jax.tree_util.tree_map(jnp.ones_like, js.params)
    js = js.apply_gradients(grads)
    js = js.replace(aux_state={**js.aux_state, "ema": jax.tree_util.tree_map(
        lambda e, p: 0.5 * e + 0.5 * p, js.aux_state["ema"],
        {k: js.params[k] for k in ("coarse", "fine")})})
    jckpt.save_checkpoints(str(tmp_path), "e", js, 1, fmt="native")
    path = os.path.join(str(tmp_path), "e", "000001.ckpt.npz")
    jema = jax.device_get(js.aux_state["ema"])
    got = tckpt.read_native_ema(path)
    _, (_, _, ts) = _states(seed=6)
    ts.init_ema()
    assert tckpt.restore_train_state(ts, _args(str(tmp_path), "--ema_decay", "0.5")) == 1
    for b in ("coarse", "fine"):
        want = to_torch(jema[b])
        for k in want:
            torch.testing.assert_close(got[b][k], want[k], rtol=0, atol=0)
            torch.testing.assert_close(ts.ema[b][k], want[k], rtol=0, atol=0)


def test_pre_ema_file_restarts_the_shadow(tmp_path):
    """A file without the sidecar (or a .tar) restarts the shadow at the
    loaded weights, as JAX's load_checkpoint."""
    ts = _stepped()
    ts.ema = None
    tckpt.save_checkpoints(str(tmp_path), "e", ts, 2, fmt="native")
    _, (_, _, fresh) = _states(seed=9)
    fresh.init_ema()
    for shadow in fresh.ema.values():
        for v in shadow.values():
            v.add_(1.0)
    tckpt.restore_train_state(fresh, _args(str(tmp_path), "--ema_decay", "0.9"))
    for b, m in fresh.branches():
        for k, v in m.params().items():
            torch.testing.assert_close(fresh.ema[b][k], v.detach(), rtol=0, atol=0)
            torch.testing.assert_close(v.detach(), dict(ts.branches())[b].params()[k].detach())


def test_shadow_survives_a_resume_from_both_formats(tmp_path, capsys):
    """Under --ckpt_format both the newest file is the .tar (no sidecar):
    a run with --ema_decay reads its .ckpt.npz sibling, so the shadow comes
    back exactly (the JAX loader takes the .tar and restarts it)."""
    ts = _stepped()
    tckpt.save_checkpoints(str(tmp_path), "e", ts, 2, fmt="both")
    _, (_, _, fresh) = _states(seed=9)
    fresh.init_ema()
    tckpt.restore_train_state(fresh, _args(str(tmp_path), "--ema_decay", "0.9"))
    assert "000002.ckpt.npz" in capsys.readouterr().out
    for b, shadow in ts.ema.items():
        for k, v in shadow.items():
            torch.testing.assert_close(fresh.ema[b][k], v, rtol=0, atol=0)
    coarse, fine, step = tckpt.load_checkpoint(_args(str(tmp_path), "--ema_decay", "0.9"),
                                               ema=True)
    assert step == 2
    torch.testing.assert_close(fine["pts_linears.0.weight"],
                               ts.ema["fine"]["pts_linears.0.weight"], rtol=0, atol=0)


@pytest.fixture(scope="module")
def ema_scene(tmp_path_factory):
    """A JAX-written .ckpt.npz (native only) of a proposal hierarchy at
    tiny widths whose EMA sidecar differs from its parameters."""
    root = str(tmp_path_factory.mktemp("torch_ema"))
    datadir, logdir = os.path.join(root, "scene"), os.path.join(root, "logs")
    os.makedirs(datadir)
    _write_scene(datadir)
    cfg = _write_config(root, datadir, logdir, expname="ema", netdepth=3,
                        netdepth_fine=3, proposal=True, proposal_depth=2,
                        proposal_width=16, ckpt_format="native")
    jargs = jax_parser().parse_args(["--config", cfg])
    from nerf_shared_tpu.factory import get_train_state

    js = get_train_state(jargs)
    rng = np.random.default_rng(0)
    ema = jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(0.05 * rng.standard_normal(p.shape), p.dtype),
        {k: js.params[k] for k in ("coarse", "fine")})
    js = js.replace(step=jnp.asarray(7, jnp.int32), aux_state={"ema": ema})
    jckpt.save_checkpoints(logdir, "ema", js, 7, fmt="native")
    return cfg


@pytest.mark.parametrize("engine", [[], ["--render_guided", "6"]], ids=["dense", "guided"])
def test_render_only_renders_the_ema_weights_as_jax_does(ema_scene, engine):
    """render_only with --ema_decay, densely and through the guided fine
    pass on the proposal's histogram: the port's frames equal JAX's (both
    render the sidecar) to 1e-4, and differ from the raw weights' frames;
    the service's /info says "ema"."""
    argv = ["--config", ema_scene, "--render_only", "--render_test", "--chunk", "100"] + engine
    _, want = jax_render_only(jax_parser().parse_args(argv + ["--ema_decay", "0.9"]),
                              return_rgbs=True)
    targs = serve_parser().parse_args(argv + ["--device", "cpu", "--ema_decay", "0.9"])
    _, got = tapp.render_only(targs, return_rgbs=True)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    _, raw = tapp.render_only(serve_parser().parse_args(argv + ["--device", "cpu"]),
                              return_rgbs=True)
    assert float(np.abs(raw - got).max()) > 1e-3
    if engine:
        return
    eng = tapp.build_eval_engine(targs)
    shadow = tckpt.read_native_ema(tckpt.newest_checkpoint(targs))
    for b, m in (("coarse", eng.coarse), ("fine", eng.fine)):
        for k, v in m.state_dict().items():
            torch.testing.assert_close(v, shadow[b][k], rtol=0, atol=0)
    assert RenderService(targs, eng).info()["ema"] is True
    plain = serve_parser().parse_args(argv + ["--device", "cpu"])
    assert RenderService(plain, tapp.build_eval_engine(plain)).info()["ema"] is False


def test_occupancy_engine_serves_a_proposal_checkpoint(ema_scene):
    """The occupancy engines read the fine network alone (the grid is built
    from it), so a proposal checkpoint serves through them as any other."""
    args = serve_parser().parse_args(["--config", ema_scene, "--device", "cpu",
                                      "--ema_decay", "0.9", "--chunk", "100",
                                      "--occ_grid", "8", "--occ_candidates", "16",
                                      "--occ_keep", "8"])
    eng = tapp.build_eval_engine(args)
    assert eng.engine_name == "occ-froxel" and eng.renderer.cfg.proposal
    rgb = eng.render_poses(eng.ds.poses[eng.ds.i_test][:1, :3, :4])
    assert rgb.shape == (1, 16, 16, 3) and np.isfinite(rgb).all()


def test_eval_models_read_the_shadow_before_the_barf_mask():
    ts = _stepped()
    args = config_parser().parse_args(["--ema_decay", "0.9"])
    pairs = tapp._eval_models(args, 5, ts.coarse, ts.fine, ts.ema)
    assert pairs[1][0] is ts.ema["fine"] and pairs[1][1] is ts.fine.cfg
    args = config_parser().parse_args(["--ema_decay", "0.9", "--barf_anneal", "10"])
    pairs = tapp._eval_models(args, 5, ts.coarse, ts.fine, ts.ema)
    want = tnerf.anneal_nerf_params(ts.ema["fine"], ts.fine.cfg, 0.5)
    for k, v in want.items():
        torch.testing.assert_close(pairs[1][0][k], v, rtol=0, atol=0)
    assert tapp._eval_models(config_parser().parse_args([]), 5, ts.coarse, ts.fine) == (
        ts.coarse, ts.fine)


def test_triplane_upsample_restarts_the_shadow_and_keeps_the_map():
    cfg = ttri.TriplaneConfig(G=8, C=4, hidden=16, depth=2, aabb_min=(-3.0,) * 3,
                              aabb_max=(3.0,) * 3)
    ts = create_train_state(cfg, cfg, "cpu", lrate=5e-3, grid_lrate=2e-2)
    ts.init_ema()
    ts.loss_map = TL.init_loss_map(2, 8, 8, 4) * 3.0
    ts.step = ts.count = 5
    args = config_parser().parse_args(["--model_type", "triplane", "--lrate", "5e-3"])
    new, ccfg, fcfg = tapp._upsample_state(ts, 12, args)
    assert ccfg.G == fcfg.G == 12 and new.step == new.count == 5
    assert new.loss_map is ts.loss_map
    for b, m in new.branches():
        assert new.ema[b]["planes"].shape == (3, 12, 12, cfg.width)
        for k, v in m.params().items():
            torch.testing.assert_close(new.ema[b][k], v.detach(), rtol=0, atol=0)
            assert new.ema[b][k].data_ptr() != v.data_ptr()
    ts.ema = None
    assert tapp._upsample_state(ts, 12, args)[0].ema is None


def test_cli_trains_resumes_and_renders_with_all_four_flags(tmp_path, capsys):
    """apps/train.main with --proposal --loss_sampling --ema_decay
    --distortion_loss_weight on the CPU: the start-up lines, the shadow in
    the .ckpt.npz and restored exactly on resume (from the .ckpt.npz
    sibling of the .tar), a loss map off uniform, and render_only's frames
    equal to a render of the shadow."""
    root = str(tmp_path)
    datadir, logdir = os.path.join(root, "scene"), os.path.join(root, "logs")
    os.makedirs(datadir)
    _write_scene(datadir)
    cfg = _write_config(root, datadir, logdir, expname="four", N_iters=8, i_print=4,
                        i_weights=8, i_img=8)
    argv = ["--config", cfg, "--device", "cpu", "--proposal", "True", "--loss_sampling",
            "True", "--ema_decay", "0.9", "--distortion_loss_weight", "0.01"]
    state = tapp.main(argv)
    out = capsys.readouterr().out
    for line in ("loss sampling: 50% of rays from the per-image 8px-tile error map",
                 "EMA eval: decay 0.9 shadow", "proposal sampler: coarse branch is a "
                 "density-only 2x64 MLP (interlevel loss weight 1.0)", "[VAL] Iter: 8"):
        assert line in out, line
    assert isinstance(state.coarse.cfg, tnerf.NeRFConfig) and state.coarse.cfg.W == 64
    assert float((state.loss_map - 1.0).abs().max()) > 1e-3
    expdir = os.path.join(logdir, "four")
    with np.load(os.path.join(expdir, "000008.ckpt.npz")) as z:
        saved = z["ema/fine/pts_linears/0/w"]
    np.testing.assert_array_equal(saved, state.ema["fine"]["pts_linears.0.weight"].T.numpy())
    shadow8 = {b: {k: v.clone() for k, v in s.items()} for b, s in state.ema.items()}
    state2 = tapp.main(argv + ["--N_iters", "12"])
    out = capsys.readouterr().out
    assert "Reloading from" in out and "000008.ckpt.npz" in out
    assert state2.step == 12
    for b in shadow8:
        d = max(float((state2.ema[b][k] - shadow8[b][k]).abs().max()) for k in shadow8[b])
        assert 0 < d < 1.0, b   # restored, then four more blends
    # resume at the last step: the shadow comes back exactly
    state3 = tapp.main(argv + ["--N_iters", "12"])
    for b in state2.ema:
        for k, v in state2.ema[b].items():
            torch.testing.assert_close(state3.ema[b][k], v, rtol=0, atol=0)
    _, rgbs = tapp.render_only(config_parser().parse_args(
        argv + ["--N_iters", "12", "--render_only", "--render_test"]), return_rgbs=True)
    from nerf_shared_tpu_torch.data.datasets import load_datasets
    from nerf_shared_tpu_torch.factory import get_renderer

    args = config_parser().parse_args(argv)
    ds = load_datasets(args)
    models = [(state2.ema[b], m.cfg) for b, m in state2.branches()]
    want = get_renderer(args, ds.bds_dict, "cpu").render_from_batch_poses(
        16, 16, ds.K, args.chunk, ds.poses[ds.i_test][:, :3, :4], *models, retraw=False)
    np.testing.assert_allclose(rgbs, want, rtol=0, atol=1e-6)
    assert rgbs.shape == (2, 16, 16, 3) and np.isfinite(rgbs).all()


def test_mixed_triplane_upsample_grows_the_fine_planes_only():
    """A proposal MLP coarse + triplane fine: the milestone grows the fine
    planes and keeps the proposal as it is (the JAX trainer reads
    ``ccfg.G`` of the proposal's NeRFConfig there and stops with an
    AttributeError: ROADMAP C); the shadow restarts at the new fields."""
    pcfg = tnerf.NeRFConfig(**PROP_KW)
    cfg = ttri.TriplaneConfig(G=8, C=4, hidden=16, depth=2, aabb_min=(-3.0,) * 3,
                              aabb_max=(3.0,) * 3)
    ts = create_train_state(pcfg, cfg, "cpu", lrate=5e-3)
    ts.init_ema()
    assert tapp._plane_res(pcfg, cfg) == 8
    args = config_parser().parse_args(["--model_type", "triplane", "--proposal", "True"])
    new, ccfg, fcfg = tapp._upsample_state(ts, 12, args)
    assert new.coarse is ts.coarse and ccfg is pcfg and fcfg.G == 12
    assert [g["label"] for g in new.optimizer.param_groups] == ["net", "grid"]
    assert new.ema["fine"]["planes"].shape == (3, 12, 12, cfg.width)
    torch.testing.assert_close(new.ema["coarse"]["pts_linears.0.weight"],
                               ts.coarse.params()["pts_linears.0.weight"].detach())


def test_mixed_triplane_resume_adopts_the_checkpoints_resolution(tmp_path):
    """A resume after an upsample of the mixed triplane reads the fine
    planes' resolution from the .ckpt.npz (the proposal has none)."""
    pcfg = tnerf.NeRFConfig(**PROP_KW)
    cfg = ttri.TriplaneConfig(G=12, C=4, hidden=16, depth=2, aabb_min=(-3.0,) * 3,
                              aabb_max=(3.0,) * 3)
    ts = create_train_state(pcfg, cfg, "cpu")
    tckpt.save_checkpoints(str(tmp_path), "e", ts, 4, fmt="both")
    args = _args(str(tmp_path), "--model_type", "triplane", "--proposal", "True")
    small = ttri.TriplaneConfig(**{**cfg.__dict__, "G": 8})
    ccfg, fcfg = tapp._sync_triplane_res(args, pcfg, small)
    assert ccfg is pcfg and fcfg == cfg
