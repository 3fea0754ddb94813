"""The grid families through the port's trainer, checkpoints, entry points
and fast renderer on the CPU, against the JAX package.

- One hierarchical ``train_step`` per family (split hashgrid; vertex
  triplane with ``tv_reg``) against JAX's sampler, loss and optax Adam with
  the two groups (net at lrate, grid at 2e-2), all draws pinned: loss to
  1e-5 relative, gradients to 1e-4 of each tensor's max, post-Adam
  parameters to 1e-6 except entries whose gradient is within 1e-6 of zero
  without being zero, where Adam's g / (|g| + eps) may turn last-digit
  differences into up to 2 lr.
- The two-group ``.ckpt.npz``: JAX writes -> the port reads and writes
  again -> the same file, key for key (so the group order is JAX's); and
  the port writes -> JAX reads and writes again -> the same file. ``.tar``
  is refused for grid parameters.
- ``_resolve_triplane_aabb`` and ``recipe_warnings`` equal to JAX's.
- A tiny CLI run per family on the CPU (train, resume, render_only; a
  triplane upsample milestone; ``--ckpt_format both`` writes native only).
- An occupancy-grid render of a hashgrid against JAX ``render_image_occ``.
- The renderer's dispatch by config type (a grid config never reaches
  B1-B4 whatever the flags say) and ``--remat`` (the same raw outputs and
  gradients).
"""

import argparse
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_shared_tpu.apps.train import _resolve_triplane_aabb as j_resolve_aabb
from nerf_shared_tpu.config import config_parser as jax_parser
from nerf_shared_tpu.config import recipe_warnings as j_recipe_warnings
from nerf_shared_tpu.data.datasets import load_datasets as j_load_datasets
from nerf_shared_tpu.models import hashgrid as jhash
from nerf_shared_tpu.models import triplane as jtri
from nerf_shared_tpu.render import occupancy as JO
from nerf_shared_tpu.render import renderer as JR
from nerf_shared_tpu.train import pipeline as jpipe
from nerf_shared_tpu.train.state import create_train_state as j_create_state
from nerf_shared_tpu.train.step import pack_ray_batch as j_pack
from nerf_shared_tpu.utils import checkpoints as jckpt
from nerf_shared_tpu.utils.metrics import img2mse as j_img2mse
from nerf_shared_tpu_torch.apps import train as tapp
from nerf_shared_tpu_torch.config import config_parser, recipe_warnings
from nerf_shared_tpu_torch.data.datasets import load_datasets
from nerf_shared_tpu_torch.models import hashgrid as thash
from nerf_shared_tpu_torch.models import triplane as ttri
from nerf_shared_tpu_torch.models.nerf import params_tree_from_jax
from nerf_shared_tpu_torch.render import occupancy as TO
from nerf_shared_tpu_torch.render import renderer as TR
from nerf_shared_tpu_torch.train import pipeline as tpipe
from nerf_shared_tpu_torch.train.state import create_train_state
from nerf_shared_tpu_torch.train.step import make_train_step
from nerf_shared_tpu_torch.utils import checkpoints as tckpt
from tests.test_e2e import _write_config, _write_scene
from tests.test_torch_train import _key_words, _overrides, _scene

HASH_KW = dict(L=3, log2_T=7, F=2, base_res=4, max_res=16, hidden=16, geo_feat=7,
               rgb_depth=2, layout="split", aabb_min=(-3.0,) * 3, aabb_max=(3.0,) * 3)
TRI_KW = dict(G=10, C=4, hidden=16, depth=2, aabb_min=(-3.0,) * 3,
              aabb_max=(3.0,) * 3)
FAMILIES = {
    "hashgrid": (jhash.HashGridConfig, thash.HashGridConfig, HASH_KW),
    "triplane": (jtri.TriplaneConfig, ttri.TriplaneConfig, TRI_KW),
}


def _shared(family, seed=0, lrate=5e-3):
    """The JAX TrainState (two Adam groups) and the port's, with the JAX
    parameters loaded into the port's modules."""
    jc, tc, kw = FAMILIES[family]
    jcfg, tcfg = jc(**kw), tc(**kw)
    jstate = j_create_state(jax.random.PRNGKey(seed), jcfg, jcfg, lrate=lrate,
                            lrate_decay=250)
    tstate = create_train_state(tcfg, tcfg, "cpu", lrate=lrate, lrate_decay=250)
    params = jax.device_get(jstate.params)
    for b, m in tstate.branches():
        m.load_state_dict(params_tree_from_jax(params[b]), strict=True)
    return jcfg, jstate, tcfg, tstate


def _rcfgs():
    base = dict(N_samples=8, N_importance=8, use_viewdirs=True, white_bkgd=True,
                near=2.0, far=6.0, perturb=1.0)
    return JR.RenderConfig(**base), TR.RenderConfig(**base)


def _j_loss(rcfg, cfg, ov, tv_reg):
    """The JAX nerf_loss's arithmetic (fine + coarse MSE, the planes' total
    variation) with its draws pinned."""
    ov = {k: jnp.asarray(v) for k, v in ov.items()}

    def loss(params, batch, target):
        ret = JR.render_rays(params["coarse"], params["fine"], batch,
                             jax.random.PRNGKey(0), rcfg, cfg, cfg, overrides=ov)
        out = j_img2mse(ret["rgb_map"], target) + j_img2mse(ret["rgb0"], target)
        for b in ("coarse", "fine"):
            pl = params[b].get("planes")
            if pl is not None:
                out = out + tv_reg * (jnp.mean((pl[:, 1:] - pl[:, :-1]) ** 2)
                                      + jnp.mean((pl[:, :, 1:] - pl[:, :, :-1]) ** 2))
        return out

    return loss


@pytest.mark.parametrize("family,tv_reg", [("hashgrid", 0.0), ("triplane", 0.1)])
def test_train_step_matches_jax_with_two_adam_groups(family, tv_reg):
    jcfg, jstate, tcfg, tstate = _shared(family, seed=3)
    assert [g["label"] for g in tstate.optimizer.param_groups] == ["net", "grid"]
    jr, tr = _rcfgs()
    images, poses, K = _scene(n=3, H=8, W=8, seed=4)
    kw = dict(single_image=True, precrop_iters=2, precrop_frac=0.5)
    jspec = jpipe.PixelSamplerSpec.from_K(8, 8, K, 16, **kw)
    tspec = tpipe.PixelSamplerSpec.from_K(8, 8, K, 16, **kw)
    key = jax.random.PRNGKey(100)
    ov = _overrides(16, 8, 8, seed=1)
    ro, rd, tgt = jpipe.sample_ray_batch(key, jnp.asarray(images), jnp.asarray(poses),
                                         jstate.step, jspec)
    jb = j_pack(ro, rd, jr, 8, 8, float(K[0, 0]))
    jl, grads = jax.value_and_grad(_j_loss(jr, jcfg, ov, tv_reg))(jstate.params, jb, tgt)
    jstate = jstate.apply_gradients(grads)
    k_img, k_y, k_x = jax.random.split(key, 3)
    draws = {"img_idx": int(jax.random.randint(k_img, (), 0, 3)),
             "key_y": _key_words(k_y), "key_x": _key_words(k_x)}
    aux = make_train_step(tr, tcfg, tcfg, tspec, tv_reg=tv_reg)(
        tstate, torch.from_numpy(images), torch.from_numpy(poses),
        torch.Generator().manual_seed(0), draws=draws,
        overrides={k: torch.from_numpy(v) for k, v in ov.items()})
    assert float(aux["loss"]) == pytest.approx(float(jl), rel=1e-5)
    assert ("tv" in aux) == (tv_reg > 0)
    moved = 0
    for branch, m in tstate.branches():
        want = params_tree_from_jax(jax.device_get(jstate.params[branch]))
        jg = params_tree_from_jax(jax.device_get(grads[branch]))
        for k, p in m.named_parameters():
            tol = 1e-4 * max(1.0, float(jg[k].abs().max()))
            torch.testing.assert_close(p.grad, jg[k], rtol=1e-4, atol=tol, msg=k)
            lr = 2e-2 if k.split(".")[0] in ("tables", "planes") else 5e-3
            fragile = (jg[k].abs() < 1e-6) & (jg[k] != 0)
            d = (p.detach() - want[k]).abs()
            assert float(d[~fragile].max()) <= 1e-6, (branch, k)
            assert float(d.max()) <= 2 * lr, (branch, k)
            moved += int((d > 1e-6).sum())
    assert moved <= sum(p.numel() for p in tstate.parameters()) // 100
    assert tstate.step == tstate.count == 1 == int(jstate.step)


def _ckpt_args(root, expname="x"):
    return argparse.Namespace(basedir=root, expname=expname, ft_path=None,
                              no_reload=False)


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_same_npz(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=0, err_msg=k)


def _random_grads(jstate, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)),
        jstate.params)


@pytest.mark.parametrize("family", ["hashgrid", "triplane"])
def test_two_group_ckpt_jax_to_port_and_back(family, tmp_path):
    """JAX writes a two-group .ckpt.npz after two updates; the port restores
    it (count, Adam steps, moments) and writes the same file again."""
    jcfg, jstate, tcfg, tstate = _shared(family, seed=1)
    for s in range(2):
        jstate = jstate.apply_gradients(_random_grads(jstate, s))
    jckpt.save_checkpoints(str(tmp_path / "j"), "x", jstate, 2, fmt="native")
    src = _npz(tmp_path / "j" / "x" / "000002.ckpt.npz")
    assert int(src["opt/n_groups"]) == 2 and "opt/g0/mu/coarse/" + (
        "tables/0" if family == "hashgrid" else "planes") in src
    assert tckpt.restore_train_state(tstate, _ckpt_args(str(tmp_path / "j"))) == 2
    assert tstate.count == 2
    assert all(int(tstate.optimizer.state[p]["step"]) == 2 for p in tstate.parameters())
    tckpt.save_checkpoints(str(tmp_path / "t"), "x", tstate, 2, fmt="native")
    _assert_same_npz(_npz(tmp_path / "t" / "x" / "000002.ckpt.npz"), src)


@pytest.mark.parametrize("family", ["hashgrid", "triplane"])
def test_two_group_ckpt_port_to_jax_and_back(family, tmp_path):
    """The port writes after two updates (``both`` writes the .ckpt.npz
    alone); JAX loads it and writes the same file again."""
    jcfg, jstate, tcfg, tstate = _shared(family, seed=2)
    rng = np.random.default_rng(0)
    for _ in range(2):
        for p in tstate.parameters():
            p.grad = torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
        tstate.apply_gradients()
    paths = tckpt.save_checkpoints(str(tmp_path / "t"), "x", tstate, 2, fmt="both")
    assert [os.path.basename(p) for p in paths] == ["000002.ckpt.npz"]
    src = _npz(paths[0])
    assert int(src["opt/n_groups"]) == 2
    loaded, start = jckpt.load_checkpoint(jstate, _ckpt_args(str(tmp_path / "t")))
    assert start == 2
    jckpt.save_checkpoints(str(tmp_path / "j"), "x", loaded, 2, fmt="native")
    _assert_same_npz(_npz(tmp_path / "j" / "x" / "000002.ckpt.npz"), src)


def test_tar_is_refused_for_grid_params(tmp_path):
    _, _, _, tstate = _shared("triplane")
    with pytest.raises(ValueError, match="only defined for the 'nerf' model family"):
        tckpt.save_checkpoints(str(tmp_path), "x", tstate, 0, fmt="tar")
    assert not os.path.exists(tmp_path / "x")


def _write(root, **over):
    datadir, logdir = os.path.join(root, "scene"), os.path.join(root, "logs")
    if not os.path.isdir(datadir):
        os.makedirs(datadir)
        _write_scene(datadir)
    return _write_config(root, datadir, logdir, **over)


def test_resolve_triplane_aabb_matches_jax(tmp_path):
    cfg = _write(str(tmp_path))
    for model in ("hashgrid", "triplane"):
        argv = ["--config", cfg, "--model_type", model]
        jargs, targs = jax_parser().parse_args(argv), config_parser().parse_args(argv)
        jds, tds = j_load_datasets(jargs), load_datasets(targs)
        H, W = int(tds.hwf[0]), int(tds.hwf[1])
        j_resolve_aabb(jargs, jds, H, W)
        tapp._resolve_triplane_aabb(targs, tds, H, W)
        assert targs.triplane_aabb > 0
        assert targs.triplane_aabb == pytest.approx(jargs.triplane_aabb, rel=1e-6)
    targs = config_parser().parse_args(["--config", cfg, "--triplane_aabb", "2.5",
                                        "--model_type", "hashgrid"])
    tapp._resolve_triplane_aabb(targs, tds, H, W)
    assert targs.triplane_aabb == 2.5


@pytest.mark.parametrize("argv,n_views,render_h", [
    (["--model_type", "hashgrid", "--hash_max_res", "2048"], 100, 400),
    (["--model_type", "hashgrid", "--hash_max_res", "512"], 100, 400),
    (["--model_type", "hashgrid", "--train_occ", "True", "--hash_max_res", "512"], 100, 400),
    (["--model_type", "hashgrid", "--train_occ", "True", "--hash_sigma_bias", "0.1"], 100, 800),
    (["--loss_sampling", "True", "--N_iters", "200000"], 12, 400),
    (["--model_type", "triplane"], 100, 400),
])
def test_recipe_warnings_match_jax(argv, n_views, render_h):
    want = j_recipe_warnings(jax_parser().parse_args(argv), n_train_views=n_views,
                             render_h=render_h)
    got = recipe_warnings(config_parser().parse_args(argv), n_train_views=n_views,
                          render_h=render_h)
    assert got == want


GRID_CLI = {
    "hashgrid": ["--model_type", "hashgrid", "--hash_layout", "split", "--hash_levels",
                 "3", "--hash_feat", "2", "--hash_log2_size", "8", "--hash_max_res", "32"],
    "triplane": ["--model_type", "triplane", "--triplane_res", "8", "--triplane_feat",
                 "4", "--triplane_hidden", "16", "--triplane_upsample", "3:12",
                 "--tv_loss_weight", "0.01"],
}


@pytest.mark.parametrize("family", ["hashgrid", "triplane"])
def test_cli_trains_resumes_and_renders_a_grid_family(family, tmp_path, capsys):
    cfg = _write(str(tmp_path), expname=family, N_iters=4, i_print=2, i_weights=4,
                 i_testset=0, i_img=4, i_video=0)
    argv = ["--config", cfg, "--device", "cpu"] + GRID_CLI[family]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        state = tapp.main(argv)
    out = capsys.readouterr().out
    assert "grid aabb half-extent" in out and out.count("[TRAIN]") == 2
    assert "[VAL]" in out
    expdir = os.path.join(str(tmp_path), "logs", family)
    files = os.listdir(expdir)
    assert "000004.ckpt.npz" in files and not any(f.endswith(".tar") for f in files)
    with np.load(os.path.join(expdir, "000004.ckpt.npz")) as z:
        assert int(z["opt/n_groups"]) == 2
    if family == "triplane":
        assert "[UPSAMPLE] step 3: planes -> 12^2" in out
        assert state.coarse.cfg.G == 12 and state.count == 4
        # the fresh Adam restarted at the milestone: one update since
        assert int(state.optimizer.state[state.coarse.planes]["step"]) == 1
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        resumed = tapp.main(argv + ["--N_iters", "6"])
    out = capsys.readouterr().out
    assert "Reloading from" in out and resumed.step == 6
    if family == "triplane":
        assert "triplane resolution from checkpoint: 12^2 planes" in out
        assert resumed.coarse.cfg.G == 12
    outdir, rgbs = tapp.render_only(config_parser().parse_args(
        argv + ["--render_only", "--render_test", "--N_iters", "6"]), return_rgbs=True)
    assert rgbs.shape == (2, 16, 16, 3) and np.isfinite(rgbs).all()
    assert sorted(os.listdir(outdir)) == ["000.png", "001.png"]


def test_occupancy_render_of_a_hashgrid_matches_jax():
    """The grid build (through _apply_model) and the froxel and world-grid
    renders of a hashgrid fine model, against JAX to 1e-5."""
    jcfg = jhash.HashGridConfig(**HASH_KW)
    tcfg = thash.HashGridConfig(**HASH_KW)
    jp = jax.device_get(jhash.init_hashgrid_params(jax.random.PRNGKey(5), jcfg))
    rng = np.random.default_rng(5)
    jp["tables"] = [rng.standard_normal(t.shape).astype(np.float32) for t in jp["tables"]]
    jp["sigma_net"][1]["w"] = rng.standard_normal(jp["sigma_net"][1]["w"].shape
                                                  ).astype(np.float32)
    model = thash.HashGrid(tcfg)
    model.load_state_dict(params_tree_from_jax(jp), strict=True)
    base = dict(N_samples=8, N_importance=8, near=2.0, far=6.0, perturb=0.0,
                white_bkgd=True)
    jr, tr = JR.RenderConfig(**base), TR.RenderConfig(**base)
    lo, hi = np.full(3, -3.0, np.float32), np.full(3, 3.0, np.float32)
    jgrid = JO.build_occupancy_grid(jp, jcfg, jr, jnp.asarray(lo), jnp.asarray(hi),
                                    resolution=8, n_jitter=0, alpha_threshold=0.2, dilation=0)
    with torch.no_grad():
        tgrid = TO.build_occupancy_grid(model.params(), tcfg, tr, lo, hi, resolution=8,
                                        n_jitter=0, alpha_threshold=0.2, dilation=0)
    np.testing.assert_array_equal(tgrid.grid.numpy(), np.asarray(jgrid.grid))
    np.testing.assert_allclose(tgrid.sigma.numpy(), np.asarray(jgrid.sigma),
                               rtol=1e-5, atol=1e-5)
    assert 0.0 < tgrid.occupied_fraction() < 1.0
    H = W = 12
    K = np.array([[15.0, 0, W / 2], [0, 15.0, H / 2], [0, 0, 1]])
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[2, 3] = 4.0
    for mode in ("froxel", "grid"):
        kw = dict(chunk=64, n_candidates=16, n_keep=8, mode=mode, tile=4)
        _, want = JR.Renderer(**base).render_image_occ(
            H, W, K, jnp.asarray(c2w), jhash.HashGrid(jcfg, jp), jgrid, **kw)
        with torch.no_grad():
            _, got = TR.Renderer(**base).render_image_occ(H, W, K, c2w, model, tgrid, **kw)
        for k in ("rgb_map", "disp_map", "acc_map"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=f"{mode} {k}")


def test_grid_configs_never_reach_the_mlp_kernels(monkeypatch):
    """With every MLP-kernel flag on (use_pallas, fused_composite,
    fused_backward) a hashgrid renders through its own apply: B1-B4's
    entries are never called; the frame equals the all-flags-off one."""
    from nerf_shared_tpu_torch.models.hashgrid import HashGrid

    def refuse(*a, **k):
        raise AssertionError("an MLP kernel was called for a grid config")

    for name in ("fused_train_op", "fused_nerf_forward", "fused_nerf_forward_rays",
                 "fused_render_rays"):
        monkeypatch.setattr(TR, name, refuse)
    cfg = thash.HashGridConfig(**HASH_KW)
    m = HashGrid(cfg, generator=torch.Generator().manual_seed(0))
    base = dict(N_samples=8, N_importance=8, near=2.0, far=6.0, perturb=0.0,
                white_bkgd=True)
    rng = np.random.default_rng(0)
    rd = rng.standard_normal((16, 3)).astype(np.float32)
    rays = torch.from_numpy(np.concatenate(
        [np.zeros((16, 3), np.float32) + [0, 0, 4], rd, np.full((16, 1), 2, np.float32),
         np.full((16, 1), 6, np.float32), rd / np.linalg.norm(rd, axis=-1, keepdims=True)],
        -1).astype(np.float32))
    on = TR.RenderConfig(**base, use_pallas=True, fused_composite=True, fused_backward=True)
    off = TR.RenderConfig(**base)
    got = TR.render_rays(m.params(), m.params(), rays, on, cfg, cfg)
    want = TR.render_rays(m.params(), m.params(), rays, off, cfg, cfg)
    torch.testing.assert_close(got["rgb_map"], want["rgb_map"], rtol=0, atol=0)


@pytest.mark.parametrize("family", ["hashgrid", "triplane"])
def test_remat_gives_the_same_raw_and_gradients(family):
    """--remat recomputes the grid apply in backward
    (torch.utils.checkpoint): the same raw outputs and gradients."""
    _, _, tcfg, tstate = _shared(family, seed=6)
    params = tstate.coarse.params()
    rng = np.random.default_rng(1)
    pts = torch.from_numpy(rng.uniform(-2.5, 2.5, (4, 6, 3)).astype(np.float32))
    d = torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32))
    out = {}
    for remat in (False, True):
        for p in params.values():
            p.grad = None
        rcfg = TR.RenderConfig(remat=remat)
        raw = TR._apply_model(params, tcfg, pts, d, rcfg)
        (raw ** 2).sum().backward()
        out[remat] = raw.detach(), {k: p.grad.clone() for k, p in params.items()}
    torch.testing.assert_close(out[True][0], out[False][0], rtol=0, atol=0)
    for k, g in out[False][1].items():
        torch.testing.assert_close(out[True][1][k], g, rtol=1e-6, atol=1e-7, msg=k)
