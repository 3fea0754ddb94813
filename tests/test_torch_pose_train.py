"""Training with --refine_poses, --appearance and --barf_anneal in the port,
against the JAX package on the CPU: three steps of the real
``make_fused_train_step`` across ``pose_start`` and mid-ramp, the per-image
groups in the checkpoints both ways (the ``.tar`` field-only) with the JAX
loader's flag-on / flag-off behaviour and messages, the trainer's guards,
and the CLI training, resuming and rendering mid-anneal.

The steps render at perturb 0 without sigma noise, so the JAX step draws
nothing but its pixels; those come from its own keys, handed to the port
as pinned draws (``draws``), as in tests/test_torch_train.py."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_shared_tpu.apps import train as japp_train
from nerf_shared_tpu.config import config_parser as jax_parser
from nerf_shared_tpu.models import nerf as jnerf
from nerf_shared_tpu.render.renderer import RenderConfig as JRenderConfig
from nerf_shared_tpu.train import pipeline as jpipe
from nerf_shared_tpu.train.state import create_train_state as j_create_state
from nerf_shared_tpu.train.step import make_fused_train_step
from nerf_shared_tpu.utils import checkpoints as jckpt
from nerf_shared_tpu_torch.apps import train as tapp
from nerf_shared_tpu_torch.config import config_parser
from nerf_shared_tpu_torch.models import nerf as tnerf
from nerf_shared_tpu_torch.render.renderer import RenderConfig
from nerf_shared_tpu_torch.train import pipeline as tpipe
from nerf_shared_tpu_torch.train.state import create_train_state, fresh_state_at
from nerf_shared_tpu_torch.train.step import make_train_step
from nerf_shared_tpu_torch.utils import checkpoints as tckpt
from tests.test_e2e import _write_config, _write_scene

KW = dict(D=3, W=32, skips=(1,), use_viewdirs=True, multires=4,
          multires_views=2, output_ch=5)
N_IMG, H, W, N = 3, 8, 8, 24


def _key_words(key):
    return torch.from_numpy(np.asarray(jax.random.key_data(key)).astype(np.int64))


def _scene(seed=4):
    rng = np.random.default_rng(seed)
    images = rng.random((N_IMG, H, W, 3)).astype(np.float32)
    poses = np.stack([np.eye(4)[:3] + 0.1 * rng.standard_normal((3, 4))
                      for _ in range(N_IMG)]).astype(np.float32)
    poses[:, 2, 3] += 4.0
    K = np.array([[9.0, 0, W / 2], [0, 9.5, H / 2], [0, 0, 1]])
    return images, poses, K


def _states(seed=7):
    """A JAX and a port TrainState with the same fields, two pose twists
    rows already off identity and nonzero gains (so every group carries a
    gradient from the first step), lr 5e-4, pose and appearance lr 1e-3."""
    jcfg, tcfg = jnerf.NeRFConfig(**KW), tnerf.NeRFConfig(**KW)
    js = j_create_state(jax.random.PRNGKey(seed), jcfg, jcfg, lrate=5e-4,
                        n_refine_poses=N_IMG, n_appearance=N_IMG)
    rng = np.random.default_rng(seed)
    tw = (rng.standard_normal((N_IMG, 6)) * 0.02).astype(np.float32)
    gain = (rng.standard_normal((N_IMG, 3)) * 0.1).astype(np.float32)
    off = (rng.standard_normal((N_IMG, 3)) * 0.05).astype(np.float32)
    params = dict(js.params)
    params["pose_twists"] = jnp.asarray(tw)
    params["appearance"] = {"gain": jnp.asarray(gain), "offset": jnp.asarray(off)}
    js = js.replace(params=params)
    ts = create_train_state(tcfg, tcfg, "cpu", lrate=5e-4, n_refine_poses=N_IMG,
                            n_appearance=N_IMG)
    p = jax.device_get(js.params)
    with torch.no_grad():
        for b, m in ts.branches():
            m.load_state_dict(tnerf.params_from_jax(p[b]))
        for k, v in (("pose_twists", tw), ("appearance.gain", gain),
                     ("appearance.offset", off)):
            ts.aux[k].copy_(torch.from_numpy(v))
    return jcfg, js, tcfg, ts


def _port_params(ts):
    out = {}
    for b, m in ts.branches():
        out.update({(b, k): v for k, v in m.state_dict().items()})
    out.update({("aux", k): v.detach() for k, v in ts.aux.items()})
    return out


def _jax_params(jp):
    out = {}
    for b in ("coarse", "fine"):
        out.update({(b, k): v for k, v in tnerf.params_from_jax(jp[b]).items()})
    out[("aux", "pose_twists")] = torch.from_numpy(np.array(jp["pose_twists"]))
    for k in ("gain", "offset"):
        out[("aux", f"appearance.{k}")] = torch.from_numpy(np.array(jp["appearance"][k]))
    return out


@pytest.mark.parametrize("single_image", [True, False], ids=["single", "batching"])
def test_refine_steps_match_jax_across_pose_start_and_mid_ramp(single_image):
    """Three steps with pose twists (gated until step 1, image 0 anchored),
    appearance (image 0 anchored) and BARF over steps [0, 4] (progress 0,
    0.25, 0.5), through JAX's make_fused_train_step and the port's
    train_step with the same pixels. test_torch_train.py's step
    tolerances: loss 1e-5 relative; after each step every parameter within
    1e-6, except entries whose gradient came within 1e-6 of zero without
    being zero (Adam's g / (|g| + eps) amplifies their last digits), which
    stay within 2 lr a step. The twists are unchanged by the gated step
    and move after it; image 0's twist and gain never move."""
    jcfg, js, tcfg, ts = _states()
    images, poses, K = _scene()
    spec_kw = dict(single_image=single_image, precrop_iters=0)
    jspec = jpipe.PixelSamplerSpec.from_K(H, W, K, N, **spec_kw)
    tspec = tpipe.PixelSamplerSpec.from_K(H, W, K, N, **spec_kw)
    rcfg = dict(N_samples=8, N_importance=8, use_viewdirs=True, white_bkgd=True,
                near=2.0, far=6.0, perturb=0.0)
    opts = dict(pose_start=1, barf_end=4, barf_start=0)
    jstep = make_fused_train_step(JRenderConfig(**rcfg), jcfg, jcfg, jspec, donate=False,
                                  **opts)
    tstep = make_train_step(RenderConfig(**rcfg), tcfg, tcfg, tspec, **opts)
    tw0 = ts.aux["pose_twists"].detach().clone()
    fragile = {}
    for i in range(3):
        key = jax.random.PRNGKey(50 + i)
        js_new, jaux = jstep(js, jnp.asarray(images), jnp.asarray(poses), key)
        k_img, k_y, k_x = jax.random.split(jax.random.split(key)[0], 3)
        if single_image:
            draws = {"img_idx": int(jax.random.randint(k_img, (), 0, N_IMG)),
                     "key_y": _key_words(k_y), "key_x": _key_words(k_x)}
        else:
            draws = {"img_idx": np.asarray(jax.random.randint(k_img, (N,), 0, N_IMG)),
                     "y": np.asarray(jax.random.randint(k_y, (N,), 0, H)),
                     "x": np.asarray(jax.random.randint(k_x, (N,), 0, W))}
        taux = tstep(ts, torch.from_numpy(images), torch.from_numpy(poses),
                     torch.Generator().manual_seed(i), draws=draws)
        for k in ("loss", "psnr", "twist_norm", "gain_norm"):
            assert float(taux[k]) == pytest.approx(float(jaux[k]), rel=1e-5), (i, k)
        # the gradient each entry saw (the port's; they agree with JAX's
        # to fp32 rounding): after the step, before the next zero_grad
        grads = {(b, k): p.grad for b, m in ts.branches() for k, p in m.named_parameters()}
        grads.update({("aux", k): p.grad for k, p in ts.aux.items()})
        got = _port_params(ts)
        for name, w in _jax_params(jax.device_get(js_new.params)).items():
            g = grads[name]
            f = fragile.get(name, torch.zeros_like(w, dtype=torch.bool))
            f = fragile[name] = f | ((g.abs() < 1e-6) & (g != 0))
            d = (got[name] - w).abs()
            assert float(torch.where(f, 0.0, d).max()) <= 1e-6, (i, name)
            assert float(d.max()) <= 2 * 1e-3 * (i + 1), (i, name)
        js = js_new
        tw = ts.aux["pose_twists"].detach()
        if i == 0:
            assert torch.equal(tw, tw0)
        assert torch.equal(tw[0], tw0[0])
    assert float((tw[1:] - tw0[1:]).abs().max()) > 1e-4
    assert ts.step == ts.count == 3 == int(js.step)


def _np_state(js):
    return jax.device_get(js.params), jckpt.adam_state_to_flat(jax.device_get(js.opt_state))


def _ckpt_args(basedir, extra=()):
    return config_parser().parse_args(["--basedir", basedir, "--expname", "x",
                                       "--device", "cpu", *extra])


def _stepped_states():
    """The two states after one identical step (nonzero moments in every
    group)."""
    jcfg, js, tcfg, ts = _states(seed=11)
    images, poses, K = _scene(seed=5)
    spec = dict(single_image=False)
    rcfg = dict(N_samples=8, N_importance=8, near=2.0, far=6.0, perturb=0.0)
    key = jax.random.PRNGKey(3)
    js, _ = make_fused_train_step(JRenderConfig(**rcfg), jcfg, jcfg,
                                  jpipe.PixelSamplerSpec.from_K(H, W, K, N, **spec),
                                  donate=False)(js, jnp.asarray(images), jnp.asarray(poses), key)
    k_img, k_y, k_x = jax.random.split(jax.random.split(key)[0], 3)
    draws = {"img_idx": np.asarray(jax.random.randint(k_img, (N,), 0, N_IMG)),
             "y": np.asarray(jax.random.randint(k_y, (N,), 0, H)),
             "x": np.asarray(jax.random.randint(k_x, (N,), 0, W))}
    make_train_step(RenderConfig(**rcfg), tcfg, tcfg, tpipe.PixelSamplerSpec.from_K(
        H, W, K, N, **spec))(ts, torch.from_numpy(images), torch.from_numpy(poses),
                             torch.Generator(), draws=draws)
    return jcfg, js, tcfg, ts


def test_jax_native_checkpoint_with_both_groups_resumes_in_the_port(tmp_path):
    """A JAX .ckpt.npz (both groups, their Adam moments, count 1) restored
    by the port: parameters bit for bit, every moment of every group, and
    Adam's count; the next save writes the same keys JAX wrote."""
    _, js, tcfg, _ = _stepped_states()
    params, opt_flat = _np_state(js)
    path = str(tmp_path / "x" / "000001.ckpt.npz")
    jckpt.save_native(path, params, opt_flat, 1)
    fresh = create_train_state(tcfg, tcfg, "cpu", n_refine_poses=N_IMG, n_appearance=N_IMG)
    assert tckpt.restore_train_state(fresh, _ckpt_args(str(tmp_path))) == 1
    want = _jax_params(params)
    for name, v in _port_params(fresh).items():
        torch.testing.assert_close(v, want[name], rtol=0, atol=0, msg=str(name))
    groups = {g["label"]: g for g in fresh.optimizer.param_groups}
    assert set(groups) == {"net", "pose", "appearance"} and fresh.count == 1
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    gi = {lab: i for i, lab in enumerate(sorted(groups))}
    for k, lab, key in (("pose_twists", "pose", "pose_twists"),
                        ("appearance.gain", "appearance", "appearance/gain"),
                        ("appearance.offset", "appearance", "appearance/offset")):
        st = fresh.optimizer.state[fresh.aux[k]]
        assert int(st["step"]) == 1
        np.testing.assert_array_equal(st["exp_avg"].numpy(), flat[f"opt/g{gi[lab]}/mu/{key}"])
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), flat[f"opt/g{gi[lab]}/nu/{key}"])
    out = tckpt.save_checkpoints(str(tmp_path), "y", fresh, 1, fmt="native")[0]
    with np.load(out) as z:
        assert sorted(z.files) == sorted(flat)
        for k in flat:
            np.testing.assert_array_equal(z[k], flat[k], err_msg=k)


def test_port_native_checkpoint_resumes_in_jax_and_tar_stays_field_only(tmp_path):
    """The port's .ckpt.npz after a step, restored by the JAX loader into a
    state with both groups: parameters bit for bit, moments and counts as
    JAX's own step made them (1e-6). The .tar beside it holds the fields
    and their Adam alone, and reads back in JAX."""
    _, js, _, ts = _stepped_states()
    paths = tckpt.save_checkpoints(str(tmp_path), "x", ts, 1, fmt="both")
    tar = torch.load(paths[1], weights_only=True)
    assert len(tar["optimizer_state_dict"]["state"]) == len(ts.parameters())
    assert [g["label"] for g in tar["optimizer_state_dict"]["param_groups"]] == ["net"]
    assert "pose_twists" not in str(list(tar))
    jargs = jax_parser().parse_args(["--basedir", str(tmp_path), "--expname", "x",
                                     "--ft_path", paths[0]])
    jcfg = jnerf.NeRFConfig(**KW)
    template = j_create_state(jax.random.PRNGKey(0), jcfg, jcfg, lrate=5e-4,
                              n_refine_poses=N_IMG, n_appearance=N_IMG)
    loaded, step = jckpt.load_checkpoint(template, jargs)
    assert step == 1
    want, got = _port_params(ts), _jax_params(jax.device_get(loaded.params))
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0, msg=str(name))
    a, b = _np_state(loaded)[1], _np_state(js)[1]
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6, err_msg=k)
    params_j, _, step_j = jckpt.load_tar(paths[1], jax.device_get(template.params))
    assert step_j == 1
    np.testing.assert_array_equal(np.asarray(params_j["coarse"]["pts_linears"][0]["w"]),
                                  ts.coarse.state_dict()["pts_linears.0.weight"].numpy().T)


def _lines(text):
    return [ln for ln in text.splitlines() if "Reloading" in ln or "Adam moments" in ln]


@pytest.mark.parametrize("case", ["flags_off", "flags_on_absent", "tar_sibling", "tar_only"])
def test_group_resume_rules_and_messages_match_jax(tmp_path, capsys, case):
    """The four ways a file and the flags can disagree, as the JAX loader
    handles them: the same file chosen, the same messages, the groups at
    identity or as saved, and every Adam moment restarted (count 0) where
    JAX restarts them."""
    jcfg, js, tcfg, ts = _stepped_states()
    with_groups = case != "flags_on_absent"
    src = ts if with_groups else create_train_state(tcfg, tcfg, "cpu")
    if not with_groups:
        src.coarse.load_state_dict(ts.coarse.state_dict())
        src.fine.load_state_dict(ts.fine.state_dict())
    fmt = {"tar_only": "tar", "tar_sibling": "both"}.get(case, "native")
    tckpt.save_checkpoints(str(tmp_path), "x", src, 1, fmt=fmt)
    wants = case != "flags_off"
    n = N_IMG if wants else 0
    jstate = j_create_state(jax.random.PRNGKey(0), jcfg, jcfg, lrate=5e-4,
                            n_refine_poses=n, n_appearance=n)
    jstate, _ = jckpt.load_checkpoint(jstate, jax_parser().parse_args(
        ["--basedir", str(tmp_path), "--expname", "x"]))
    jout = _lines(capsys.readouterr().out)
    tstate = create_train_state(tcfg, tcfg, "cpu", n_refine_poses=n, n_appearance=n)
    tckpt.restore_train_state(tstate, _ckpt_args(str(tmp_path)))
    tout = _lines(capsys.readouterr().out)
    assert tout == jout and len(jout) >= 1
    assert (len(jout) > 1) == (case not in ("tar_sibling",))
    jp = jax.device_get(jstate.params)
    if wants:
        want = _jax_params(jp)
        for k, v in tstate.aux.items():
            torch.testing.assert_close(v.detach(), want[("aux", k)], rtol=0, atol=0, msg=k)
    reset = case != "tar_sibling"
    assert tstate.count == (0 if reset else 1)
    assert (len(tstate.optimizer.state) == 0) == reset


def test_barf_guards_raise_as_in_jax(tmp_path):
    """--barf_anneal with a grid family or with the identity embedding
    exits with the JAX trainer's message; no entry point keeps a
    not-ported check for the other pose flags."""
    root = str(tmp_path)
    datadir, logdir = os.path.join(root, "scene"), os.path.join(root, "logs")
    os.makedirs(datadir)
    _write_scene(datadir)
    cfg = _write_config(root, datadir, logdir, expname="g", N_iters=2)
    for extra in (["--model_type", "triplane"], ["--i_embed", "-1"]):
        argv = ["--config", cfg, "--barf_anneal", "10"] + extra
        with pytest.raises(SystemExit) as want:
            japp_train.train(jax_parser().parse_args(argv))
        with pytest.raises(SystemExit) as got:
            tapp.train(config_parser().parse_args(argv + ["--device", "cpu"]))
        assert str(got.value) == str(want.value) and "--barf_anneal" in str(got.value)
    # no entry point keeps a not-ported check: every flag is ported
    assert not hasattr(tapp, "check_ported")


def test_cli_trains_resumes_and_renders_with_the_pose_flags(tmp_path, capsys):
    """--refine_poses --appearance --barf_anneal through the CLI: the twists
    stay at identity before --refine_poses_from and move after it (image
    0's never), the .ckpt.npz carries both groups and their moments, the
    .tar none; the resume takes the .ckpt.npz sibling and restores them;
    the eval hooks and render_only mid-anneal render the step's masked
    encoder (the frame equals a render of the annealed weights)."""
    root = str(tmp_path)
    datadir, logdir = os.path.join(root, "scene"), os.path.join(root, "logs")
    os.makedirs(datadir)
    _write_scene(datadir)
    cfg = _write_config(root, datadir, logdir, expname="p", N_iters=6, i_print=3,
                        i_weights=3, i_img=3)
    argv = ["--config", cfg, "--device", "cpu", "--refine_poses", "True",
            "--appearance", "True", "--barf_anneal", "20", "--refine_poses_from", "4",
            "--pose_lrate", "1e-2", "--appearance_lrate", "1e-2"]
    state = tapp.main(argv + ["--N_iters", "3"])
    out = capsys.readouterr().out
    assert "BARF annealing: frequency bands ramp over steps [0, 20]" in out
    assert "pose refinement: 4 learnable se(3) corrections" in out
    assert float(state.pose_twists.abs().max()) == 0.0
    assert float(state.appearance["gain"][1:].abs().max()) > 0.0
    state = tapp.main(argv)
    out = capsys.readouterr().out
    assert "Reloading from" in out and "000003.ckpt.npz" in out and "Adam moments" not in out
    tw = state.pose_twists.detach()
    assert float(tw[1:].abs().max()) > 0.0 and float(tw[0].abs().max()) == 0.0
    expdir = os.path.join(logdir, "p")
    with np.load(os.path.join(expdir, "000006.ckpt.npz")) as z:
        assert int(z["opt/n_groups"]) == 3
        np.testing.assert_array_equal(z["params/pose_twists"], tw.numpy())
        assert np.abs(z["opt/g2/nu/pose_twists"]).max() > 0
        assert np.abs(z["opt/g0/mu/appearance/gain"]).max() > 0
        assert int(z["opt/g2/count"]) == 6
    tar = torch.load(os.path.join(expdir, "000006.tar"), weights_only=True)
    assert len(tar["optimizer_state_dict"]["state"]) == len(state.parameters())
    # render_only at step 6 of a 20-step ramp: the annealed weights' frame
    outdir, rgbs = tapp.render_only(config_parser().parse_args(
        argv + ["--render_only", "--render_test"]), return_rgbs=True)
    from nerf_shared_tpu_torch.factory import get_renderer
    from nerf_shared_tpu_torch.data.datasets import load_datasets

    args = config_parser().parse_args(argv)
    ds = load_datasets(args)
    models = [(tnerf.anneal_nerf_params(m.params(), m.cfg, 6 / 20), m.cfg)
              for _, m in state.branches()]
    want = get_renderer(args, ds.bds_dict, "cpu").render_from_batch_poses(
        16, 16, ds.K, args.chunk, ds.poses[ds.i_test][:1, :3, :4], *models, retraw=False)
    np.testing.assert_allclose(rgbs[:1], want, rtol=0, atol=1e-6)
    plain = [(m.params(), m.cfg) for _, m in state.branches()]
    unmasked = get_renderer(args, ds.bds_dict, "cpu").render_from_batch_poses(
        16, 16, ds.K, args.chunk, ds.poses[ds.i_test][:1, :3, :4], *plain, retraw=False)
    assert float(np.abs(unmasked - want).max()) > 1e-4


def test_fresh_state_keeps_the_pose_groups():
    """A fresh Adam over the same fields (the triplane upsample's) keeps the
    pose and appearance tensors in their own groups at their own rates,
    with the schedule's count continued (a deliberate difference: the JAX
    fresh_state_at puts them in the net group)."""
    tcfg = tnerf.NeRFConfig(**KW)
    st = create_train_state(tcfg, tcfg, "cpu", n_refine_poses=2, n_appearance=2)
    new = fresh_state_at(st.coarse, st.fine, 5, lrate=5e-4, aux=st.aux, pose_lrate=1e-2,
                         appearance_lrate=2e-3)
    assert {g["label"]: g["base_lr"] for g in new.optimizer.param_groups} == {
        "net": 5e-4, "pose": 1e-2, "appearance": 2e-3}
    assert new.count == new.step == 5 and new.pose_twists is st.pose_twists
