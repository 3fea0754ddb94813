"""The port's training slice on the CPU, against the JAX package: the
permutation, the pixel sampler, the learning-rate schedule and Adam, the
loss and its gradients, a three-step trajectory, SSIM, the trainer's
flags, and the CLI (train -> checkpoint -> resume -> render_only).

Random draws never match between jax.random and torch, so every draw is
pinned: the sampler's key words and image index come from JAX's own keys,
and the render's stratified jitter, inverse-CDF u and sigma noise are
numpy-seeded overrides handed to both packages.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_shared_tpu.apps.train import collapse_warning as j_collapse_warning
from nerf_shared_tpu.models import nerf as jnerf
from nerf_shared_tpu.ops.permute import permute_index as j_permute
from nerf_shared_tpu.render.renderer import RenderConfig as JRenderConfig
from nerf_shared_tpu.render.renderer import render_rays as j_render_rays
from nerf_shared_tpu.train import pipeline as jpipe
from nerf_shared_tpu.train.state import create_train_state as j_create_state
from nerf_shared_tpu.train.state import lr_schedule as j_lr_schedule
from nerf_shared_tpu.train.step import nerf_loss as j_nerf_loss
from nerf_shared_tpu.train.step import pack_ray_batch as j_pack
from nerf_shared_tpu.utils.metrics import img2mse as j_img2mse
from nerf_shared_tpu.utils.metrics import ssim as j_ssim
from nerf_shared_tpu_torch.apps import train as tapp
from nerf_shared_tpu_torch.config import config_parser, resolve_fused_backward
from nerf_shared_tpu_torch.models import nerf as tnerf
from nerf_shared_tpu_torch.ops.permute import permute_index
from nerf_shared_tpu_torch.render.renderer import RenderConfig
from nerf_shared_tpu_torch.train import pipeline as tpipe
from nerf_shared_tpu_torch.train.state import TrainState, create_train_state, lr_at
from nerf_shared_tpu_torch.train.step import make_train_step, nerf_loss, pack_ray_batch
from nerf_shared_tpu_torch.utils.metrics import ssim
from tests.test_e2e import _write_config, _write_scene

KW = dict(D=3, W=32, skips=(1,), use_viewdirs=True, multires=4,
          multires_views=2, output_ch=5)


def _key_words(key):
    return torch.from_numpy(np.asarray(jax.random.key_data(key)).astype(np.int64))


# --- ops/permute.py ---------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 5, 1024, 40000, 160000, 2 ** 16 + 3])
def test_permute_index_is_the_jax_permutation_bit_for_bit(n):
    key = jax.random.PRNGKey(n % 97)
    i = np.arange(min(n, 5000))
    want = np.asarray(j_permute(key, jnp.asarray(i), n))
    got = permute_index(_key_words(key), torch.from_numpy(i), n).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist())) == len(got) and got.min() >= 0 and got.max() < n


def test_permute_index_folds_every_key_word():
    """A three-word key (any length) folds as the JAX version folds it."""
    words = np.array([7, 0xFFFFFFFF, 123456789], np.uint32)
    i = np.arange(300)
    want = np.asarray(j_permute(jnp.asarray(words), jnp.asarray(i), 300))
    got = permute_index(torch.from_numpy(words.astype(np.int64)), torch.from_numpy(i), 300)
    np.testing.assert_array_equal(got.numpy(), want)


# --- train/pipeline.py -------------------------------------------------------


def _scene(n=3, H=12, W=10, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.random((n, H, W, 3)).astype(np.float32)
    poses = np.stack([np.eye(4)[:3] + 0.1 * rng.standard_normal((3, 4))
                      for _ in range(n)]).astype(np.float32)
    K = np.array([[11.0, 0, W / 2], [0, 11.5, H / 2], [0, 0, 1]])
    return images, poses, K


@pytest.mark.parametrize("step,N", [(0, 32), (7, 32), (2, 150)])
def test_single_image_sampler_matches_jax(step, N):
    """no_batching: precrop window while step < precrop_iters (5), the full
    image after, N > window (wrapping) included; same key words, same rays
    to 1e-6 (the rotation is a 3x3 product in another order)."""
    images, poses, K = _scene()
    H, W = images.shape[1:3]
    jspec = jpipe.PixelSamplerSpec.from_K(H, W, K, N, single_image=True,
                                          precrop_iters=5, precrop_frac=0.5)
    tspec = tpipe.PixelSamplerSpec.from_K(H, W, K, N, single_image=True,
                                          precrop_iters=5, precrop_frac=0.5)
    key = jax.random.PRNGKey(step + 3)
    ro, rd, tgt = jpipe.sample_ray_batch(key, jnp.asarray(images), jnp.asarray(poses),
                                         jnp.asarray(step), jspec)
    k_img, k_y, k_x = jax.random.split(key, 3)
    draws = {"img_idx": int(jax.random.randint(k_img, (), 0, images.shape[0])),
             "key_y": _key_words(k_y), "key_x": _key_words(k_x)}
    got = tpipe.sample_ray_batch(None, torch.from_numpy(images),
                                 torch.from_numpy(poses), step, tspec, draws)
    for g, w in zip(got, (ro, rd, tgt)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(tgt))


def test_batching_sampler_matches_jax_iid_draws():
    images, poses, K = _scene()
    H, W = images.shape[1:3]
    N = 40
    jspec = jpipe.PixelSamplerSpec.from_K(H, W, K, N, single_image=False)
    key = jax.random.PRNGKey(4)
    want = jpipe.sample_ray_batch(key, jnp.asarray(images), jnp.asarray(poses),
                                  jnp.asarray(0), jspec)
    k_img, k_y, k_x = jax.random.split(key, 3)
    draws = {"img_idx": np.asarray(jax.random.randint(k_img, (N,), 0, 3)),
             "y": np.asarray(jax.random.randint(k_y, (N,), 0, H)),
             "x": np.asarray(jax.random.randint(k_x, (N,), 0, W))}
    got = tpipe.sample_ray_batch(
        None, torch.from_numpy(images), torch.from_numpy(poses), 0,
        tpipe.PixelSamplerSpec.from_K(H, W, K, N, single_image=False), draws)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_exact_epochs_walk_one_permutation_per_epoch():
    """Every pixel of every image exactly once per epoch (a batch may
    straddle the boundary), and epoch e is the JAX permutation keyed by
    fold_in(PRNGKey(0x5EED), e)."""
    n, H, W, N = 2, 4, 5, 7
    total = n * H * W
    spec = tpipe.PixelSamplerSpec(H=H, W=W, fx=1.0, fy=1.0, cx=2.0, cy=2.0,
                                  N_rand=N, single_image=False, exact_epochs=True)
    flat = []
    for step in range(2 * total // N + 1):
        img, y, x = tpipe.sample_pixels(None, n, step, spec)
        flat += (img * H * W + y * W + x).tolist()
    assert sorted(flat[:total]) == list(range(total))
    assert sorted(flat[total:2 * total]) == list(range(total))
    base = jax.random.PRNGKey(0x5EED)
    for e in (0, 1):
        want = np.asarray(j_permute(jax.random.fold_in(base, e), jnp.arange(total), total))
        np.testing.assert_array_equal(flat[e * total:(e + 1) * total], want)


@pytest.mark.parametrize("e", [0, 1, 2, 77, 2 ** 31 - 1])
def test_epoch_key_is_jax_fold_in(e):
    """The port's Threefry-2x32 fold-in gives jax.random's key words bit for
    bit."""
    want = _key_words(jax.random.fold_in(jax.random.PRNGKey(tpipe.EPOCH_SEED), e))
    torch.testing.assert_close(tpipe.epoch_key(e), want, rtol=0, atol=0)


@pytest.mark.parametrize("step", [0, 5, 6])
def test_exact_epochs_sampler_matches_jax(step):
    """Batching with exact_epochs: the same rays as the JAX sampler at steps
    inside an epoch and straddling its end (to 1e-6, the rotation is a 3x3
    product in another order; targets exactly)."""
    images, poses, K = _scene(n=2, H=6, W=5)
    H, W = images.shape[1:3]
    kw = dict(single_image=False, exact_epochs=True)
    want = jpipe.sample_ray_batch(jax.random.PRNGKey(0), jnp.asarray(images),
                                  jnp.asarray(poses), jnp.asarray(step),
                                  jpipe.PixelSamplerSpec.from_K(H, W, K, 11, **kw))
    got = tpipe.sample_ray_batch(None, torch.from_numpy(images), torch.from_numpy(poses),
                                 step, tpipe.PixelSamplerSpec.from_K(H, W, K, 11, **kw))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


# --- train/state.py ----------------------------------------------------------


def _shared_state(lrate=5e-4, lrate_decay=250, fine=True, seed=0):
    jcfg = jnerf.NeRFConfig(**KW)
    jstate = j_create_state(jax.random.PRNGKey(seed), jcfg, jcfg if fine else None,
                            lrate=lrate, lrate_decay=lrate_decay)
    tcfg = tnerf.NeRFConfig(**KW)
    tstate = create_train_state(tcfg, tcfg if fine else None, "cpu", lrate=lrate,
                                lrate_decay=lrate_decay)
    params = jax.device_get(jstate.params)
    with torch.no_grad():
        for branch, m in tstate.branches():
            m.load_state_dict(tnerf.params_from_jax(params[branch]))
    return jcfg, jstate, tcfg, tstate


def _assert_params_match(jparams, tstate, atol, rtol=0.0):
    for branch, m in tstate.branches():
        want = tnerf.params_from_jax(jax.device_get(jparams[branch]))
        for k, v in m.state_dict().items():
            torch.testing.assert_close(v, want[k], rtol=rtol, atol=atol, msg=k)


@pytest.mark.parametrize("count", [0, 1, 777, 250_000, 1_000_000])
def test_lr_schedule_matches_optax(count):
    want = float(j_lr_schedule(5e-4, 250)(count))
    assert lr_at(5e-4, 250, count) == pytest.approx(want, rel=1e-6)


def test_three_adam_updates_match_optax():
    """The same gradients through optax's Adam (the JAX TrainState) and
    torch's: a fast decay (10x per 2 updates) also checks that lr is read
    at the count before each update. Tolerance 1e-7 + 1e-5 relative: the
    two evaluate m̂ / (sqrt(v̂) + eps) with roundings in other places."""
    jcfg, jstate, tcfg, tstate = _shared_state(lrate=1e-2, lrate_decay=0.002)
    rng = np.random.default_rng(1)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)),
            jstate.params)
        jstate = jstate.apply_gradients(grads)
        for branch, m in tstate.branches():
            g = tnerf.params_from_jax(jax.device_get(grads[branch]))
            for k, p in m.named_parameters():
                p.grad = g[k].clone()
        tstate.apply_gradients()
    assert tstate.count == 3 == int(jstate.step)
    _assert_params_match(jstate.params, tstate, atol=1e-7, rtol=1e-5)


@pytest.mark.parametrize("kw,match", [(dict(n_refine_poses=1, n_appearance=1), "A11"),
                                      (dict(n_refine_poses=3), "A11"),
                                      (dict(n_appearance=3), "A11")])
def test_unported_parameter_groups_raise(kw, match):
    cfg = tnerf.NeRFConfig(**KW)
    with pytest.raises(NotImplementedError, match=match):
        create_train_state(cfg, None, "cpu", **kw)


# --- train/step.py -----------------------------------------------------------


def _batch(N=24, seed=2):
    rng = np.random.default_rng(seed)
    ro = (rng.standard_normal((N, 3)) * 0.1 + [0, 0, 4]).astype(np.float32)
    rd = rng.standard_normal((N, 3)).astype(np.float32) * 0.3 + [0, 0, -1]
    rd = rd.astype(np.float32)
    target = rng.random((N, 3)).astype(np.float32)
    return ro, rd, target


def _rcfgs(**kw):
    base = dict(N_samples=8, N_importance=8, use_viewdirs=True, white_bkgd=True,
                near=2.0, far=6.0)
    base.update(kw)
    return JRenderConfig(**base), RenderConfig(**base)


def _overrides(N, S, Ni, seed=3, noise=False):
    rng = np.random.default_rng(seed)
    ov = {"t_rand": rng.random((N, S)).astype(np.float32),
          "u": rng.random((N, Ni)).astype(np.float32)}
    if noise:
        ov["noise_coarse"] = rng.standard_normal((N, S)).astype(np.float32)
        ov["noise_fine"] = rng.standard_normal((N, S + Ni)).astype(np.float32)
    return ov


def _torch_grads(tstate):
    return {b: {k: p.grad for k, p in m.named_parameters()} for b, m in tstate.branches()}


def _assert_grads_match(jgrads, tgrads, tol=1e-4):
    for branch, g in tgrads.items():
        want = tnerf.params_from_jax(jax.device_get(jgrads[branch]))
        for k, v in g.items():
            w = want[k]
            torch.testing.assert_close(v, w, rtol=tol,
                                       atol=tol * max(1.0, float(w.abs().max())), msg=k)


def test_nerf_loss_and_gradients_match_jax_deterministic():
    """perturb 0 and no sigma noise: the JAX nerf_loss draws nothing, so it
    runs as it is, with the density-sparsity term on. Loss to 1e-5
    relative, gradients to 1e-4 of each tensor's max."""
    jcfg, jstate, tcfg, tstate = _shared_state()
    jr, tr = _rcfgs(perturb=0.0)
    ro, rd, target = _batch()
    jb = j_pack(jnp.asarray(ro), jnp.asarray(rd), jr, 8, 8, 10.0)
    (jl, jaux), jg = jax.value_and_grad(j_nerf_loss, has_aux=True)(
        jstate.params, jb, jnp.asarray(target), jax.random.PRNGKey(0), jr, jcfg,
        jcfg, acc_reg=0.01)
    tb = pack_ray_batch(torch.from_numpy(ro), torch.from_numpy(rd), tr, 8, 8, 10.0)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-6)
    params = {b: m.params() for b, m in tstate.branches()}
    tl, taux = nerf_loss(params, tb, torch.from_numpy(target), tr, tcfg, tcfg,
                         acc_reg=0.01)
    tl.backward()
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    for k in ("psnr", "psnr0", "img_loss", "img_loss0", "acc_mean"):
        assert float(taux[k]) == pytest.approx(float(jaux[k]), rel=1e-5), k
    _assert_grads_match(jg, _torch_grads(tstate))


def _j_pinned_loss(rcfg, ccfg, fcfg, ov):
    """The JAX nerf_loss's arithmetic with its draws pinned (its own
    signature has no overrides seam): render_rays with overrides, fine +
    coarse MSE."""
    ov = {k: jnp.asarray(v) for k, v in ov.items()}

    def loss(params, batch, target):
        ret = j_render_rays(params["coarse"], params["fine"], batch,
                            jax.random.PRNGKey(0), rcfg, ccfg, fcfg, overrides=ov)
        return j_img2mse(ret["rgb_map"], target) + j_img2mse(ret["rgb0"], target)

    return loss


def test_nerf_loss_and_gradients_match_jax_with_pinned_draws():
    """perturb 1 and sigma noise 1, with t_rand, u and both noise draws
    pinned: loss to 1e-5 relative, gradients to 1e-4 of each max."""
    jcfg, jstate, tcfg, tstate = _shared_state(seed=5)
    jr, tr = _rcfgs(perturb=1.0, raw_noise_std=1.0)
    ro, rd, target = _batch(seed=6)
    ov = _overrides(24, 8, 8, noise=True)
    jb = j_pack(jnp.asarray(ro), jnp.asarray(rd), jr, 8, 8, 10.0)
    jl, jg = jax.value_and_grad(_j_pinned_loss(jr, jcfg, jcfg, ov))(
        jstate.params, jb, jnp.asarray(target))
    tb = pack_ray_batch(torch.from_numpy(ro), torch.from_numpy(rd), tr, 8, 8, 10.0)
    params = {b: m.params() for b, m in tstate.branches()}
    tl, _ = nerf_loss(params, tb, torch.from_numpy(target), tr, tcfg, tcfg,
                      overrides={k: torch.from_numpy(v) for k, v in ov.items()})
    tl.backward()
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    _assert_grads_match(jg, _torch_grads(tstate))


def test_three_step_trajectory_matches_jax():
    """Three iterations from shared weights: JAX's sampler on its keys,
    the loss with pinned draws, optax's Adam; the port's train_step with
    the same key words and draws. Parameters after each step to 1e-6
    absolute (lr 5e-4; the gradients differ in the last fp32 digits),
    except entries whose gradient has come within 100 eps (1e-6) of zero
    without being zero (3.6% of them here): there Adam's g / (|g| + eps) amplifies
    those digits, and such an entry may differ by up to 2 lr per step."""
    jcfg, jstate, tcfg, tstate = _shared_state(seed=7)
    jr, tr = _rcfgs(perturb=1.0)
    images, poses, K = _scene(n=3, H=8, W=8, seed=4)
    jspec = jpipe.PixelSamplerSpec.from_K(8, 8, K, 16, single_image=True,
                                          precrop_iters=2, precrop_frac=0.5)
    tspec = tpipe.PixelSamplerSpec.from_K(8, 8, K, 16, single_image=True,
                                          precrop_iters=2, precrop_frac=0.5)
    step_fn = make_train_step(tr, tcfg, tcfg, tspec)
    fragile = {}
    for i in range(3):
        key = jax.random.PRNGKey(100 + i)
        ov = _overrides(16, 8, 8, seed=i)
        ro, rd, tgt = jpipe.sample_ray_batch(key, jnp.asarray(images),
                                             jnp.asarray(poses), jstate.step, jspec)
        jb = j_pack(ro, rd, jr, 8, 8, float(K[0, 0]))
        grads = jax.grad(_j_pinned_loss(jr, jcfg, jcfg, ov))(jstate.params, jb, tgt)
        jstate = jstate.apply_gradients(grads)
        k_img, k_y, k_x = jax.random.split(key, 3)
        draws = {"img_idx": int(jax.random.randint(k_img, (), 0, 3)),
                 "key_y": _key_words(k_y), "key_x": _key_words(k_x)}
        step_fn(tstate, torch.from_numpy(images), torch.from_numpy(poses),
                torch.Generator().manual_seed(i), draws=draws,
                overrides={k: torch.from_numpy(v) for k, v in ov.items()})
        for branch, m in tstate.branches():
            want = tnerf.params_from_jax(jax.device_get(jstate.params[branch]))
            jg = tnerf.params_from_jax(jax.device_get(grads[branch]))
            for k, v in m.state_dict().items():
                f = fragile.get((branch, k), torch.zeros_like(v, dtype=torch.bool))
                f = fragile[(branch, k)] = f | ((jg[k].abs() < 1e-6) & (jg[k] != 0))
                d = (v - want[k]).abs()
                assert float(d[~f].max()) <= 1e-6, (i, branch, k)
                assert float(d.max()) <= 2 * 5e-4 * (i + 1), (i, branch, k)
    assert tstate.step == tstate.count == 3


def test_step_options_not_ported_raise():
    tcfg = tnerf.NeRFConfig(**KW)
    _, tr = _rcfgs()
    spec = tpipe.PixelSamplerSpec(H=4, W=4, fx=1, fy=1, cx=2, cy=2, N_rand=4)
    for opt in ("dist_reg", "barf_end", "pose_twists", "appearance", "loss_sampling"):
        with pytest.raises(NotImplementedError):
            make_train_step(tr, tcfg, tcfg, spec, **{opt: 1})
    with pytest.raises(NotImplementedError, match="distortion"):
        nerf_loss({"coarse": {}}, torch.zeros(1, 11), torch.zeros(1, 3), tr, tcfg,
                  tcfg, dist_reg=0.1)


# --- utils/metrics.py --------------------------------------------------------


@pytest.mark.parametrize("shape", [(20, 24, 3), (8, 9, 3), (16, 16)])
def test_ssim_matches_jax(shape):
    """Tolerance 1e-5: the same separable filter, sums in another order."""
    rng = np.random.default_rng(len(shape))
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    assert float(ssim(a, b)) == pytest.approx(float(j_ssim(a, b)), abs=1e-5)
    assert float(ssim(a, a)) == pytest.approx(1.0, abs=1e-5)


# --- config and the trainer --------------------------------------------------


def test_fused_backward_resolves_on_for_the_mlp_family_on_cuda():
    args = config_parser().parse_args([])
    assert resolve_fused_backward(args, "cuda") is True
    assert resolve_fused_backward(args, "cuda:0") is True
    assert resolve_fused_backward(args, "cpu") is False
    args = config_parser().parse_args(["--fused_backward", "false"])
    assert resolve_fused_backward(args, "cuda") is False
    args = config_parser().parse_args(["--model_type", "triplane"])
    assert resolve_fused_backward(args, "cuda") is False
    help_text = config_parser().format_help()
    assert "TPU only" not in help_text and "Pallas" not in help_text.split(
        "--fused_backward")[1].split("--remat")[0]


@pytest.mark.parametrize("flag", [["--train_occ", "True"], ["--refine_poses", "True"],
                                  ["--appearance", "True"], ["--loss_sampling", "True"],
                                  ["--distortion_loss_weight", "0.01"]])
def test_training_flags_not_ported_raise(flag):
    args = config_parser().parse_args(["--device", "cpu"] + flag)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tapp.train(args)


@pytest.mark.parametrize("last,psnr,warned", [(2100, 8.0, False), (2100, 12.0, False),
                                              (900, 8.0, False), (2100, 8.0, True),
                                              (40_000, 8.0, False)])
def test_collapse_warning_matches_jax(last, psnr, warned):
    args = config_parser().parse_args(["--white_bkgd", "--precrop_iters", "500"])
    got = tapp.collapse_warning(last, psnr, args, warned)
    want = j_collapse_warning(last, psnr, args, warned)
    assert got == want


def test_cli_trains_checkpoints_resumes_and_renders(tmp_path, capsys):
    """train -> .tar + .ckpt.npz with Adam state -> resume (Reloading, the
    Adam count and lr continue) -> render_only, on the CPU."""
    root = str(tmp_path)
    datadir, logdir = os.path.join(root, "scene"), os.path.join(root, "logs")
    os.makedirs(datadir)
    _write_scene(datadir)
    cfg = _write_config(root, datadir, logdir, expname="cli", N_iters=6, i_print=3,
                        i_weights=6, i_testset=6, i_img=3, i_video=6)
    argv = ["--config", cfg, "--device", "cpu"]
    state = tapp.main(argv)
    out = capsys.readouterr().out
    assert out.count("[TRAIN]") == 2 and out.count("[VAL]") == 2
    assert "mp4/gif export is not ported" in out
    expdir = os.path.join(logdir, "cli")
    assert {"000006.tar", "000006.ckpt.npz", "args.txt", "config.txt",
            "testset_000006", "video_000006"} <= set(os.listdir(expdir))
    tar = torch.load(os.path.join(expdir, "000006.tar"), weights_only=True)
    assert int(tar["optimizer_state_dict"]["state"][0]["step"]) == 6
    with np.load(os.path.join(expdir, "000006.ckpt.npz")) as z:
        assert int(z["opt/count"]) == 6 and np.abs(z["opt/nu/coarse/pts_linears/0/w"]).max() > 0
    assert state.count == state.step == 6

    resumed = tapp.main(argv + ["--N_iters", "9"])
    out = capsys.readouterr().out
    assert "Reloading from" in out and "000006.tar" in out
    assert resumed.count == resumed.step == 9
    assert resumed.optimizer.param_groups[0]["lr"] == pytest.approx(
        lr_at(resumed.lrate, resumed.lrate_decay, 8))

    outdir, rgbs = tapp.render_only(config_parser().parse_args(
        argv + ["--render_only", "--render_test", "--N_iters", "9"]), return_rgbs=True)
    assert outdir.endswith("renderonly_test_000009")
    assert rgbs.shape == (2, 16, 16, 3) and np.isfinite(rgbs).all()
    assert sorted(os.listdir(outdir)) == ["000.png", "001.png"]


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = config_parser().parse_args(["--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapp.train(args)


def test_train_state_orders_parameters_as_the_tar_indexes_them():
    cfg = tnerf.NeRFConfig(**KW)
    state = TrainState(tnerf.NeRF(cfg), tnerf.NeRF(cfg), 5e-4, 250)
    names = [n for _, m in state.branches() for n in tnerf.torch_param_order(m.cfg)]
    assert len(state.parameters()) == len(names) == 2 * len(tnerf.torch_param_order(cfg))
    assert all(a is b for a, b in zip(
        state.parameters(), list(state.coarse.parameters()) + list(state.fine.parameters())))


def test_fused_backward_seam_on_cpu_is_the_plain_network():
    """RenderConfig.fused_backward routes the networks through
    fused_train_op, which on CPU tensors is apply_nerf: loss and gradients
    equal the plain render's exactly."""
    _, _, tcfg, tstate = _shared_state(seed=3)
    ro, rd, target = _batch(seed=8)
    ov = {k: torch.from_numpy(v) for k, v in _overrides(24, 8, 8).items()}
    results = []
    for fused in (False, True):
        _, tr = _rcfgs(perturb=1.0, fused_backward=fused)
        tb = pack_ray_batch(torch.from_numpy(ro), torch.from_numpy(rd), tr, 8, 8, 10.0)
        tstate.optimizer.zero_grad(set_to_none=True)
        loss, _ = nerf_loss({b: m.params() for b, m in tstate.branches()}, tb,
                            torch.from_numpy(target), tr, tcfg, tcfg, overrides=ov)
        loss.backward()
        results.append((float(loss), [p.grad.clone() for p in tstate.parameters()]))
    assert results[0][0] == results[1][0]
    for a, b in zip(results[0][1], results[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cli_trains_in_batching_mode_with_exact_epochs(tmp_path, capsys):
    root = str(tmp_path)
    datadir, logdir = os.path.join(root, "scene"), os.path.join(root, "logs")
    os.makedirs(datadir)
    _write_scene(datadir)
    cfg = _write_config(root, datadir, logdir, expname="batch", N_iters=4, i_print=2,
                        i_weights=0, i_testset=0, i_img=0, i_video=0)
    with open(cfg) as f:
        text = f.read().replace("no_batching = True", "no_batching = False")
    with open(cfg, "w") as f:
        f.write(text)
    state = tapp.main(["--config", cfg, "--device", "cpu", "--exact_epochs", "True",
                       "--ckpt_format", "native"])
    out = capsys.readouterr().out
    assert out.count("[TRAIN]") == 2 and state.step == 4
    assert sorted(os.listdir(os.path.join(logdir, "batch"))) == [
        "000004.ckpt.npz", "args.txt", "config.txt"]
