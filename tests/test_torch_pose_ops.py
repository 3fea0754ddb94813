"""The port's pose building blocks against the JAX package on the CPU:
se(3) (skew, the screw transform, the exponential and its gradient at
identity), BARF's frequency weights and parameter-space annealing (with
square and non-square layers), the pose twists and the appearance
correction. Inputs come from numpy seeds; tolerances are stated per test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_shared_tpu.models import nerf as jnerf
from nerf_shared_tpu.ops import se3 as jse3
from nerf_shared_tpu.train import appearance as japp
from nerf_shared_tpu.train import pose_refine as jpr
from nerf_shared_tpu_torch.models import nerf as tnerf
from nerf_shared_tpu_torch.ops import se3 as tse3
from nerf_shared_tpu_torch.train import appearance as tapp
from nerf_shared_tpu_torch.train import pose_refine as tpr


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# --- ops/se3.py ---------------------------------------------------------------


def _twists(seed=0, n=8, scale=0.7):
    return (np.random.default_rng(seed).standard_normal((n, 6)) * scale).astype(np.float32)


# |w| = 0, far below the guard, just below and just above it, and the guard
_THETAS = [0.0, 1e-6, 1e-4 - 1e-6, 1e-4, 1e-4 + 1e-6, 0.3, 2.5]


def _twist_at(theta, seed):
    rng = np.random.default_rng(seed)
    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    return np.concatenate([rng.standard_normal(3), theta * axis]).astype(np.float32)


def test_skew_matches_jax():
    for v in np.random.default_rng(1).standard_normal((5, 3)).astype(np.float32):
        np.testing.assert_array_equal(tse3.skew(_t(v)).numpy(), np.asarray(jse3.skew(jnp.asarray(v))))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_screw_transform_matches_jax(seed):
    """Tolerance 1e-6 absolute (fp32 3x3 products in another order)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(3).astype(np.float32)
    w /= np.linalg.norm(w)
    v = rng.standard_normal(3).astype(np.float32)
    for theta in (np.float32(0.0), np.float32(1e-6), np.float32(rng.random() * 3)):
        want = np.asarray(jse3.screw_transform(jnp.asarray(w), jnp.asarray(v), jnp.asarray(theta)))
        got = tse3.screw_transform(_t(w), _t(v), torch.tensor(theta)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("theta", _THETAS)
def test_exp_se3_matches_jax_around_the_taylor_guard(theta):
    """Both sides of θ = 1e-4 and far away; tolerance 1e-6 absolute."""
    tw = _twist_at(theta, seed=int(theta * 1e7) % 97)
    want = np.asarray(jse3.exp_se3(jnp.asarray(tw)))
    got = tse3.exp_se3(_t(tw)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_exp_se3_batched_matches_jax_vmap():
    tw = _twists(3)
    want = np.asarray(jax.vmap(jse3.exp_se3)(jnp.asarray(tw)))
    np.testing.assert_allclose(tse3.exp_se3(_t(tw)).numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("theta", [0.0, 1e-6, 1e-4 + 1e-6, 0.4])
def test_exp_se3_gradient_is_finite_and_matches_jax(theta):
    """The gradient of a fixed linear read-out of exp(twist), at identity
    (θ = 0, where every pose twist starts) and around the guard: finite,
    and within 1e-6 of JAX's."""
    tw = _twist_at(theta, seed=5) if theta else np.zeros(6, np.float32)
    probe = np.random.default_rng(9).standard_normal((4, 4)).astype(np.float32)
    want = np.asarray(jax.grad(lambda x: jnp.sum(jse3.exp_se3(x) * probe))(jnp.asarray(tw)))
    x = _t(tw).requires_grad_(True)
    (tse3.exp_se3(x) * _t(probe)).sum().backward()
    assert torch.isfinite(x.grad).all()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=0, atol=1e-6)


# --- BARF (models/nerf.py) -----------------------------------------------------


@pytest.mark.parametrize("progress", [0.0, 0.3, 0.5, 1.0, 2.5 / 6])
def test_barf_freq_weights_match_jax(progress):
    for n in (4, 6, 10):
        want = np.asarray(jnerf.barf_freq_weights(jnp.asarray(progress, jnp.float32), n))
        got = tnerf.barf_freq_weights(torch.tensor(progress, dtype=torch.float32), n)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)
        # a Python float (the eval hooks' progress) as JAX takes one: the
        # product with n_freqs in double, then float32
        want = np.asarray(jnerf.barf_freq_weights(progress, n))
        np.testing.assert_allclose(tnerf.barf_freq_weights(progress, n).numpy(), want,
                                   rtol=0, atol=1e-7)


# D2 / W32 with a skip into the second layer (square hidden layers) and a
# width where every layer's input and output differ (the lego layout's
# non-square [W + input_ch] skip successor and views layer)
_ARCHS = {"d2w32": dict(D=2, W=32, skips=(0,), multires=4, multires_views=2),
          "d4w24": dict(D=4, W=24, skips=(1,), multires=5, multires_views=3)}


def _shared_params(arch, seed=0):
    jcfg = jnerf.NeRFConfig(output_ch=5, **_ARCHS[arch])
    jp = jax.device_get(jnerf.init_nerf_params(jax.random.PRNGKey(seed), jcfg))
    tcfg = tnerf.NeRFConfig(output_ch=5, **_ARCHS[arch])
    return jcfg, jp, tcfg, tnerf.params_from_jax(jp)


@pytest.mark.parametrize("arch", sorted(_ARCHS))
@pytest.mark.parametrize("progress", [0.0, 0.3, 0.5, 1.0])
def test_anneal_nerf_params_matches_jax(arch, progress):
    """Every annealed weight against the JAX package's (transposed):
    tolerance 1e-7. A mask applied to rows instead of columns fails here:
    at d4w24 no annealed layer is square."""
    jcfg, jp, tcfg, sd = _shared_params(arch)
    want = tnerf.params_from_jax(jnerf.anneal_nerf_params(
        jp, jcfg, jnp.asarray(progress, jnp.float32)))
    got = tnerf.anneal_nerf_params(sd, tcfg, torch.tensor(progress))
    assert list(got) == list(want)
    changed = 0
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-7, msg=k)
        changed += int(not torch.equal(got[k], sd[k]))
    assert changed == (0 if progress == 1.0 else 3)


@pytest.mark.parametrize("arch", sorted(_ARCHS))
def test_parameter_scaling_equals_input_masking_and_masks_gradients(arch):
    """The annealed forward equals the plain MLP on the masked encoding
    (1e-6), and a band still closed gets exactly zero gradient in the
    stored weights' columns."""
    _, _, tcfg, sd = _shared_params(arch, seed=3)
    progress = 0.3
    mp = tnerf._anneal_channel_mask(tcfg.pts_embedder, progress)
    mv = tnerf._anneal_channel_mask(tcfg.views_embedder, progress)
    rng = np.random.default_rng(4)
    pts = _t(rng.standard_normal((6, 5, 3)))
    dirs = _t(rng.standard_normal((6, 3)))
    params = {k: v.clone().requires_grad_(True) for k, v in sd.items()}
    out = tnerf.apply_nerf(tnerf.anneal_nerf_params(params, tcfg, progress), tcfg, pts, dirs)
    from nerf_shared_tpu_torch.ops.embedding import embed

    emb = torch.cat([embed(pts, tcfg.pts_embedder) * mp,
                     embed(dirs[:, None].expand(pts.shape), tcfg.views_embedder) * mv], -1)
    torch.testing.assert_close(out, tnerf.apply_mlp(sd, tcfg, emb), rtol=0, atol=1e-6)
    out.square().sum().backward()
    closed = mp == 0
    assert bool(closed.any())
    assert float(params["pts_linears.0.weight"].grad[:, closed].abs().max()) == 0.0
    assert float(params["pts_linears.0.weight"].grad[:, ~closed].abs().max()) > 0.0
    vclosed = torch.cat([torch.zeros(tcfg.W, dtype=torch.bool), mv == 0])
    assert float(params["views_linears.0.weight"].grad[:, vclosed].abs().max()) == 0.0


# --- train/pose_refine.py, train/appearance.py -------------------------------------


@pytest.mark.parametrize("rows", [3, 4])
def test_apply_pose_twists_matches_jax(rows):
    """[N, 3, 4] and [N, 4, 4] poses; tolerance 1e-6 absolute."""
    rng = np.random.default_rng(rows)
    poses = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    poses[:, :3, :4] += rng.standard_normal((5, 3, 4)).astype(np.float32) * 0.5
    poses = poses[:, :rows]
    tw = _twists(rows, n=5, scale=0.2)
    tw[0] = 0.0
    want = np.asarray(jpr.apply_pose_twists(jnp.asarray(tw), jnp.asarray(poses)))
    got = tpr.apply_pose_twists(_t(tw), _t(poses)).numpy()
    assert got.shape == poses.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0], poses[0], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tpr.init_pose_twists(4).numpy(),
                                  np.asarray(jpr.init_pose_twists(4)))


def test_appearance_matches_jax():
    """init, the image-0 anchor and the per-ray correction with per-ray and
    one-for-all indices; tolerance 1e-6 absolute."""
    rng = np.random.default_rng(7)
    app = {k: rng.standard_normal((4, 3)).astype(np.float32) * 0.3 for k in ("gain", "offset")}
    rgb = rng.random((9, 3)).astype(np.float32)
    japp_a = japp.anchor_appearance({k: jnp.asarray(v) for k, v in app.items()})
    tapp_a = tapp.anchor_appearance({k: _t(v) for k, v in app.items()})
    for k in app:
        np.testing.assert_array_equal(tapp_a[k].numpy(), np.asarray(japp_a[k]))
        np.testing.assert_array_equal(tapp.init_appearance(4)[k].numpy(),
                                      np.asarray(japp.init_appearance(4)[k]))
    for idx in (rng.integers(0, 4, 9), np.asarray(2)):
        want = np.asarray(japp.apply_appearance(japp_a, jnp.asarray(idx), jnp.asarray(rgb)))
        got = tapp.apply_appearance(tapp_a, torch.as_tensor(idx), _t(rgb)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
