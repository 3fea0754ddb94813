"""The port's kernel modules (B3: ops/cuda/fused_mlp.py, B4:
ops/cuda/fused_render.py) on the CPU.

A CUDA kernel cannot run here, so these tests hold what surrounds it:

- the plain versions against the JAX package's Pallas kernels, run as the
  JAX suite runs them on the CPU (interpret mode);
- the CPU dispatch (a CPU tensor takes the plain version, other devices
  raise) and the remat backward of the plain path;
- the ray-major encoder's arguments and the shape / device / dtype guards
  (the tensor-core pack and its arithmetic: tests/test_torch_tc_mlp.py).

The kernels themselves are held against the plain versions on the card by
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_shared_tpu.models import nerf as jnerf
from nerf_shared_tpu.ops.pallas.fused_mlp import fused_nerf_forward_rays as j_b3
from nerf_shared_tpu.ops.pallas.fused_render import fused_render_rays as j_b4
from nerf_shared_tpu_torch.models import nerf as tnerf
from nerf_shared_tpu_torch.ops.cuda import common, fused_mlp, fused_render


def _models(D=3, W=32, skips=(1,), use_viewdirs=True, multires=6,
            multires_views=3, i_embed=0, output_ch=4, seed=0):
    kw = dict(D=D, W=W, skips=skips, use_viewdirs=use_viewdirs,
              multires=multires, multires_views=multires_views,
              i_embed=i_embed, output_ch=output_ch)
    jcfg = jnerf.NeRFConfig(**kw)
    jp = jnerf.init_nerf_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jp, tnerf.NeRFConfig(**kw), tnerf.params_from_jax(
        jax.device_get(jp))


def _rays(n=21, S=16, seed=3):
    rng = np.random.default_rng(seed)
    ro = rng.standard_normal((n, 3)).astype(np.float32) * 0.1
    rd = rng.standard_normal((n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, -1, keepdims=True)
    z = np.sort((rng.random((n, S)) * 4 + 2).astype(np.float32), -1)
    return ro, rd, z


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("use_vd,S", [(True, 8), (True, 16), (False, 16),
                                      (True, 24)])
def test_plain_b3_matches_pallas_ray_kernel(use_vd, S):
    """Tolerance 1e-4: the Pallas kernel builds cos as sin(x + π/2) from a
    matmul-formed argument, the plain version takes cos of f·(o + z·d)."""
    jcfg, jp, tcfg, tp = _models(use_viewdirs=use_vd)
    ro, rd, z = _rays(S=S)
    vd = rd if use_vd else None
    want = j_b3(jp, jcfg, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z),
                None if vd is None else jnp.asarray(vd))
    got = fused_mlp.plain_nerf_forward_rays(tp, tcfg, _t(ro), _t(rd), _t(z),
                                            _t(vd))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def _sentinel_mask(tp, tcfg, ro, rd, z, vd):
    """Rays whose last-sample |sigma| >= 1e-2: elsewhere the 1e10 sentinel
    interval flips alpha between any two fp32-valid evaluations."""
    raw = fused_mlp.plain_nerf_forward_rays(tp, tcfg, _t(ro), _t(rd), _t(z),
                                            _t(vd))
    return np.abs(raw[:, -1, 3].numpy()) >= 1e-2


@pytest.mark.parametrize("white_bkgd,S", [(True, 8), (False, 24)])
def test_plain_b4_matches_pallas_render_kernel(white_bkgd, S):
    """Tolerance 1e-4 on masked rays: the Pallas kernel forms transmittance
    as exp of a log-space matmul, the plain version as a cumprod."""
    jcfg, jp, tcfg, tp = _models(seed=4)
    ro, rd, z = _rays(n=40, S=S, seed=5)
    want = j_b4(jp, jcfg, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z),
                jnp.asarray(rd), white_bkgd=white_bkgd, want_weights=True)
    got = fused_render.plain_render_rays(tp, tcfg, _t(ro), _t(rd), _t(z),
                                         _t(rd), white_bkgd=white_bkgd)
    mask = _sentinel_mask(tp, tcfg, ro, rd, z, rd)
    assert mask.sum() >= 20
    for name, g, w in zip(("rgb", "disp", "acc", "weights", "depth"), got, want):
        np.testing.assert_allclose(g.numpy()[mask], np.asarray(w)[mask],
                                   atol=1e-4, rtol=1e-4, err_msg=name)


def test_cpu_tensors_take_the_plain_versions():
    _, _, tcfg, tp = _models()
    ro, rd, z = _rays(n=5, S=8)
    before = (fused_mlp.LAUNCHES, fused_render.LAUNCHES)
    raw = fused_mlp.fused_nerf_forward_rays(tp, tcfg, _t(ro), _t(rd), _t(z),
                                            _t(rd))
    torch.testing.assert_close(raw, fused_mlp.plain_nerf_forward_rays(
        tp, tcfg, _t(ro), _t(rd), _t(z), _t(rd)), rtol=0, atol=0)
    out = fused_render.fused_render_rays(tp, tcfg, _t(ro), _t(rd), _t(z),
                                         _t(rd), want_weights=False)
    assert out[3].shape == (5, 0)
    assert (fused_mlp.LAUNCHES, fused_render.LAUNCHES) == before


def test_other_devices_raise():
    _, _, tcfg, tp = _models()
    ro, rd, z = (t.to("meta") for t in map(_t, _rays(n=5, S=8)))
    with pytest.raises(ValueError, match="no kernel"):
        fused_mlp.fused_nerf_forward_rays(tp, tcfg, ro, rd, z, rd)
    with pytest.raises(ValueError, match="no kernel"):
        fused_render.fused_render_rays(tp, tcfg, ro, rd, z, rd)


def test_plain_path_gradients_reach_params_and_rays():
    _, _, tcfg, tp = _models()
    tp = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    ro, rd, z = (t.requires_grad_(True) for t in map(_t, _rays(n=4, S=8)))
    rgb = fused_render.fused_render_rays(tp, tcfg, ro, rd, z,
                                         rd.detach())[0]
    rgb.sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in tp.values())
    assert ro.grad is not None and rd.grad is not None


# --- the encoder and the guards -------------------------------------------


def test_encoder_arguments_are_exact_for_power_of_two_frequencies():
    """A + z·B rounds exactly like f·(o + z·d) does when f = 2^k, so the
    kernel feeds sin/cos the plain version's arguments bit for bit."""
    _, _, tcfg, _ = _models(multires=10, multires_views=4)
    ro, rd, z = map(_t, _rays(n=7, S=5))
    A, B = fused_mlp.ray_encoder_args(tcfg, ro, rd, rd)
    src, scale, _ = fused_mlp.encoder_tables(tcfg)
    P = tcfg.input_ch
    pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
    arg = A[:, None, :P] + z[..., None] * B[:, None, :P]
    want = pts[..., src[:P]] * torch.from_numpy(scale[:P])
    torch.testing.assert_close(arg, want, rtol=0, atol=0)


@pytest.mark.parametrize("kw,match", [
    (dict(W=300), "widths"),
    (dict(D=40), "layers"),
    (dict(multires=30, multires_views=20), "embedding"),
    (dict(use_viewdirs=False, output_ch=9), "output channels"),
    (dict(D=3, skips=(2,)), "skip"),
])
def test_check_config_refuses_what_the_kernel_cannot_take(kw, match):
    cfg = tnerf.NeRFConfig(**{**dict(D=3, W=32, skips=(1,)), **kw})
    with pytest.raises(ValueError, match=match):
        fused_mlp.check_config(cfg)


def test_check_tensor_guards():
    t = torch.zeros(4, 3)
    common.check_tensor(t, "x", (4, 3), t.device)
    with pytest.raises(TypeError):
        common.check_tensor(t.double(), "x", (4, 3), t.device)
    with pytest.raises(ValueError, match="shape"):
        common.check_tensor(t, "x", (4, 2), t.device)
    with pytest.raises(ValueError, match="contiguous"):
        common.check_tensor(torch.zeros(3, 4).t(), "x", (4, 3), t.device)


def test_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build raises (the CPU path never builds)."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(common, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        common.build(["fused_mlp"])


def test_pack_refuses_params_that_do_not_match_the_config():
    _, _, tcfg, tp = _models()
    bad = dict(tp)
    bad["pts_linears.1.weight"] = torch.zeros(32, 31)
    with pytest.raises(ValueError, match="pts_linears.1.weight"):
        fused_mlp.pack_network_tc(bad, tcfg, "cpu")
    bad = dict(tp)
    bad["rgb_linear.bias"] = bad["rgb_linear.bias"].double()
    with pytest.raises(ValueError, match="rgb_linear.bias"):
        fused_mlp.pack_network_tc(bad, tcfg, "cpu")
    assert set(fused_mlp.param_shapes(tcfg)) == set(tp)
