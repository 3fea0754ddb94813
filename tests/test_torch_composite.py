"""Kernel B5 (ops/cuda/composite.py) on the CPU, against the JAX package.

A CUDA kernel cannot run here, so these tests hold its plain version and
what surrounds the launch:

- the plain version against the JAX Pallas kernel ``composite_fused`` in
  interpret mode, at the JAX kernel test's tolerance (rtol 2e-3, atol 2e-4:
  the Pallas kernel forms transmittance as exp of a log-space matmul, the
  plain version as a cumprod);
- the plain version against the jnp ``raw2outputs`` at 1e-6 (the same
  arithmetic in another framework);
- the S = 1 sentinel, opaque and empty rays;
- the autograd.Function's remat backward against autograd of the plain
  version, the CPU dispatch and the input guards.

The kernel itself is held against the plain version on the card by
chip_smoke.py (phase 2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_shared_tpu.ops.compositing import raw2outputs as j_raw2outputs
from nerf_shared_tpu.ops.pallas.composite import composite_fused as j_composite
from nerf_shared_tpu_torch.ops.cuda import common, composite

NAMES = ("rgb", "disp", "acc", "weights", "depth")


def _case(R, S, seed=0, scale=2.0):
    rng = np.random.default_rng(seed)
    raw = (rng.standard_normal((R, S, 4)) * scale).astype(np.float32)
    z = np.sort(rng.random((R, S)).astype(np.float32) * 4 + 2, -1)
    rd = rng.standard_normal((R, 3)).astype(np.float32)
    return raw, z, rd


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("R,S,white_bkgd", [(64, 24, False), (64, 24, True),
                                            (37, 21, True), (16, 8, False)])
def test_plain_b5_matches_pallas_composite(R, S, white_bkgd):
    raw, z, rd = _case(R, S, seed=S)
    want = j_composite(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(rd),
                       white_bkgd=white_bkgd)
    got = composite.plain_composite(*_t(raw, z, rd), white_bkgd=white_bkgd)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-3,
                                   atol=2e-4, err_msg=name)


@pytest.mark.parametrize("R,S,white_bkgd", [(64, 192, False), (64, 24, True),
                                            (37, 21, True), (5, 2, False)])
def test_plain_b5_matches_jnp_raw2outputs(R, S, white_bkgd):
    """1e-6 absolute (1e-6 relative on disp): the same fp32 formula."""
    raw, z, rd = _case(R, S, seed=R + S)
    want = j_raw2outputs(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(rd),
                         white_bkgd=white_bkgd)
    got = composite.composite_fused(*_t(raw, z, rd), white_bkgd=white_bkgd)
    for name, g, w in zip(NAMES, got, want):
        rtol = 1e-6 if name == "disp" else 0
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=1e-6, err_msg=name)


def test_one_sample_gets_the_sentinel_interval():
    """At S = 1 the single sample's interval is the 1e10 sentinel (the JAX
    kernel gets there through its padding): any positive density is
    opaque, a non-positive one is empty."""
    raw = np.zeros((4, 1, 4), np.float32)
    raw[:, 0, :3] = [[2.0, -1.0, 0.0]] * 4
    raw[:, 0, 3] = [1e-3, 5.0, 0.0, -2.0]
    z = np.full((4, 1), 3.0, np.float32)
    rd = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (4, 1))
    rgb, disp, acc, w, depth = composite.composite_fused(*_t(raw, z, rd),
                                                         white_bkgd=True)
    np.testing.assert_allclose(acc.numpy(), [1, 1, 0, 0], atol=1e-6)
    np.testing.assert_allclose(w.numpy()[:, 0], acc.numpy(), atol=0)
    np.testing.assert_allclose(depth.numpy(), [3, 3, 0, 0], atol=1e-6)
    sig = 1 / (1 + np.exp(-raw[0, 0, :3]))
    np.testing.assert_allclose(rgb.numpy()[:2], [sig, sig], atol=1e-6)
    np.testing.assert_allclose(rgb.numpy()[2:], 1.0, atol=1e-6)
    np.testing.assert_allclose(disp.numpy()[2:], 1e10, rtol=1e-6)
    want = j_composite(*(jnp.asarray(a) for a in (raw, z, rd)), white_bkgd=True)
    np.testing.assert_allclose(acc.numpy(), np.asarray(want[2]), atol=1e-6)


def test_opaque_and_empty_rays():
    R, S = 16, 24
    raw = np.zeros((R, S, 4), np.float32)
    raw[: R // 2, 0, 3] = 1e4       # opaque first sample
    raw[R // 2:, :, 3] = -100.0     # empty rays
    z = np.broadcast_to(np.linspace(2, 6, S), (R, S)).astype(np.float32)
    rd = np.tile(np.array([[0, 0, -1.0]], np.float32), (R, 1))
    rgb, disp, acc, w, depth = composite.composite_fused(*_t(raw, z, rd),
                                                         white_bkgd=True)
    np.testing.assert_allclose(acc.numpy()[: R // 2], 1.0, atol=1e-6)
    np.testing.assert_allclose(depth.numpy()[: R // 2], 2.0, atol=1e-6)
    np.testing.assert_allclose(acc.numpy()[R // 2:], 0.0, atol=1e-6)
    np.testing.assert_allclose(rgb.numpy()[R // 2:], 1.0, atol=1e-6)
    assert np.isfinite(disp.numpy()).all()


def test_remat_backward_matches_plain_autograd(monkeypatch):
    """The autograd.Function's backward (recompute through the plain
    version) against autograd of the plain version. The launch is replaced
    by the plain forward, the one part only the card can run."""
    raw, z, rd = _t(*_case(12, 10, seed=1))
    g = torch.Generator().manual_seed(2)
    cot = [torch.randn(12, 3, generator=g), torch.randn(12, generator=g),
           torch.randn(12, 10, generator=g)]

    def fake_launch(raw, z_vals, rays_d, white_bkgd, want_weights):
        rgb, disp, acc, w, depth = composite.plain_composite(raw, z_vals, rays_d,
                                                             white_bkgd)
        return common.pack8(rgb, disp, acc, depth), w

    monkeypatch.setattr(composite, "_launch", fake_launch)

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in (raw, z, rd)]
        rgb, _, acc, w, _ = fn(*leaves)
        ((rgb * cot[0]).sum() + (acc * cot[1]).sum() + (w * cot[2]).sum()).backward()
        return [t.grad for t in leaves]

    def through_function(r, zz, d):
        out8, w = composite._CompositeFn.apply(True, True, r, zz, d)
        return out8[:, 0:3], out8[:, 3], out8[:, 4], w, out8[:, 5]

    got = grads(through_function)
    want = grads(lambda r, zz, d: composite.plain_composite(r, zz, d, True))
    for name, a, b in zip(("raw", "z", "rays_d"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6, msg=name)


def test_cpu_tensors_take_the_plain_version_and_others_raise():
    raw, z, rd = _t(*_case(5, 8))
    before = composite.LAUNCHES
    out = composite.composite_fused(raw, z, rd, want_weights=False)
    assert out[3].shape == (5, 0) and composite.LAUNCHES == before
    with pytest.raises(ValueError, match="no kernel"):
        composite.composite_fused(raw.to("meta"), z.to("meta"), rd.to("meta"))


def test_launch_guards():
    raw, z, rd = _t(*_case(5, 8))
    with pytest.raises(ValueError, match="raw"):
        composite._check(raw[..., :3].contiguous(), z, rd)
    with pytest.raises(ValueError, match="at least one sample"):
        composite._check(raw[:, :0].contiguous(), z[:, :0].contiguous(), rd)
    with pytest.raises(ValueError, match="contiguous"):
        composite._check(raw, z.t().contiguous().t(), rd)
    with pytest.raises(TypeError):
        composite._check(raw, z, rd.double())
    assert composite._check(raw, z, rd) == (5, 8)
    assert composite.bytes_moved(32768, 192) == 32768 * (192 * 24 + 36)


def test_b5_is_built_with_the_others():
    assert "composite" in common.KERNELS
    src = (common.CSRC / "composite.cu").read_text()
    assert 'extern "C" int nstt_composite(' in src
