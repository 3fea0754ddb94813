"""The plain reference (portbench/reference/nerf.py) against the measured
program's plain path, at small sizes on the CPU, on the same seeded inputs.
The test imports both; the reference imports nothing of the program."""

import numpy as np
import pytest
import torch

from nerf_shared_tpu_torch.models.nerf import NeRFConfig, apply_nerf
from nerf_shared_tpu_torch.ops.compositing import raw2outputs
from nerf_shared_tpu_torch.ops.embedding import EmbedderConfig, embed
from nerf_shared_tpu_torch.ops.rays import get_rays, ndc_rays
from nerf_shared_tpu_torch.ops.sampling import sample_along_rays, sample_pdf
from nerf_shared_tpu_torch.train.pipeline import PixelSamplerSpec, pixel_rays, sample_pixels
from nerf_shared_tpu_torch.train.state import create_train_state
from portbench.core import inputs
from portbench.reference import nerf as ref

NET = {"depth": 8, "width": 32, "skips": (4,), "multires": 10, "multires_views": 4}
CFG = NeRFConfig(D=8, W=32, skips=(4,), use_viewdirs=True, multires=10, multires_views=4,
                 output_ch=5)
SCENE = {"H": 12, "W": 16, "focal": 14.0, "K": [[14.0, 0, 8.0], [0, 14.0, 6.0], [0, 0, 1]],
         "N_rand": 48, "single_image": True, "precrop_iters": 10, "precrop_frac": 0.5}


def _weights(seed=3):
    cfg = {"flags": {"netdepth": 8, "netwidth": 32, "multires": 10, "multires_views": 4},
           "dataset": {"density_box": [[-1.0] * 3, [1.0] * 3], "density_mean": 0.3}}
    return inputs.make_weights(seed, cfg, "cpu")


def test_encoding_matches():
    x = torch.randn(7, 3, generator=torch.Generator().manual_seed(0))
    for n in (4, 10):
        assert torch.equal(ref.encode(x, n), embed(x, EmbedderConfig(multires=n)))


def test_network_matches():
    w = _weights()["fine"]
    g = torch.Generator().manual_seed(1)
    pts, dirs = torch.randn(5, 9, 3, generator=g), torch.randn(5, 3, generator=g)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    torch.testing.assert_close(ref.mlp(w, NET, pts, dirs), apply_nerf(w, CFG, pts, dirs),
                               rtol=0, atol=1e-6)


def test_rays_match():
    c2w = torch.as_tensor(inputs.orbit_pose(30.0, -40.0, 4.0)[:3, :4], dtype=torch.float32)
    o, d = ref.frame_rays(SCENE["H"], SCENE["W"], SCENE["K"], c2w)
    po, pd = get_rays(SCENE["H"], SCENE["W"], np.array(SCENE["K"]), c2w)
    torch.testing.assert_close(o, po.reshape(-1, 3), rtol=0, atol=0)
    torch.testing.assert_close(d, pd.reshape(-1, 3), rtol=1e-6, atol=1e-7)
    no, nd = ref.ndc(SCENE["H"], SCENE["W"], SCENE["focal"], 1.0, o, d)
    po, pd = ndc_rays(SCENE["H"], SCENE["W"], SCENE["focal"], 1.0, o, d)
    torch.testing.assert_close(no, po, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(nd, pd, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("perturb", [False, True])
def test_sampling_matches(perturb):
    n = 6
    near, far = torch.full((n, 1), 2.0), torch.full((n, 1), 6.0)
    z = ref.stratified(n, 2.0, 6.0, 16, perturb, torch.Generator().manual_seed(4), "cpu")
    pz = sample_along_rays(near, far, 16, perturb=1.0 if perturb else 0.0,
                           generator=torch.Generator().manual_seed(4))
    assert torch.equal(z, pz)
    w = torch.rand(n, 14, generator=torch.Generator().manual_seed(5))
    bins = 0.5 * (z[:, 1:] + z[:, :-1])
    a = ref.inverse_cdf(bins, w, 24, not perturb, torch.Generator().manual_seed(6))
    b = sample_pdf(bins, w, 24, det=not perturb, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a, b)


@pytest.mark.parametrize("noise,white", [(0.0, True), (1.0, False)])
def test_composite_matches(noise, white):
    g = torch.Generator().manual_seed(7)
    raw, d = torch.randn(5, 11, 4, generator=g), torch.randn(5, 3, generator=g)
    z = torch.sort(torch.rand(5, 11, generator=g), dim=-1).values
    rgb, w = ref.composite(raw, z, d, noise, white, torch.Generator().manual_seed(8))
    prgb, _, _, pw, _ = raw2outputs(raw, z, d, raw_noise_std=noise, white_bkgd=white,
                                    generator=torch.Generator().manual_seed(8))
    torch.testing.assert_close(rgb, prgb, rtol=0, atol=1e-6)
    torch.testing.assert_close(w, pw, rtol=0, atol=1e-6)


@pytest.mark.parametrize("single,step", [(True, 0), (True, 50), (False, 0)])
def test_pixel_draws_and_rays_match(single, step):
    scene = dict(SCENE, single_image=single)
    spec = PixelSamplerSpec.from_K(scene["H"], scene["W"], scene["K"], scene["N_rand"],
                                   single_image=single, precrop_iters=scene["precrop_iters"],
                                   precrop_frac=scene["precrop_frac"])
    ours = ref.draw_pixels(torch.Generator().manual_seed(9), 5, step, scene)
    theirs = sample_pixels(torch.Generator().manual_seed(9), 5, step, spec)
    for a, b in zip(ours, theirs):
        assert torch.equal(a, b)
    images = torch.rand(5, scene["H"], scene["W"], 3, generator=torch.Generator().manual_seed(1))
    poses = torch.stack([torch.as_tensor(inputs.orbit_pose(36.0 * i, -30.0, 4.0)[:3, :4],
                                         dtype=torch.float32) for i in range(5)])
    for a, b in zip(ref.step_rays(images, poses, scene, *ours),
                    pixel_rays(images, poses, spec, *theirs)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_adam_matches():
    w = _weights()
    state = create_train_state(CFG, CFG, "cpu", lrate=5e-4, lrate_decay=250)
    for b, m in state.branches():
        with torch.no_grad():
            for k, p in m.named_parameters():
                p.copy_(w[b][k])
    mine = {(b, k): t.clone() for b in w for k, t in w[b].items()}
    opt = ref.Adam(mine, 5e-4, 250)
    g = torch.Generator().manual_seed(2)
    for _ in range(3):
        grads = {k: torch.randn(t.shape, generator=g) for k, t in mine.items()}
        for (b, k), p in state.named_parameters().items():
            p.grad = grads[(b, k)].clone()
        state.apply_gradients()
        opt.update(mine, grads)
    for key, p in state.named_parameters().items():
        torch.testing.assert_close(mine[key], p.detach(), rtol=0, atol=1e-7)
