"""The port's ray / sample / composite / model modules against the JAX
package on the same inputs (CPU, small sizes).

Inputs are made with numpy from a seed and handed to both packages; random
draws are pinned through the ``t_rand`` / ``u`` / ``noise`` seams. Unless a
test says otherwise the tolerance is fp32 round-off of a few chained ops
(atol/rtol 1e-5): both packages evaluate the same formulas in fp32, in
different summation orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_shared_tpu.models import nerf as jnerf
from nerf_shared_tpu.ops import compositing as jcomp
from nerf_shared_tpu.ops import embedding as jemb
from nerf_shared_tpu.ops import rays as jrays
from nerf_shared_tpu.ops import sampling as jsamp
from nerf_shared_tpu.render import renderer as jrender
from nerf_shared_tpu_torch.models import nerf as tnerf
from nerf_shared_tpu_torch.ops import compositing as tcomp
from nerf_shared_tpu_torch.ops import embedding as temb
from nerf_shared_tpu_torch.ops import rays as trays
from nerf_shared_tpu_torch.ops import sampling as tsamp
from nerf_shared_tpu_torch.render import renderer as trender

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(tol or TOL))


@pytest.mark.parametrize("multires,i_embed", [(10, 0), (4, 0), (6, -1)])
def test_embed_matches_jax(multires, i_embed):
    x = np.random.default_rng(0).standard_normal((5, 7, 3)).astype(np.float32)
    jc = jemb.EmbedderConfig(multires=multires, i_embed=i_embed)
    tc = temb.EmbedderConfig(multires=multires, i_embed=i_embed)
    assert tc.out_dim == jc.out_dim
    # sin/cos of arguments up to 2^9·|x|: a few fp32 ulps of ~2000 rad
    _close(temb.embed(_t(x), tc), jemb.embed(jnp.asarray(x), jc),
           atol=2e-4, rtol=0)


def test_get_rays_matches_jax():
    K = np.array([[20.0, 0, 8.0], [0, 21.0, 6.5], [0, 0, 1]])
    c2w = np.random.default_rng(1).standard_normal((3, 4)).astype(np.float32)
    to, td = trays.get_rays(12, 16, K, _t(c2w))
    jo, jd = jrays.get_rays(12, 16, K, jnp.asarray(c2w))
    _close(to, jo)
    _close(td, jd)


def test_ndc_rays_matches_jax():
    rng = np.random.default_rng(2)
    o = rng.standard_normal((9, 3)).astype(np.float32)
    d = rng.standard_normal((9, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    o[:, 2] = -np.abs(o[:, 2]) - 1.5
    to, td = trays.ndc_rays(8, 10, 11.0, 1.0, _t(o), _t(d))
    jo, jd = jrays.ndc_rays(8, 10, 11.0, 1.0, jnp.asarray(o), jnp.asarray(d))
    _close(to, jo, atol=1e-5, rtol=1e-4)
    _close(td, jd, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("lindisp,perturb", [(False, 1.0), (True, 1.0),
                                             (False, 0.0)])
def test_sample_along_rays_matches_jax(lindisp, perturb):
    rng = np.random.default_rng(3)
    near = np.full((6, 1), 2.0, np.float32)
    far = np.full((6, 1), 6.0, np.float32)
    t_rand = rng.random((6, 16)).astype(np.float32)
    got = tsamp.sample_along_rays(_t(near), _t(far), 16, lindisp=lindisp,
                                  perturb=perturb, t_rand=_t(t_rand))
    want = jsamp.sample_along_rays(None, jnp.asarray(near), jnp.asarray(far),
                                   16, lindisp=lindisp, perturb=perturb,
                                   t_rand=jnp.asarray(t_rand))
    _close(got, want)


@pytest.mark.parametrize("det", [False, True])
def test_sample_pdf_matches_jax(det):
    rng = np.random.default_rng(4)
    bins = np.sort(rng.random((7, 24)).astype(np.float32) * 4 + 2, -1)
    w = rng.random((7, 23)).astype(np.float32)
    w[0] = 0.0                      # all-empty ray: the 1e-5 floor only
    w[1, 5] = 50.0                  # one spike: most u land in one bin
    u = None if det else rng.random((7, 16)).astype(np.float32)
    got = tsamp.sample_pdf(_t(bins), _t(w), 16, det=det,
                           u=None if u is None else _t(u))
    want = jsamp.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 16, det=det,
                            u=None if u is None else jnp.asarray(u))
    _close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("white_bkgd,noise_std", [(True, 0.0), (False, 1.0)])
def test_raw2outputs_matches_jax(white_bkgd, noise_std):
    rng = np.random.default_rng(5)
    raw = rng.standard_normal((8, 16, 4)).astype(np.float32) * 3
    z = np.sort(rng.random((8, 16)).astype(np.float32) * 4 + 2, -1)
    rd = rng.standard_normal((8, 3)).astype(np.float32)
    noise = (rng.standard_normal((8, 16)).astype(np.float32) * noise_std
             if noise_std else None)
    got = tcomp.raw2outputs(_t(raw), _t(z), _t(rd), raw_noise_std=noise_std,
                            white_bkgd=white_bkgd,
                            noise=None if noise is None else _t(noise))
    want = jcomp.raw2outputs(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(rd),
                             raw_noise_std=noise_std, white_bkgd=white_bkgd,
                             noise=None if noise is None else jnp.asarray(noise))
    for g, w in zip(got, want):
        _close(g, w, atol=1e-5, rtol=1e-4)


def _models(D=3, W=32, skips=(1,), use_viewdirs=True, multires=6,
            multires_views=3, i_embed=0, output_ch=4, seed=0):
    kw = dict(D=D, W=W, skips=skips, use_viewdirs=use_viewdirs,
              multires=multires, multires_views=multires_views,
              i_embed=i_embed, output_ch=output_ch)
    jcfg = jnerf.NeRFConfig(**kw)
    jp = jnerf.init_nerf_params(jax.random.PRNGKey(seed), jcfg)
    tcfg = tnerf.NeRFConfig(**kw)
    tp = tnerf.params_from_jax(jax.device_get(jp))
    return jcfg, jp, tcfg, tp


@pytest.mark.parametrize("kw", [
    dict(),
    dict(use_viewdirs=False, output_ch=5),
    dict(i_embed=-1),
    dict(D=4, skips=(1, 2), W=48),
])
def test_apply_nerf_matches_jax(kw):
    jcfg, jp, tcfg, tp = _models(**kw)
    rng = np.random.default_rng(6)
    pts = rng.standard_normal((5, 8, 3)).astype(np.float32)
    vd = rng.standard_normal((5, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    use = tcfg.use_viewdirs
    got = tnerf.apply_nerf(tp, tcfg, _t(pts), _t(vd) if use else None)
    want = jnerf.apply_nerf(jp, jcfg, jnp.asarray(pts),
                            jnp.asarray(vd) if use else None)
    assert got.shape == want.shape
    _close(got, want, atol=1e-5, rtol=1e-4)


def test_nerf_module_loads_jax_weights_strict():
    _, jp, tcfg, tp = _models()
    model = tnerf.NeRF(tcfg)
    model.load_state_dict(tp, strict=True)
    assert list(model.state_dict()) == tnerf.torch_param_order(tcfg)


def test_render_rays_matches_jax_with_pinned_draws():
    """The dense hierarchical render_rays (perturbed, sigma noise on) with
    every draw pinned through the overrides seam."""
    jc, jpc, tc, tpc = _models(seed=1)
    _, jpf, _, tpf = _models(seed=2)
    rng = np.random.default_rng(7)
    n, S, Si = 6, 8, 16
    o = rng.standard_normal((n, 3)).astype(np.float32) * 0.1
    d = rng.standard_normal((n, 3)).astype(np.float32)
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((n, 1), 2.0), np.full((n, 1), 6.0), vd],
                          -1).astype(np.float32)
    ov = dict(t_rand=rng.random((n, S)), u=rng.random((n, Si)),
              noise_coarse=rng.standard_normal((n, S)),
              noise_fine=rng.standard_normal((n, S + Si)))
    ov = {k: v.astype(np.float32) for k, v in ov.items()}
    kw = dict(perturb=1.0, N_importance=Si, N_samples=S, use_viewdirs=True,
              white_bkgd=True, raw_noise_std=1.0, near=2.0, far=6.0)
    got = trender.render_rays(tpc, tpf, _t(rays), trender.RenderConfig(**kw),
                              tc, tc, retraw=True, retweights=True,
                              overrides={k: _t(v) for k, v in ov.items()})
    want = jrender.render_rays(jpc, jpf, jnp.asarray(rays), None,
                               jrender.RenderConfig(**kw), jc, jc,
                               retraw=True, retweights=True,
                               overrides={k: jnp.asarray(v) for k, v in ov.items()})
    assert set(got) == set(want)
    for k in want:
        # fine samples go through the inverse CDF of coarse weights, so
        # coarse round-off moves them: 1e-4 relative
        _close(got[k], want[k], atol=1e-4, rtol=1e-4)


def test_raw2outputs_one_sample_per_ray():
    """S = 1: the single sample takes the 1e10 sentinel interval (the JAX
    package returns an empty composite there), matching kernel B4."""
    raw = torch.tensor([[[0.0, 0.0, 0.0, 2.0]], [[1.0, 1.0, 1.0, -1.0]]])
    z = torch.tensor([[3.0], [4.0]])
    rgb, disp, acc, w, depth = tcomp.raw2outputs(raw, z, torch.ones(2, 3))
    torch.testing.assert_close(acc, torch.tensor([1.0, 0.0]))
    torch.testing.assert_close(rgb[0], torch.full((3,), 0.5))
    torch.testing.assert_close(depth, torch.tensor([3.0, 0.0]))
