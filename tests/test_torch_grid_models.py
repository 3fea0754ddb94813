"""The grid model families of the port (models/hashgrid.py,
models/triplane.py) on the CPU, against the JAX package.

The same numpy-seeded points go through the JAX functions and the port's,
with the JAX parameters carried over by ``*_params_from_jax`` (never by
equal draws): the hash indices bit for bit against a numpy uint32
transcription, features and raw outputs for every layout to 1e-5 relative
(fp32 in another order: trilinear weights and the corner sum), gradients of
every parameter and of the points against ``jax.grad`` to 1e-4 of each
tensor's largest entry (sums over many points in another order), the
density probe, plane upsampling in both layouts, and the seeded init's
distributions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_shared_tpu.models import hashgrid as jhash
from nerf_shared_tpu.models import triplane as jtri
from nerf_shared_tpu_torch.models import hashgrid as thash
from nerf_shared_tpu_torch.models import triplane as ttri

HASH_KW = dict(L=4, log2_T=8, F=2, base_res=4, max_res=32, hidden=16, geo_feat=7,
               rgb_depth=2, aabb_min=(-1.5,) * 3, aabb_max=(1.5,) * 3)
TRI_KW = dict(G=12, C=4, hidden=16, depth=2, aabb_min=(-1.5,) * 3,
              aabb_max=(1.5,) * 3)


def _pts(shape, seed=0, lim=1.6):
    rng = np.random.default_rng(seed)
    return rng.uniform(-lim, lim, shape + (3,)).astype(np.float32)


def _dirs(n, seed=1):
    d = np.random.default_rng(seed).standard_normal((n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol, atol=atol,
                               err_msg=msg)


def _hash_pair(layout, seed=0, use_viewdirs=True):
    jcfg = jhash.HashGridConfig(layout=layout, use_viewdirs=use_viewdirs, **HASH_KW)
    tcfg = thash.HashGridConfig(layout=layout, use_viewdirs=use_viewdirs, **HASH_KW)
    jp = jax.device_get(jhash.init_hashgrid_params(jax.random.PRNGKey(seed), jcfg))
    # the tables start at +-1e-4; spread them so the encode carries signal
    rng = np.random.default_rng(seed)
    if layout == "split":
        jp["tables"] = [rng.standard_normal(t.shape).astype(np.float32) for t in jp["tables"]]
    else:
        jp["tables"] = rng.standard_normal(jp["tables"].shape).astype(np.float32)
    jp["sigma_net"][1]["w"] = rng.standard_normal(jp["sigma_net"][1]["w"].shape
                                                  ).astype(np.float32) * 0.3
    model = thash.HashGrid(tcfg)
    model.load_state_dict(thash.hashgrid_params_from_jax(jp), strict=True)
    return jcfg, jp, tcfg, model


def _tri_pair(layout, seed=0, use_viewdirs=True):
    jcfg = jtri.TriplaneConfig(layout=layout, use_viewdirs=use_viewdirs, **TRI_KW)
    tcfg = ttri.TriplaneConfig(layout=layout, use_viewdirs=use_viewdirs, **TRI_KW)
    jp = jax.device_get(jtri.init_triplane_params(jax.random.PRNGKey(seed), jcfg))
    model = ttri.Triplane(tcfg)
    model.load_state_dict(ttri.triplane_params_from_jax(jp), strict=True)
    return jcfg, jp, tcfg, model


# --- hashing -----------------------------------------------------------------


@pytest.mark.parametrize("rows", [1 << 14, 1 << 19, 1 << 24])
def test_hash_matches_numpy_uint32(rows):
    """NGP's hash with uint32 wraparound, bit for bit, at coordinates up to
    the top of a 2048 ladder (products near 2^43 before the mask)."""
    rng = np.random.default_rng(rows)
    c = np.concatenate([rng.integers(0, 2049, (4000, 3)),
                        np.array([[2048, 2048, 2048], [2047, 0, 2048], [0, 0, 0]])])
    cu = c.astype(np.uint32)
    with np.errstate(over="ignore"):
        want = ((cu[:, 0] * np.uint32(1)) ^ (cu[:, 1] * np.uint32(2654435761))
                ^ (cu[:, 2] * np.uint32(805459861))) & np.uint32(rows - 1)
    t = torch.from_numpy(c.astype(np.int64))
    got = thash._hash(t[:, 0], t[:, 1], t[:, 2], rows)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def _np_hash(c, rows):
    """NGP's hash in numpy uint32 with wraparound, masked to rows - 1."""
    cu = c.astype(np.uint32)
    with np.errstate(over="ignore"):
        h = ((cu[..., 0] * np.uint32(1)) ^ (cu[..., 1] * np.uint32(2654435761))
             ^ (cu[..., 2] * np.uint32(805459861)))
    return (h & np.uint32(rows - 1)).astype(np.int32)


def _np_hashgrid_indices(cfg, pts):
    """A numpy transcription of the index math of the JAX package's
    hashgrid_features (nerf_shared_tpu/models/hashgrid.py:222): float32
    cell coordinates, int32 direct indices, uint32 hashes."""
    x = pts.reshape(-1, 3).astype(np.float32)
    lo = np.asarray(cfg.aabb_min, np.float32)
    hi = np.asarray(cfg.aabb_max, np.float32)
    u = (x - lo) / (hi - lo)
    res = np.asarray(cfg.resolutions, np.float32)
    xs = u[:, None, :] * res[None, :, None]
    nmax = np.asarray(cfg.resolutions, np.int32) - 1
    x0 = np.clip(np.floor(xs).astype(np.int32), 0, nmax[None, :, None])  # [P, L, 3]
    if cfg.layout == "split":
        out = []
        for lv, (n, rows, hashed) in enumerate(zip(cfg.resolutions, cfg.level_table_rows,
                                                    cfg.level_hashed)):
            c = x0[:, lv]
            out.append(_np_hash(c, rows) if hashed else
                       c[:, 0] + c[:, 1] * n + c[:, 2] * (n * n))
        return out
    use_hash = np.asarray(cfg.level_hashed)
    level_off = np.arange(cfg.L, dtype=np.int32) * cfg.T
    if cfg.layout == "cell":
        stride = np.asarray(cfg.resolutions, np.int32)
        direct = x0[..., 0] + x0[..., 1] * stride + x0[..., 2] * (stride * stride)
        return np.where(use_hash, _np_hash(x0, cfg.T), direct) + level_off
    corners = x0[:, :, None, :] + np.asarray(jhash._CORNERS, np.int32)   # [P, L, 8, 3]
    stride = np.asarray([n + 1 for n in cfg.resolutions], np.int32)[:, None]
    direct = (corners[..., 0] + corners[..., 1] * stride
              + corners[..., 2] * (stride * stride))
    return (np.where(use_hash[:, None], _np_hash(corners, cfg.T), direct)
            + level_off[:, None])


@pytest.mark.parametrize("layout", ["vertex", "cell", "split"])
@pytest.mark.parametrize("kw", [HASH_KW, dict(L=16, log2_T=19, F=2, max_res=2048,
                                              aabb_min=(-4.5,) * 3, aabb_max=(4.5,) * 3),
                                dict(L=8, F=8, log2_T=14, max_res=512,
                                     aabb_min=(-4.5,) * 3, aabb_max=(4.5,) * 3)],
                         ids=["tiny", "L16-F2-T19", "L8-F8-T14"])
def test_hashgrid_indices_match_numpy_uint32_transcription(layout, kw):
    """hashgrid_indices, the rows every encode gathers, bit for bit against
    the JAX index math in numpy, points inside and outside the AABB."""
    cfg = thash.HashGridConfig(layout=layout, **kw)
    pts = _pts((40, 9), seed=7, lim=1.07 * kw["aabb_max"][0])
    got = thash.hashgrid_indices(cfg, torch.from_numpy(pts))
    want = _np_hashgrid_indices(jhash.HashGridConfig(layout=layout, **kw), pts)
    if layout == "split":
        assert len(got) == cfg.L
        for lv, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == torch.int32 and g.shape == (360,)
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"level {lv}")
            assert 0 <= int(g.min()) and int(g.max()) < cfg.level_table_rows[lv]
    else:
        assert got.dtype == torch.int32
        assert got.shape == ((360, cfg.L) if layout == "cell" else (360, cfg.L, 8))
        np.testing.assert_array_equal(got.numpy(), want)
        assert 0 <= int(got.min()) and int(got.max()) < cfg.L * cfg.T


def test_config_properties_match_jax():
    for layout in ("vertex", "cell", "split"):
        for kw in (HASH_KW, dict(L=8, F=8, log2_T=14, max_res=512),
                   dict(L=16, F=2, log2_T=19, max_res=2048)):
            j = jhash.HashGridConfig(layout=layout, **kw)
            t = thash.HashGridConfig(layout=layout, **kw)
            for name in ("T", "resolutions", "level_hashed", "row_width",
                         "level_table_rows", "views_dim"):
                assert getattr(t, name) == getattr(j, name), (layout, name)


# --- hashgrid ------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["vertex", "cell", "split"])
def test_hashgrid_features_match_jax(layout):
    jcfg, jp, tcfg, model = _hash_pair(layout)
    pts = _pts((7, 9), seed=2)
    want = jhash.hashgrid_features(jp, jcfg, jnp.asarray(pts))
    got = thash.hashgrid_features(model.params(), tcfg, torch.from_numpy(pts))
    assert got.shape == (7, 9, tcfg.L * tcfg.F)
    _close(got, want)


@pytest.mark.parametrize("layout", ["vertex", "cell", "split"])
@pytest.mark.parametrize("viewdirs", [True, False])
def test_apply_hashgrid_matches_jax(layout, viewdirs):
    jcfg, jp, tcfg, model = _hash_pair(layout, seed=1, use_viewdirs=viewdirs)
    pts, d = _pts((6, 5), seed=3), _dirs(6)
    jd = jnp.asarray(d) if viewdirs else None
    td = torch.from_numpy(d) if viewdirs else None
    want = jhash.apply_hashgrid(jp, jcfg, jnp.asarray(pts), jd)
    got = model(torch.from_numpy(pts), td)
    assert got.shape == (6, 5, 4)
    _close(got, want)
    _close(thash.get_density(model.params(), tcfg, torch.from_numpy(pts)),
           jhash.get_density(jp, jcfg, jnp.asarray(pts)))


@pytest.mark.parametrize("layout", ["vertex", "cell", "split"])
def test_hashgrid_gradients_match_jax(layout):
    """Every parameter's gradient and d/d pts of sum(raw * cot)."""
    jcfg, jp, tcfg, model = _hash_pair(layout, seed=2)
    pts, d = _pts((5, 8), seed=4, lim=1.4), _dirs(5)
    cot = np.random.default_rng(5).standard_normal((5, 8, 4)).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jhash.apply_hashgrid(p, jcfg, x, jnp.asarray(d)) * cot)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jax.tree_util.tree_map(jnp.asarray, jp),
                                              jnp.asarray(pts))
    x = torch.from_numpy(pts).requires_grad_(True)
    (model(x, torch.from_numpy(d)) * torch.from_numpy(cot)).sum().backward()
    want = thash.hashgrid_params_from_jax(jax.device_get(jg))
    for k, p in model.named_parameters():
        tol = 1e-4 * max(1.0, float(want[k].abs().max()))
        torch.testing.assert_close(p.grad, want[k], rtol=1e-4, atol=tol, msg=k)
    _close(x.grad, jgx, rtol=1e-4, atol=1e-4 * max(1.0, float(np.abs(jgx).max())))


def test_hashgrid_init_distributions():
    """The port's own seeded init: tables in [-1e-4, 1e-4], the sigma
    output layer 1e-2-scaled with a zero bias, so the initial density is
    sigma_bias everywhere (to 1e-3)."""
    cfg = thash.HashGridConfig(layout="split", **HASH_KW)
    m = thash.HashGrid(cfg, generator=torch.Generator().manual_seed(0))
    for t in m.tables:
        assert float(t.abs().max()) <= 1e-4 and float(t.std()) > 1e-5
    assert not m.sigma_net[1].bias.any()
    assert float(m.sigma_net[1].weight.abs().max()) <= 0.01 / np.sqrt(cfg.hidden) + 1e-9
    sigma = thash.get_density(m.params(), cfg, torch.from_numpy(_pts((100,))))
    torch.testing.assert_close(sigma, torch.full_like(sigma, cfg.sigma_bias),
                               rtol=0, atol=1e-3)
    m2 = thash.HashGrid(cfg, generator=torch.Generator().manual_seed(0))
    for (k, a), b in zip(m.named_parameters(), m2.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


def test_hashgrid_rejects_unknown_layout():
    with pytest.raises(ValueError, match="layout"):
        thash.HashGrid(thash.HashGridConfig(layout="dense", **HASH_KW))


# --- triplane ------------------------------------------------------------------


def _np_triplane_indices(cfg, pts):
    """A numpy transcription of the rows the JAX package's
    triplane_features gathers (nerf_shared_tpu/models/triplane.py:109-167),
    offset by p·G·G into the [3·G·G, width] table: [3, 4, ...] vertex
    (``jnp.take(..., mode="clip")`` clips each corner into the plane),
    [3, ...] cell."""
    lo = np.asarray(cfg.aabb_min, np.float32)
    hi = np.asarray(cfg.aabb_max, np.float32)
    G = cfg.G
    u = (pts - lo) / (hi - lo) * np.float32(G)
    planes = []
    for p, (i, j) in enumerate(((0, 1), (0, 2), (1, 2))):
        if cfg.layout == "cell":
            a0 = np.clip(np.floor(u[..., i]).astype(np.int32), 0, G - 1)
            b0 = np.clip(np.floor(u[..., j]).astype(np.int32), 0, G - 1)
            planes.append(a0 * G + b0 + p * G * G)
            continue
        a = np.clip(u[..., i] - np.float32(0.5), 0.0, G - 1.0)
        b = np.clip(u[..., j] - np.float32(0.5), 0.0, G - 1.0)
        a0 = np.clip(np.floor(a).astype(np.int32), 0, G - 2)
        b0 = np.clip(np.floor(b).astype(np.int32), 0, G - 2)
        base = a0 * G + b0
        planes.append(np.stack([np.clip(k, 0, G * G - 1) + p * G * G
                                for k in (base, base + 1, base + G, base + G + 1)]))
    return np.stack(planes)


@pytest.mark.parametrize("layout", ["vertex", "cell"])
def test_triplane_indices_match_numpy_transcription(layout):
    cfg = ttri.TriplaneConfig(layout=layout, **TRI_KW)
    pts = _pts((30, 7), seed=8)
    got = ttri.triplane_indices(cfg, torch.from_numpy(pts))
    assert got.dtype == torch.int32
    assert got.shape == ((3, 4, 30, 7) if layout == "vertex" else (3, 30, 7))
    np.testing.assert_array_equal(got.numpy(), _np_triplane_indices(cfg, pts))
    assert 0 <= int(got.min()) and int(got.max()) < 3 * cfg.G * cfg.G


@pytest.mark.parametrize("layout", ["vertex", "cell"])
def test_triplane_features_match_jax(layout):
    jcfg, jp, tcfg, model = _tri_pair(layout)
    pts = _pts((8, 7), seed=6)
    want = jtri.triplane_features(jp, jcfg, jnp.asarray(pts))
    got = ttri.triplane_features(model.params(), tcfg, torch.from_numpy(pts))
    assert got.shape == (8, 7, tcfg.C)
    _close(got, want)


@pytest.mark.parametrize("layout", ["vertex", "cell"])
@pytest.mark.parametrize("viewdirs", [True, False])
def test_apply_triplane_matches_jax(layout, viewdirs):
    jcfg, jp, tcfg, model = _tri_pair(layout, seed=3, use_viewdirs=viewdirs)
    pts, d = _pts((6, 5), seed=7), _dirs(6, seed=8)
    jd = jnp.asarray(d) if viewdirs else None
    td = torch.from_numpy(d) if viewdirs else None
    _close(model(torch.from_numpy(pts), td),
           jtri.apply_triplane(jp, jcfg, jnp.asarray(pts), jd))
    _close(ttri.get_density(model.params(), tcfg, torch.from_numpy(pts)),
           jtri.get_density(jp, jcfg, jnp.asarray(pts)))


@pytest.mark.parametrize("layout", ["vertex", "cell"])
def test_triplane_gradients_match_jax(layout):
    jcfg, jp, tcfg, model = _tri_pair(layout, seed=4)
    pts, d = _pts((5, 8), seed=9, lim=1.4), _dirs(5, seed=10)
    cot = np.random.default_rng(11).standard_normal((5, 8, 4)).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jtri.apply_triplane(p, jcfg, x, jnp.asarray(d)) * cot)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jax.tree_util.tree_map(jnp.asarray, jp),
                                              jnp.asarray(pts))
    x = torch.from_numpy(pts).requires_grad_(True)
    (model(x, torch.from_numpy(d)) * torch.from_numpy(cot)).sum().backward()
    want = ttri.triplane_params_from_jax(jax.device_get(jg))
    for k, p in model.named_parameters():
        tol = 1e-4 * max(1.0, float(want[k].abs().max()))
        torch.testing.assert_close(p.grad, want[k], rtol=1e-4, atol=tol, msg=k)
    _close(x.grad, jgx, rtol=1e-4, atol=1e-4 * max(1.0, float(np.abs(jgx).max())))


@pytest.mark.parametrize("layout,new_G", [("vertex", 20), ("vertex", 24),
                                          ("cell", 20), ("cell", 17)])
def test_upsample_triplane_matches_jax(layout, new_G):
    """Planes to 1e-5 (vertex: bilinear resize with half-pixel centers;
    cell: the shared-vertex resize through two small matmuls), the decoder
    carried over, and the config at the new G."""
    jcfg, jp, tcfg, model = _tri_pair(layout, seed=5, use_viewdirs=False)
    jnew, jcfg2 = jtri.upsample_triplane(jax.tree_util.tree_map(jnp.asarray, jp),
                                         jcfg, new_G)
    tnew, tcfg2 = ttri.upsample_triplane(model.params(), tcfg, new_G)
    assert tcfg2 == dataclasses.replace(tcfg, G=new_G) and jcfg2.G == new_G
    _close(tnew["planes"], jnew["planes"], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(tnew["sigma.weight"], model.sigma.weight.detach())
    up = ttri.Triplane(tcfg2)
    up.load_state_dict(tnew, strict=True)
    pts = _pts((4, 6), seed=12)
    _close(up(torch.from_numpy(pts)), jtri.apply_triplane(jnew, jcfg2,
                                                          jnp.asarray(pts), None))


def test_triplane_init_distributions():
    cfg = ttri.TriplaneConfig(**TRI_KW)
    m = ttri.Triplane(cfg, generator=torch.Generator().manual_seed(0))
    assert m.planes.shape == (3, cfg.G, cfg.G, cfg.C)
    assert abs(float(m.planes.std()) - 0.05) < 0.005
    bound = 1 / np.sqrt(cfg.C)
    assert float(m.sigma.weight.abs().max()) <= bound
    cell = ttri.Triplane(dataclasses.replace(cfg, layout="cell"))
    assert cell.planes.shape == (3, cfg.G, cfg.G, 4 * cfg.C)
