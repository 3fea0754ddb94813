"""The port's mesh export on the CPU, against the JAX package: marching
tetrahedra on analytic fields, the port's own native cell scan against its
numpy scan (built into a temporary directory), the density probe of an MLP
and a hashgrid, vertex normals, density-gradient normals and baked colours,
the NDC unwarp of points and normals, the OBJ / PLY writers byte for byte,
and the mesh CLI end to end against JAX's on one checkpoint (blender and
an NDC scene with ``--mesh_world``).

The JAX side runs its numpy scan (its native library is never built here:
``native="never"``, or ``available`` patched off for its CLI) and its plain
network path.
"""

import argparse
import os

import jax
import numpy as np
import pytest

from nerf_shared_tpu.apps import mesh_cli as jmesh_cli
from nerf_shared_tpu.models import hashgrid as jhash
from nerf_shared_tpu.models import nerf as jnerf
from nerf_shared_tpu.ops import meshing as JM
from nerf_shared_tpu.ops import native_meshing as jnative
from nerf_shared_tpu.render.renderer import RenderConfig as JRenderConfig
from nerf_shared_tpu_torch.apps import mesh_cli as tmesh_cli
from nerf_shared_tpu_torch.apps import train as tapp
from nerf_shared_tpu_torch.config import config_parser
from nerf_shared_tpu_torch.models import hashgrid as thash
from nerf_shared_tpu_torch.models import nerf as tnerf
from nerf_shared_tpu_torch.models.nerf import params_tree_from_jax
from nerf_shared_tpu_torch.ops import meshing as TM
from nerf_shared_tpu_torch.ops import native_meshing as tnative
from nerf_shared_tpu_torch.parallel.distributed import World
from nerf_shared_tpu_torch.render.renderer import RenderConfig
from tests.test_e2e import _write_config, _write_llff_scene, _write_scene
from tests.test_torch_grid_train import HASH_KW

MLP_KW = dict(D=4, W=64, skips=(2,), use_viewdirs=True, multires=4,
              multires_views=2, output_ch=5)


def _sphere(n=25, radius=0.7, center=(0.0, 0.0, 0.0)):
    ax = np.linspace(-1, 1, n)
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1)
    vals = (radius - np.linalg.norm(g - np.asarray(center), axis=-1)).astype(np.float32)
    return vals, (-1.0, -1.0, -1.0), (2.0 / (n - 1),) * 3


def _slab(n=17):
    x = np.linspace(-1, 1, n, dtype=np.float32)
    vals = np.broadcast_to((0.3 - np.abs(x))[:, None, None], (n, n, n)).copy()
    vals += 0.05 * np.sin(np.arange(n, dtype=np.float32))[None, :, None]
    return vals, (10.0, 0.0, -2.0), (0.5, 1.0, 2.0)


def _canon(f):
    """A face set as sorted rows, each rolled to start at its smallest
    index (winding kept)."""
    roll = np.argmin(f, axis=1)
    rows = np.stack([f[np.arange(len(f)), (roll + k) % 3] for k in range(3)], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def _edge_use_counts(verts, faces):
    e = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]), 1)
    _, counts = np.unique(e[:, 0].astype(np.int64) * len(verts) + e[:, 1],
                          return_counts=True)
    return counts


@pytest.mark.parametrize("field,iso,slab", [("sphere", 0.0, 4), ("sphere", 0.2, 64),
                                            ("slab", 0.1, 64), ("slab", 0.0, 3)])
def test_marching_tetrahedra_matches_jax(field, iso, slab):
    """The numpy scan: the same faces in the same order, vertices to 1e-6;
    the port's default scan (native here) the same face set; the sphere
    watertight."""
    vals, origin, spacing = _sphere() if field == "sphere" else _slab()
    jv, jf = JM.marching_tetrahedra(vals, iso, origin, spacing, slab=slab, native="never")
    tv, tf = TM.marching_tetrahedra(vals, iso, origin, spacing, slab=slab, native="never")
    assert len(jf) > 100
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-6)
    av, af = TM.marching_tetrahedra(vals, iso, origin, spacing)
    np.testing.assert_array_equal(av, tv)
    np.testing.assert_array_equal(_canon(af), _canon(tf))
    if field == "sphere":
        assert set(np.unique(_edge_use_counts(tv, tf))) == {2}


def test_native_scan_is_bit_equal_to_the_numpy_scan(tmp_path):
    """The port's C++ scan, built from csrc/host/meshing.cpp into a
    temporary directory, against its numpy scan on a random field (all 16
    tet cases, a lattice value exactly at iso): the same (lo, hi) edge
    multiset, so the same vertices and face set bit for bit."""
    rng = np.random.default_rng(7)
    vals = rng.normal(0, 1, (13, 11, 17)).astype(np.float32)
    vals[3, 4, 5] = 0.0
    path = tnative.build(tmp_path)
    assert path.parent == tmp_path and path.name.startswith("libmeshing-")
    lo_n, hi_n = tnative.mt_scan(vals, 0.0, build_dir=tmp_path)
    lo_p, hi_p = TM._numpy_scan(vals, 0.0, 64)
    assert len(lo_n) == len(lo_p) > 0
    tri_n = np.stack([lo_n, hi_n], -1).reshape(-1, 3, 2)
    tri_p = np.stack([lo_p, hi_p], -1).reshape(-1, 3, 2)
    key = lambda t: sorted(map(lambda x: tuple(x.ravel()), t))  # noqa: E731
    assert key(tri_n) == key(tri_p)
    vn, fn = TM._dedup_and_interp(lo_n, hi_n, vals, 0.0, (0, 0, 0), (1, 1, 1))
    vp, fp = TM._dedup_and_interp(lo_p, hi_p, vals, 0.0, (0, 0, 0), (1, 1, 1))
    np.testing.assert_array_equal(vn, vp)
    np.testing.assert_array_equal(_canon(fn), _canon(fp))
    with pytest.raises(ValueError, match="native="):
        TM.scan_route("sometimes")


def _mlp(seed=0):
    jcfg, tcfg = jnerf.NeRFConfig(**MLP_KW), tnerf.NeRFConfig(**MLP_KW)
    jp = jax.device_get(jnerf.init_nerf_params(jax.random.PRNGKey(seed), jcfg))
    return jcfg, jp, tcfg, tnerf.params_from_jax(jp)


def _hashgrid(seed=0):
    jcfg, tcfg = jhash.HashGridConfig(**HASH_KW), thash.HashGridConfig(**HASH_KW)
    jp = jax.device_get(jhash.init_hashgrid_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    jp["tables"] = [rng.standard_normal(t.shape).astype(np.float32) for t in jp["tables"]]
    return jcfg, jp, tcfg, params_tree_from_jax(jp)


@pytest.mark.parametrize("family", ["mlp", "hashgrid"])
def test_probe_density_grid_matches_jax(family):
    """R 16 in blocks of 1000 points (a padded tail): raw sigma to 1e-5
    relative."""
    jcfg, jp, tcfg, tp = (_mlp if family == "mlp" else _hashgrid)(3)
    lo, hi = np.array([-1.2, -1.0, -0.8], np.float32), np.array([1.0, 1.1, 1.3], np.float32)
    want = JM.probe_density_grid(jp, jcfg, JRenderConfig(), lo, hi, resolution=16, block=1000)
    got = TM.probe_density_grid(tp, tcfg, RenderConfig(), lo, hi, resolution=16, block=1000)
    assert got.shape == want.shape == (17, 17, 17) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(want).max()))
    # the sharded probe over one process is the unsharded probe (worlds of
    # 2 and 3: tests/test_torch_parallel_render.py)
    one = World(0, 1, "cpu", False)
    assert np.array_equal(TM.probe_density_grid(tp, tcfg, RenderConfig(), lo, hi,
                                                resolution=16, block=1000, mesh=one), got)


def test_normals_and_colors_match_jax():
    """On a sphere mesh: area-weighted vertex normals to 1e-5, the density
    gradient normals (unit length) to 1e-4 where |grad sigma| is not tiny,
    and the baked colours along face and gradient normals to 1e-5."""
    vals, origin, spacing = _sphere(n=13, radius=0.5)
    verts, faces = JM.marching_tetrahedra(vals, 0.0, origin, spacing, native="never")
    np.testing.assert_allclose(TM.vertex_normals(verts, faces),
                               JM.vertex_normals(verts, faces), rtol=0, atol=1e-5)
    jcfg, jp, tcfg, tp = _mlp(4)
    jr, tr = JRenderConfig(), RenderConfig()
    jn = JM.density_gradient_normals(jp, jcfg, jr, verts, block=100)
    tn = TM.density_gradient_normals(tp, tcfg, tr, verts, block=100)
    np.testing.assert_allclose(np.linalg.norm(tn, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(tn, jn, rtol=0, atol=1e-4)
    for normals in (None, tn):
        want = JM.vertex_colors(jp, jcfg, jr, verts, faces, block=100,
                                normals=None if normals is None else jn)
        got = TM.vertex_colors(tp, tcfg, tr, verts, faces, block=100, normals=normals)
        assert got.shape == (len(verts), 3) and (got >= 0).all() and (got <= 1).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert TM.vertex_colors(tp, tcfg, tr, verts[:0], faces[:0]).shape == (0, 3)
    assert TM.density_gradient_normals(tp, tcfg, tr, verts[:0]).shape == (0, 3)


def test_ndc_unwarp_matches_jax():
    rng = np.random.default_rng(1)
    q = rng.uniform(-0.9, 0.999, (200, 3)).astype(np.float32)
    n = rng.standard_normal((200, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    for z_clip in (0.999, 0.5):
        np.testing.assert_array_equal(TM.ndc_points_to_world(q, 14, 10, 16.0, z_clip=z_clip),
                                      JM.ndc_points_to_world(q, 14, 10, 16.0, z_clip=z_clip))
        np.testing.assert_array_equal(
            TM.ndc_normals_to_world(q, n, 14, 10, 16.0, z_clip=z_clip),
            JM.ndc_normals_to_world(q, n, 14, 10, 16.0, z_clip=z_clip))


@pytest.mark.parametrize("colors,normals", [(False, False), (True, False), (False, True),
                                            (True, True)])
def test_obj_and_ply_are_byte_identical_to_jax(tmp_path, colors, normals):
    vals, origin, spacing = _sphere(n=9)
    verts, faces = JM.marching_tetrahedra(vals, 0.0, origin, spacing, native="never")
    rng = np.random.default_rng(2)
    c = rng.random((len(verts), 3)).astype(np.float32) if colors else None
    nrm = JM.vertex_normals(verts, faces) if normals else None
    for ext in ("obj", "ply"):
        a, b = str(tmp_path / f"j.{ext}"), str(tmp_path / f"t.{ext}")
        JM.save_mesh(a, verts, faces, c, nrm)
        TM.save_mesh(b, verts, faces, c, nrm)
        assert open(a, "rb").read() == open(b, "rb").read()
    with pytest.raises(ValueError, match="unsupported mesh format"):
        TM.save_mesh(str(tmp_path / "x.stl"), verts, faces)


def _read_obj(path):
    v, f = [], []
    for line in open(path):
        if line.startswith("v "):
            v.append([float(x) for x in line.split()[1:]])
        elif line.startswith("f "):
            f.append([int(x.split("/")[0]) - 1 for x in line.split()[1:]])
    return np.array(v, np.float32), np.array(f, np.int64)


def test_mesh_cli_matches_jax_on_one_checkpoint(tmp_path, monkeypatch, capsys):
    """The port trains a tiny blender scene (.tar only); both mesh CLIs
    export it with colours and gradient normals: the same face count and
    faces, vertices, colours and normals within 1e-4; the port logs its
    scan; --mesh_shape 2 without a launcher raises saying how to launch it
    (two ranks: tests/test_torch_parallel_render.py)."""
    monkeypatch.setattr(jnative, "available", lambda: False)
    root = str(tmp_path)
    datadir = os.path.join(root, "scene")
    os.makedirs(datadir)
    _write_scene(datadir, size=16, n_train=4)
    cfg = _write_config(root, datadir, os.path.join(root, "logs"), N_iters=120,
                        i_print=40, i_weights=120, N_rand=128, ckpt_format="tar")
    tapp.main(["--config", cfg, "--device", "cpu"])
    flags = ["--mesh_res", "24", "--mesh_iso", "1.0", "--mesh_color", "--mesh_normals",
             "grad"]
    jpath, jv, jf = jmesh_cli.main(["--config", cfg, "--mesh_out",
                                    os.path.join(root, "j.obj")] + flags)
    capsys.readouterr()
    tpath, tv, tf = tmesh_cli.main(["--config", cfg, "--device", "cpu", "--mesh_out",
                                    os.path.join(root, "t.obj")] + flags)
    out = capsys.readouterr().out
    assert "cell scan: native" in out and "Reloading from" in out and "000120.tar" in out
    assert len(tf) == len(jf) > 100
    np.testing.assert_array_equal(_canon(tf), _canon(jf))
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-4)
    rv, rf = _read_obj(tpath)
    jrv, _ = _read_obj(jpath)
    np.testing.assert_array_equal(rf, tf)
    np.testing.assert_allclose(rv, jrv, rtol=0, atol=1e-4)
    assert set(np.unique(_edge_use_counts(tv, tf))) == {2}
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        tmesh_cli.main(["--config", cfg, "--device", "cpu", "--mesh_shape", "2"] + flags)


def test_mesh_cli_ndc_world_matches_jax(tmp_path, monkeypatch, capsys):
    """An LLFF (NDC) scene trained by the port, exported by both CLIs with
    --mesh_world --mesh_color: the same world-space vertices (1e-4) and
    flipped faces; every vertex in front of the cameras (z < 0). The iso
    level is the median of the port's own probe of the field."""
    monkeypatch.setattr(jnative, "available", lambda: False)
    root = str(tmp_path)
    datadir = _write_llff_scene(root)
    cfg = os.path.join(root, "llff.txt")
    with open(cfg, "w") as fh:
        fh.write("\n".join([
            "expname = llff_mesh", f"basedir = {os.path.join(root, 'logs')}",
            f"datadir = {datadir}", "dataset_type = llff", "training = True",
            "factor = 1", "llffhold = 3", "use_viewdirs = True", "N_samples = 8",
            "N_importance = 8", "N_rand = 64", "netdepth = 2", "netwidth = 32",
            "netdepth_fine = 2", "netwidth_fine = 32", "multires = 4",
            "multires_views = 2", "N_iters = 16", "i_print = 8", "i_weights = 16",
            "i_testset = 0", "i_img = 0", "i_video = 0", "ckpt_format = tar"]) + "\n")
    tapp.main(["--config", cfg, "--device", "cpu"])
    eng = tapp.build_eval_engine(config_parser().parse_args(["--config", cfg, "--device",
                                                             "cpu"]))
    lo, hi = tmesh_cli.mesh_aabb(argparse.Namespace(mesh_aabb=0.0), eng.renderer, eng.ds,
                                 eng.H, eng.W)
    sigma = TM.probe_density_grid(eng.fine.params(), eng.fcfg, eng.renderer.cfg, lo, hi,
                                  resolution=16)
    flags = ["--mesh_res", "16", "--mesh_iso", f"{float(np.median(sigma)):.6f}",
             "--mesh_world", "--mesh_color"]
    _, jv, jf = jmesh_cli.main(["--config", cfg, "--mesh_out",
                                os.path.join(root, "j.ply")] + flags)
    _, tv, tf = tmesh_cli.main(["--config", cfg, "--device", "cpu", "--mesh_out",
                                os.path.join(root, "t.ply")] + flags)
    out = capsys.readouterr().out
    assert out.count("unwarped NDC mesh to world coordinates") == 2
    assert len(tf) == len(jf) > 0
    np.testing.assert_array_equal(_canon(tf), _canon(jf))
    # world coordinates reach ~20 near the z' = 0.999 clip: 1e-4 relative
    np.testing.assert_allclose(tv, jv, rtol=1e-4, atol=1e-4)
    assert np.isfinite(tv).all() and (tv[:, 2] < 0).all()
