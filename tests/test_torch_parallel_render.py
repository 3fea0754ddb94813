"""Sharded renders and export over torch.distributed on the CPU
(parallel/render.py, render/froxels.make_sharded_render_froxel, the
sharded ops/meshing.probe_density_grid, parallel/tensor.py, and the render
and export entry points under --mesh_shape), against the JAX package's
sharded functions on the virtual CPU devices of tests/conftest.py.

- World sizes 2 and 3: gloo processes spawned with a ``file://`` store, as
  tests/test_torch_parallel.py spawns them, one world a size for every case.
  ``make_sharded_render``, ``make_sharded_pose_render``,
  ``make_sharded_render_occ``, ``make_sharded_render_froxel`` and the
  sharded probe against JAX's on ``make_mesh((n,))`` (100 rays and a 10x10
  frame, neither a multiple of 3; eval semantics, where no draw is made):
  maps to 1e-5 absolute and 1e-4 relative, the probe to 1e-5 of max(1,
  max|sigma|). Every rank holds the whole result.
- ``make_tp_apply`` at t = 2 (world 2) and on a (data 2, model 2) mesh
  (world 4) against JAX's on the matching mesh, with and without viewdirs,
  to 1e-5; ``tp_shard_params`` holds 1/t of each wide matrix.
- World size 1 (a gloo group of one in this process): each sharded
  function is the unsharded path bit for bit, and the eval engine built
  under the world is "sharded-dense" and renders the plain engine's frame.
- The entry points on two spawned ranks: render_only writes the
  single-process frames as PNGs (rank 0 alone writes), the eval CLI
  reports once, the mesh CLI writes the single-process mesh file byte for
  byte, the service answers /render on rank 0 with the single-process
  frame and its follower stops with it, and a --mesh_shape 2 trainer's
  i_testset hook writes the single-process hook's frames.

Weights cross from JAX through ``models/nerf.params_from_jax``. This module
imports no JAX at its top: ``python -m tests.test_torch_parallel_render
<job>`` is the spawned rank.
"""

import io
import json
import os
import pickle
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

from nerf_shared_tpu_torch.models import nerf as tnerf
from nerf_shared_tpu_torch.parallel import distributed
from nerf_shared_tpu_torch.parallel.mesh import make_groups
from nerf_shared_tpu_torch.parallel.render import (
    make_sharded_pose_render,
    make_sharded_render,
    make_sharded_render_occ,
)
from nerf_shared_tpu_torch.parallel.tensor import make_tp_apply, tp_param_specs, tp_shard_params
from nerf_shared_tpu_torch.render import froxels as TF
from nerf_shared_tpu_torch.render import occupancy as TO
from nerf_shared_tpu_torch.render.renderer import RenderConfig, Renderer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MLP_KW = dict(D=3, W=32, skips=(1,), use_viewdirs=True, multires=4, multires_views=2)
NOVD_KW = dict(D=2, W=32, skips=(0,), use_viewdirs=False, multires=4, output_ch=4)
RC = dict(N_samples=8, N_importance=8, near=2.0, far=6.0, perturb=0.0, white_bkgd=True)
H = W = 10
N_RAYS, BLOCK = 100, 16
OCC_KW = dict(n_candidates=24, n_keep=12, select="sort", n_fine=4)
FRO_KW = dict(tile=4, n_keep=4, n_fine=0)
N_DEPTH, PROBE_RES, PROBE_BLOCK = 16, 8, 50
MAPS = ("rgb_map", "disp_map", "acc_map")
K_CAM = np.array([[12.0, 0, W / 2], [0, 12.0, H / 2], [0, 0, 1]])


def _c2w():
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[2, 3] = 4.0
    return c2w


def _rays(n=N_RAYS, seed=7):
    rng = np.random.default_rng(seed)
    ro = rng.standard_normal((n, 3)).astype(np.float32) * 2.0
    rd = rng.standard_normal((n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return np.concatenate([ro, rd, np.full((n, 1), 2, np.float32),
                           np.full((n, 1), 6, np.float32), rd], -1)


def _grid_arrays(G=8, p=0.3, lo=-6.0, hi=6.0, seed=8):
    rng = np.random.default_rng(seed)
    bits = rng.random((G, G, G)) < p
    sigma = (rng.random((G, G, G)) * 3).astype(np.float32) * bits
    return bits, np.full(3, lo, np.float32), np.full(3, hi, np.float32), sigma


def _port_grid(arrays):
    return TO.OccupancyGrid(*(torch.from_numpy(a) for a in arrays))


def _port_froxels(grid):
    return TF.build_froxels(grid, H, W, K_CAM, torch.from_numpy(_c2w()), RC["near"],
                            RC["far"], n_depth=N_DEPTH, tile=FRO_KW["tile"],
                            n_keep=FRO_KW["n_keep"])


def _np(out):
    return {k: v.numpy() for k, v in out.items()}


# --- the port's side (the spawned ranks run this) ------------------------------------


def port_fns(job, world):
    """Every sharded function of this slice on this rank's world: the maps
    of each, as numpy."""
    cfg = tnerf.NeRFConfig(**MLP_KW)
    pc, pf = job["params"]["coarse"], job["params"]["fine"]
    rc = RenderConfig(**RC)
    rays = torch.from_numpy(job["rays"])
    grid = _port_grid(job["grid"])
    out = {
        "render": _np(make_sharded_render(world, rc, cfg, cfg, block=BLOCK)(pc, pf, rays)),
        "pose": _np(make_sharded_pose_render(world, rc, cfg, cfg, H, W, block=BLOCK)(
            pc, pf, K_CAM, _c2w())),
        "occ": _np(make_sharded_render_occ(world, rc, cfg, block=BLOCK, **OCC_KW)(
            pf, grid, rays)),
        "froxel": _np(TF.make_sharded_render_froxel(world, rc, cfg, H, W, block=BLOCK,
                                                    **FRO_KW)(
            pf, _port_froxels(grid), K_CAM, _c2w())),
        "probe": TO_probe(pf, cfg, rc, world),
    }
    return out


def TO_probe(params, cfg, rc, world):
    from nerf_shared_tpu_torch.ops.meshing import probe_density_grid

    return probe_density_grid(params, cfg, rc, [-1.2, -1.0, -0.8], [1.0, 1.1, 1.3],
                              resolution=PROBE_RES, block=PROBE_BLOCK, mesh=world)


def port_tp(job, world):
    """make_tp_apply on this world's mesh (t = 2 on two ranks, (2, 2) on
    four), with and without viewdirs, and this rank's shard shapes."""
    shape = job["tp_shape"]
    groups = make_groups(shape, world)
    data_axis = "data" if shape[0] > 1 else None
    pts, vd = (torch.from_numpy(a) for a in job["tp_inputs"])
    out = {}
    for name, kw in (("vd", MLP_KW), ("novd", NOVD_KW)):
        cfg = tnerf.NeRFConfig(**kw)
        params = job["tp_params"][name]
        apply = make_tp_apply(groups, cfg, data_axis=data_axis)
        out[name] = apply(params, pts, vd if cfg.use_viewdirs else None).numpy()
        # the stored layout gives the same result
        local = tp_shard_params(groups, params)
        out[name + "_sharded"] = apply(local, pts, vd if cfg.use_viewdirs else None).numpy()
        out[name + "_shapes"] = {k: tuple(v.shape) for k, v in local.items()}
    return out


def _http_frame(port, c2w):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/render",
                                 data=json.dumps({"c2w": c2w.tolist(),
                                                  "fmt": "npy"}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return np.load(io.BytesIO(r.read()))


def port_clis(job, world):
    """The render and export entry points with --mesh_shape 2 on this rank:
    render_only, the eval CLI, the mesh CLI, the service (rank 0 serves one
    frame, rank 1 follows) and a trainer with an i_testset hook."""
    from nerf_shared_tpu_torch.apps import eval_cli, mesh_cli, serve
    from nerf_shared_tpu_torch.apps import train as tapp
    from nerf_shared_tpu_torch.config import config_parser

    base = ["--config", job["config"], "--device", "cpu", "--mesh_shape", "2"]
    out = {}
    outdir, rgbs = tapp.render_only(config_parser().parse_args(
        base + ["--render_only", "--render_test"]), return_rgbs=True)
    out["render_only"] = (outdir, rgbs)
    out["eval"] = eval_cli.main(base + ["--eval_out", job["eval_out"]])
    out["mesh"] = mesh_cli.main(base + job["mesh_flags"] + ["--mesh_out", job["mesh_out"]],
                                native="never")
    service = serve.RenderService(serve.serve_parser().parse_args(base))
    out["engine"] = service.engine.engine_name
    if world.is_main:
        server = serve.make_server(service, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            out["frame"] = _http_frame(server.server_address[1], job["pose"])
        finally:
            server.shutdown()
            service.close()
    else:
        out["followed"] = service.follow()
        service.close()
    tapp.train(config_parser().parse_args(base + [
        "--expname", "hooked", "--N_iters", "4", "--i_testset", "4", "--i_weights", "4",
        "--i_print", "2", "--i_img", "0", "--i_video", "0"]))
    return out


def _worker(job_path):
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    torch.set_num_threads(1)
    world = distributed.initialize("cpu", init_method=job["init_method"])
    try:
        out = {}
        if "config" in job:
            out["cli"] = port_clis(job, world)
        if "params" in job:
            out["fns"] = port_fns(job, world)
        if "tp_shape" in job:
            out["tp"] = port_tp(job, world)
    finally:
        distributed.shutdown(world)
    with open(f"{job_path}.{world.rank}", "wb") as f:
        pickle.dump(out, f)


def _spawn(tmp, n, job, name, timeout=240):
    """Run ``job`` on ``n`` spawned gloo ranks; returns (each rank's output,
    each rank's log)."""
    path = os.path.join(tmp, f"{name}{n}.pkl")
    job = dict(job, init_method="file://" + os.path.join(tmp, f"{name}store{n}"))
    with open(path, "wb") as f:
        pickle.dump(job, f)
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", WORLD_SIZE=str(n))
    procs = [subprocess.Popen([sys.executable, "-m", "tests.test_torch_parallel_render", path],
                              cwd=REPO, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} of {n} failed:\n{logs[r]}"
    outs = []
    for r in range(n):
        with open(f"{path}.{r}", "rb") as f:
            outs.append(pickle.load(f))
    return outs, logs


# --- the JAX side -----------------------------------------------------------------


def _jax_params(kw, seed):
    import jax

    from nerf_shared_tpu.models import nerf as jnerf

    jcfg = jnerf.NeRFConfig(**kw)
    jp = jax.device_get(jnerf.init_nerf_params(jax.random.PRNGKey(seed), jcfg))
    return jcfg, jp, tnerf.params_from_jax(jp)


def _jax_fns(n, jcfg, jc, jf, rays, grid):
    """JAX's sharded renders and probe on make_mesh((n,))."""
    import jax
    import jax.numpy as jnp

    from nerf_shared_tpu.ops import meshing as JM
    from nerf_shared_tpu.parallel import render as JPR
    from nerf_shared_tpu.parallel.mesh import make_mesh
    from nerf_shared_tpu.render import froxels as JF
    from nerf_shared_tpu.render import occupancy as JO
    from nerf_shared_tpu.render.renderer import RenderConfig as JRenderConfig

    mesh, key = make_mesh((n,)), jax.random.PRNGKey(0)
    jr = JRenderConfig(**RC)
    jrays = jnp.asarray(rays)
    jgrid = JO.OccupancyGrid(*(jnp.asarray(a) for a in grid))
    jfro = JF.build_froxels(jgrid, H, W, K_CAM, jnp.asarray(_c2w()), RC["near"],
                            RC["far"], n_depth=N_DEPTH, tile=FRO_KW["tile"])
    get = jax.device_get
    return {
        "render": get(JPR.make_sharded_render(mesh, jr, jcfg, jcfg, block=BLOCK)(
            jc, jf, jrays, key)),
        "pose": get(JPR.make_sharded_pose_render(mesh, jr, jcfg, jcfg, H, W, block=BLOCK)(
            jc, jf, K_CAM, jnp.asarray(_c2w()), key)),
        "occ": get(JPR.make_sharded_render_occ(mesh, jr, jcfg, block=BLOCK, **OCC_KW)(
            jf, jgrid, jrays, key)),
        "froxel": get(JF.make_sharded_render_froxel(mesh, jr, jcfg, H, W, block=BLOCK,
                                                    **FRO_KW)(
            jf, jfro, K_CAM, jnp.asarray(_c2w()), key)),
        "probe": JM.probe_density_grid(jf, jcfg, jr, [-1.2, -1.0, -0.8], [1.0, 1.1, 1.3],
                                       resolution=PROBE_RES, block=PROBE_BLOCK, mesh=mesh),
    }


def _jax_tp(shape, jparams, inputs):
    """JAX's make_tp_apply on the matching mesh."""
    import jax
    import jax.numpy as jnp

    from nerf_shared_tpu.models import nerf as jnerf
    from nerf_shared_tpu.parallel.mesh import make_mesh
    from nerf_shared_tpu.parallel.tensor import make_tp_apply as j_make_tp_apply

    two_d = shape[0] > 1
    mesh = make_mesh(shape, ("data", "model")) if two_d else make_mesh(shape[1:], ("model",))
    pts, vd = (jnp.asarray(a) for a in inputs)
    out = {}
    for name, kw in (("vd", MLP_KW), ("novd", NOVD_KW)):
        cfg = jnerf.NeRFConfig(**kw)
        apply = j_make_tp_apply(mesh, cfg, data_axis="data" if two_d else None)
        out[name] = np.asarray(jax.device_get(apply(jparams[name], pts,
                                                    vd if cfg.use_viewdirs else None)))
    return out


def _tp_inputs(n=6, s=5, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, s, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    return pts, d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """{n: (JAX's results, each rank's port results)} for the worlds of 2, 3
    (the sharded renders and the probe; TP at t = 2 on 2) and 4 (TP on
    (2, 2)): JAX compiles in threads while the ranks run."""
    import concurrent.futures as cf

    tmp = str(tmp_path_factory.mktemp("sharded"))
    jcfg, jc, tc = _jax_params(MLP_KW, 1)
    _, jf, tf = _jax_params(MLP_KW, 2)
    _, jnovd, tnovd = _jax_params(NOVD_KW, 3)
    rays, grid = _rays(), _grid_arrays()
    job = {"params": {"coarse": tc, "fine": tf}, "rays": rays, "grid": grid,
           "tp_inputs": _tp_inputs(), "tp_params": {"vd": tf, "novd": tnovd}}
    jtp = {"vd": jf, "novd": jnovd}
    jobs = {2: dict(job, tp_shape=(1, 2)), 3: job,
            4: {k: job[k] for k in ("tp_inputs", "tp_params")} | {"tp_shape": (2, 2)}}
    with cf.ThreadPoolExecutor(4) as pool:
        spawned = {n: pool.submit(_spawn, tmp, n, jobs[n], "fns") for n in (2, 3, 4)}
        want = {n: pool.submit(_jax_fns, n, jcfg, jc, jf, rays, grid) for n in (2, 3)}
        want_tp = {n: pool.submit(_jax_tp, jobs[n]["tp_shape"], jtp, job["tp_inputs"])
                   for n in (2, 4)}
        return {n: ({**(want[n].result() if n in want else {}),
                     **({"tp": want_tp[n].result()} if n in want_tp else {})},
                    [o for o in spawned[n].result()[0]], job) for n in (2, 3, 4)}


def _maps_close(got, want, keys):
    for k in keys:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("fn", ["render", "pose", "occ", "froxel"])
def test_sharded_render_matches_jax(sharded, fn, n):
    want, outs, _ = sharded[n]
    got = outs[0]["fns"][fn]
    for r in range(1, n):  # every rank holds the whole frame
        for k, v in got.items():
            np.testing.assert_array_equal(outs[r]["fns"][fn][k], v, err_msg=(r, k))
    shape = (H, W) if fn in ("pose", "froxel") else (N_RAYS,)
    assert got["rgb_map"].shape == shape + (3,)
    _maps_close(got, want[fn], MAPS)
    if fn in ("occ", "froxel"):
        np.testing.assert_array_equal(got["n_active"], np.asarray(want[fn]["n_active"]))
    if fn == "render":
        _maps_close(got, want[fn], ("rgb0", "acc0", "disp0"))


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_probe_matches_jax(sharded, n):
    want, outs, _ = sharded[n]
    got = outs[0]["fns"]["probe"]
    assert got.shape == want["probe"].shape == (PROBE_RES + 1,) * 3
    for r in range(1, n):
        np.testing.assert_array_equal(outs[r]["fns"]["probe"], got)
    np.testing.assert_allclose(got, want["probe"], rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(want["probe"]).max())))


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_frames_match_the_unsharded_engine(sharded, n):
    """The port's sharded frames (its kernels kept, the JAX ones turned
    off: both plain on the CPU) against its own unsharded renderer."""
    _, outs, job = sharded[n]
    cfg = tnerf.NeRFConfig(**MLP_KW)
    pc, pf = job["params"]["coarse"], job["params"]["fine"]
    rgb, disp, acc, _ = Renderer(**RC).render_from_pose(H, W, K_CAM, 1024, _c2w(),
                                                        (pc, cfg), (pf, cfg))
    _maps_close(outs[0]["fns"]["pose"], {"rgb_map": rgb, "disp_map": disp, "acc_map": acc},
                MAPS)
    ref = TF.render_image_froxels((pf, cfg), _port_grid(job["grid"]), RenderConfig(**RC),
                                  H, W, K_CAM, torch.from_numpy(_c2w()), n_depth=N_DEPTH,
                                  tile=FRO_KW["tile"], n_keep=FRO_KW["n_keep"])
    _maps_close(outs[0]["fns"]["froxel"], _np(ref), MAPS)


@pytest.mark.parametrize("n", [2, 4])
def test_tensor_parallel_apply_matches_jax(sharded, n):
    want, outs, job = sharded[n]
    t = 2
    for name in ("vd", "novd"):
        got = outs[0]["tp"][name]
        np.testing.assert_allclose(got, want["tp"][name], rtol=1e-5, atol=1e-5, err_msg=name)
        cfg = tnerf.NeRFConfig(**(MLP_KW if name == "vd" else NOVD_KW))
        pts, vd = (torch.from_numpy(a) for a in job["tp_inputs"])
        plain = tnerf.apply_nerf(job["tp_params"][name], cfg, pts,
                                 vd if cfg.use_viewdirs else None).numpy()
        np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)
        for r in range(n):
            np.testing.assert_array_equal(outs[r]["tp"][name], got)
            np.testing.assert_array_equal(outs[r]["tp"][name + "_sharded"], got)
    # each rank stores 1/t of each wide matrix and bias, the heads whole
    full = job["tp_params"]["vd"]
    specs = tp_param_specs(full, t)
    assert specs["pts_linears.0.weight"] and specs["views_linears.0.bias"]
    assert not specs["alpha_linear.weight"] and not specs["rgb_linear.bias"]
    for r in range(n):
        for k, shape in outs[r]["tp"]["vd_shapes"].items():
            want_rows = full[k].shape[0] // t if specs[k] else full[k].shape[0]
            assert shape == (want_rows,) + tuple(full[k].shape[1:]), (r, k)


def test_tp_shard_params_panels_are_the_model_ranks_rows():
    """tp_shard_params cuts each wide matrix into t row panels (the port's
    weights are [out, in]) and keeps model rank m's."""
    from nerf_shared_tpu_torch.parallel.distributed import World
    from nerf_shared_tpu_torch.parallel.mesh import MeshGroups

    params = tnerf.NeRF(tnerf.NeRFConfig(**MLP_KW)).params()
    for m in range(2):
        local = tp_shard_params(MeshGroups(World(m, 2, "cpu", False), 1, 2, 0, m), params)
        w = params["pts_linears.1.weight"]
        assert torch.equal(local["pts_linears.1.weight"], w[16 * m:16 * (m + 1)])
        assert torch.equal(local["feature_linear.bias"],
                           params["feature_linear.bias"][16 * m:16 * (m + 1)])
        assert local["alpha_linear.weight"] is params["alpha_linear.weight"]


# --- world size 1: the unsharded path bit for bit --------------------------------------


@pytest.fixture
def world_of_one(tmp_path):
    world = distributed.initialize("cpu", init_method=f"file://{tmp_path}/store1")
    try:
        yield world
    finally:
        distributed.shutdown(world)
    assert not torch.distributed.is_initialized()


def _seeded_models():
    torch.manual_seed(0)
    cfg = tnerf.NeRFConfig(**MLP_KW)
    return cfg, tnerf.NeRF(cfg).params(), tnerf.NeRF(cfg).params()


@pytest.mark.parametrize("perturb", [0.0, 1.0])
def test_world_of_one_is_the_unsharded_path_bit_for_bit(world_of_one, perturb):
    """A process group of one rank: each sharded function equals its
    unsharded counterpart exactly (perturb 1: the rank's generator is the
    unsharded seed's)."""
    from nerf_shared_tpu_torch.ops.meshing import probe_density_grid

    cfg, pc, pf = _seeded_models()
    rc = RenderConfig(**{**RC, "perturb": perturb})
    rays = torch.from_numpy(_rays())
    grid = _port_grid(_grid_arrays())

    def gen():
        return torch.Generator().manual_seed(5)

    pairs = [
        (make_sharded_render(world_of_one, rc, cfg, cfg, block=BLOCK)(pc, pf, rays, seed=5),
         Renderer(**RC | {"perturb": perturb}).render_flat_rays(
             rays, (pc, cfg), (pf, cfg), chunk=BLOCK, generator=gen())),
        (make_sharded_render_occ(world_of_one, rc, cfg, block=BLOCK, **OCC_KW)(
            pf, grid, rays, seed=5),
         TO.render_flat_rays_occ(rays, (pf, cfg), grid, rc, chunk=BLOCK, generator=gen(),
                                 **OCC_KW)),
        (TF.make_sharded_render_froxel(world_of_one, rc, cfg, H, W, block=BLOCK, **FRO_KW)(
            pf, _port_froxels(grid), K_CAM, _c2w(), seed=5),
         TF.render_image_froxels((pf, cfg), grid, rc, H, W, K_CAM, torch.from_numpy(_c2w()),
                                 n_depth=N_DEPTH, chunk=BLOCK, skip_empty=False,
                                 generator=gen(), froxels=_port_froxels(grid), **FRO_KW)),
    ]
    if perturb == 0.0:
        rgb, disp, acc, extras = Renderer(**RC).render_from_pose(
            H, W, K_CAM, BLOCK, _c2w(), (pc, cfg), (pf, cfg), retraw=False)
        pairs.append((make_sharded_pose_render(world_of_one, rc, cfg, cfg, H, W,
                                               block=BLOCK)(pc, pf, K_CAM, _c2w()),
                      {"rgb_map": rgb, "disp_map": disp, "acc_map": acc, **extras}))
    for got, want in pairs:
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), k
    box = ([-1.0] * 3, [1.0] * 3)
    assert np.array_equal(probe_density_grid(pf, cfg, rc, *box, resolution=PROBE_RES,
                                             block=PROBE_BLOCK, mesh=world_of_one),
                          probe_density_grid(pf, cfg, rc, *box, resolution=PROBE_RES,
                                             block=PROBE_BLOCK))
    pts, vd = (torch.from_numpy(a) for a in _tp_inputs())
    for shape in ([1], [1, 1]):
        apply = make_tp_apply(make_groups(shape, world_of_one), cfg, data_axis="data")
        assert torch.equal(apply(pf, pts, vd), tnerf.apply_nerf(pf, cfg, pts, vd))


def test_sharded_render_keeps_the_kernel_route(world_of_one, monkeypatch):
    """The port's sharded frame keeps the config's kernels (JAX's sets
    use_pallas=False): under use_pallas the rank's slice goes through the
    B3 and B5 wrappers (their plain versions on the CPU)."""
    from nerf_shared_tpu_torch.render import renderer as TR

    calls = {"b3": 0, "b5": 0}
    b3, b5 = TR.fused_nerf_forward_rays, TR.composite_fused

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(TR, "fused_nerf_forward_rays", count("b3", b3))
    monkeypatch.setattr(TR, "composite_fused", count("b5", b5))
    cfg, pc, pf = _seeded_models()
    on = RenderConfig(**RC, use_pallas=True)
    out = make_sharded_pose_render(world_of_one, on, cfg, cfg, H, W, block=BLOCK)(
        pc, pf, K_CAM, _c2w())
    blocks = -(-H * W // BLOCK)
    assert calls == {"b3": 2 * blocks, "b5": 2 * blocks}
    plain = make_sharded_pose_render(world_of_one, RenderConfig(**RC), cfg, cfg, H, W,
                                     block=BLOCK)(pc, pf, K_CAM, _c2w())
    for k in MAPS:
        torch.testing.assert_close(out[k], plain[k], rtol=1e-5, atol=1e-5)


# --- the entry points ---------------------------------------------------------------


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """A tiny scene trained single-process, then the entry points on two
    spawned ranks: (config, each rank's outputs, logs, the job)."""
    from nerf_shared_tpu_torch.apps import train as tapp
    from nerf_shared_tpu_torch.config import config_parser
    from tests.test_e2e import _write_config, _write_scene

    tmp = tmp_path_factory.mktemp("cli")
    datadir = str(tmp / "scene")
    _write_scene(datadir, size=12, n_train=3, n_test=2)
    cfg = _write_config(str(tmp), datadir, str(tmp / "logs"), N_iters=10, i_print=10,
                        i_weights=10, N_rand=64, ckpt_format="tar")
    tapp.train(config_parser().parse_args(["--config", cfg, "--device", "cpu"]))
    job = {"config": cfg, "eval_out": str(tmp / "eval2.json"),
           "mesh_out": str(tmp / "mesh2.obj"), "mesh_flags": _mesh_flags(cfg),
           "pose": np.array([[1, 0, 0, 0.3], [0, 1, 0, 0.1], [0, 0, 1, 4.0]], np.float32)}
    outs, logs = _spawn(str(tmp), 2, job, "cli")
    return cfg, outs, logs, job


def _mesh_flags(cfg):
    """Mesh CLI flags over a 1.5 cube at an iso the checkpoint's field
    crosses (its median raw sigma on the lattice)."""
    from nerf_shared_tpu_torch.ops.meshing import probe_density_grid

    eng = _engine(cfg)
    sigma = probe_density_grid(eng.fine.params(), eng.fine.cfg, eng.renderer.cfg,
                               [-1.5] * 3, [1.5] * 3, resolution=12)
    return ["--mesh_res", "12", "--mesh_aabb", "1.5", "--mesh_iso",
            repr(float(np.median(sigma)))]


def _engine(cfg, *extra):
    from nerf_shared_tpu_torch.apps import train as tapp
    from nerf_shared_tpu_torch.config import config_parser

    return tapp.build_eval_engine(config_parser().parse_args(
        ["--config", cfg, "--device", "cpu", "--render_only", "--render_test", *extra]))


def _pngs(d):
    from nerf_shared_tpu_torch.data.images import png_decode

    names = sorted(f for f in os.listdir(d) if f.endswith(".png"))
    return [png_decode(open(os.path.join(d, f), "rb").read()) for f in names]


def test_render_only_on_two_ranks_writes_the_single_process_frames(cli):
    from nerf_shared_tpu_torch.utils.metrics import to8b

    cfg, outs, logs, _ = cli
    outdir, rgbs = outs[0]["cli"]["render_only"]
    assert outs[1]["cli"]["render_only"] == (outdir, None)
    eng = _engine(cfg)
    ref = eng.render_poses(eng.ds.render_poses[:, :3, :4])
    np.testing.assert_allclose(rgbs, ref, rtol=1e-4, atol=1e-5)
    pngs = _pngs(outdir)
    assert len(pngs) == len(ref) == 2
    for got, want in zip(pngs, ref):
        assert int(np.abs(got[..., :3].astype(int) - to8b(want).astype(int)).max()) <= 1
    assert "Done rendering 2 views" in logs[0] and "Done rendering" not in logs[1]
    assert outs[0]["cli"]["engine"] == outs[1]["cli"]["engine"] == "sharded-dense"


def test_eval_cli_on_two_ranks_reports_once(cli):
    cfg, outs, logs, job = cli
    report = outs[0]["cli"]["eval"]
    assert outs[1]["cli"]["eval"] is None
    assert report["n_views"] == 2 and np.isfinite(report["mean_psnr"])
    with open(job["eval_out"]) as f:
        assert json.load(f)["mean_psnr"] == report["mean_psnr"]
    assert logs[0].count("mean over 2 views") == 1 and "mean over" not in logs[1]


def test_mesh_cli_on_two_ranks_writes_the_single_process_mesh(cli, tmp_path):
    from nerf_shared_tpu_torch.apps import mesh_cli

    cfg, outs, _, job = cli
    path, verts, faces = outs[0]["cli"]["mesh"]
    assert outs[1]["cli"]["mesh"] == (None, None, None) and len(faces) > 0
    single = str(tmp_path / "mesh1.obj")
    # one thread, as the ranks run: the CPU's products then round alike
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mesh_cli.main(["--config", cfg, "--device", "cpu", "--mesh_out", single]
                      + job["mesh_flags"], native="never")
    finally:
        torch.set_num_threads(threads)
    with open(path, "rb") as a, open(single, "rb") as b:
        assert a.read() == b.read()


def test_service_on_two_ranks_serves_the_single_process_frame(cli):
    cfg, outs, logs, job = cli
    frame = outs[0]["cli"]["frame"]
    want = _engine(cfg).render_poses(job["pose"][None])[0]
    np.testing.assert_allclose(frame, want, rtol=1e-4, atol=1e-5)
    assert outs[1]["cli"]["followed"] == 1
    assert "render world: rank 1 of 2, sharded frames" in logs[1]


def test_trainer_hooks_render_over_two_ranks(cli):
    """The --mesh_shape 2 trainer's i_testset hook: both ranks render each
    frame, rank 0 writes it; the frames are the single-process render of
    the hook step's checkpoint."""
    from nerf_shared_tpu_torch.utils.metrics import to8b

    cfg, outs, logs, _ = cli
    assert "Saved test set renders" in logs[0] and "Saved test set renders" not in logs[1]
    testdir = os.path.join(os.path.dirname(cfg), "logs", "hooked", "testset_000004")
    eng = _engine(cfg, "--expname", "hooked")
    assert eng.start == 4 and eng.engine_name == "dense"
    ref = eng.render_poses(eng.ds.render_poses[:, :3, :4])
    pngs = _pngs(testdir)
    assert len(pngs) == 2
    for got, want in zip(pngs, ref):
        assert int(np.abs(got[..., :3].astype(int) - to8b(want).astype(int)).max()) <= 1


def test_engine_under_a_world_of_one_is_sharded_dense(cli, world_of_one):
    """The eval engine built in a process group of one renders through the
    sharded dense frame, bit-equal to the plain engine's frame."""
    cfg = cli[0]
    eng = _engine(cfg)
    assert eng.world.launched and eng.engine_name == "sharded-dense"
    plain = _engine(cfg, "--render_gate", "0.0")
    plain.render_fn = None
    assert plain.engine_name == "dense"
    poses = eng.ds.render_poses[:, :3, :4]
    assert np.array_equal(eng.render_poses(poses), plain.render_poses(poses))


def test_profiling_helpers(tmp_path):
    """utils/profiling.py: ``timed`` returns the mean seconds a call and the
    last result, ``rays_per_sec`` is JAX's, ``trace`` writes a Chrome
    trace."""
    from nerf_shared_tpu.utils import profiling as jprof
    from nerf_shared_tpu_torch.utils import profiling as tprof

    calls = []
    dt, out = tprof.timed(lambda x: calls.append(x) or x * 2, 3, warmup=2, iters=4)
    assert out == 6 and len(calls) == 6 and dt >= 0.0
    for n, s in ((1000, 0.5), (7, 0.0)):
        assert tprof.rays_per_sec(n, s) == jprof.rays_per_sec(n, s)
    with tprof.trace(str(tmp_path / "t")):
        torch.ones(64).sum()
    with open(tmp_path / "t" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


if __name__ == "__main__":
    _worker(sys.argv[1])
