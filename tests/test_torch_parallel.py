"""Data-parallel training over torch.distributed on the CPU (parallel/,
``make_train_step(world=)``, ``make_occ_train_step(world=)``, the
trainer's --mesh_shape / --multihost), against the JAX package's sharded
steps on the virtual CPU devices of tests/conftest.py.

- World sizes 2 and 3: gloo processes spawned with a ``file://`` store,
  against ``make_fused_train_step(mesh=make_mesh((n,)))`` and
  ``make_occ_train_step(mesh=)``, two steps each of the MLP recipe, the
  hashgrid, ``--loss_sampling`` with ``--ema_decay`` and the occ step. Each
  rank's draws are JAX's for device r (``fold_in(key, r)``, then its
  sampler at the local batch and its render keys). N_rand 16 is not a
  multiple of 3: each rank draws ceil(16 / n). Loss and PSNR to 1e-5
  relative; post-Adam parameters (and the EMA shadow) to 1e-6 except
  entries whose reduced gradient came within 1e-6 of zero without being
  zero (there Adam's g / (|g| + eps) turns the last fp32 digits into up to
  2 lr a step, as tests/test_torch_train.py holds a trajectory); the loss
  map to 1e-6; the occ step's fine branch on 98% of its entries.
- The reduced gradient equals the single-process gradient over the union
  of the ranks' batches; world size 1 equals the unsharded step bit for bit.
- The exact-epoch walk: the ranks' draws of a step are the unsharded
  walk's global batch cut into parts; JAX's sharded walk draws device d's
  pixels of step s again on device d - 1 at step s + 1 (ROADMAP C).
- The CLI: two ranks train a tiny scene for 20 steps through
  ``apps.train.train`` and end with bit-equal parameters, rank 0 alone
  saving; --mesh_shape 3 at world size 2 and --mesh_shape 2 2 raise;
  --multihost without a launcher trains single-process and says so.

This module imports no JAX at its top: ``python -m tests.test_torch_parallel
<job>`` is the spawned rank.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from nerf_shared_tpu_torch.models import hashgrid as thash
from nerf_shared_tpu_torch.models import nerf as tnerf
from nerf_shared_tpu_torch.parallel import distributed
from nerf_shared_tpu_torch.parallel.distributed import World
from nerf_shared_tpu_torch.parallel.mesh import make_mesh
from nerf_shared_tpu_torch.render.renderer import RenderConfig
from nerf_shared_tpu_torch.train import loss_sampling as TL
from nerf_shared_tpu_torch.train import occ_train as TOT
from nerf_shared_tpu_torch.train import pipeline as tpipe
from nerf_shared_tpu_torch.train.state import create_train_state
from nerf_shared_tpu_torch.train.step import make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MLP_KW = dict(D=3, W=32, skips=(1,), use_viewdirs=True, multires=4, multires_views=2,
              output_ch=5)
HASH_KW = dict(L=3, log2_T=7, F=2, base_res=4, max_res=16, hidden=16, geo_feat=7,
               rgb_depth=2, layout="split", aabb_min=(-3.0,) * 3, aabb_max=(3.0,) * 3)
H = W = 8
N_IMG, N_RAND, S, TILE, STEPS = 3, 16, 8, 4, 2
C_OCC, K_OCC, NOISE_OCC = 12, 5, 0.5
LR = 5e-3
OCC_LO, OCC_HI = np.array([-3, -3, -7], np.float32), np.array([3, 3, -1], np.float32)
# case -> (family, loss sampling + EMA, occ step)
CASES = {"mlp": ("mlp", False, False), "hashgrid": ("hashgrid", False, False),
         "ls_ema": ("mlp", True, False), "occ": ("mlp", False, True)}


def _scene(seed=4):
    rng = np.random.default_rng(seed)
    images = rng.random((N_IMG, H, W, 3)).astype(np.float32)
    poses = np.stack([np.eye(4)[:3] + 0.1 * rng.standard_normal((3, 4))
                      for _ in range(N_IMG)]).astype(np.float32)
    K = np.array([[11.0, 0, W / 2], [0, 11.5, H / 2], [0, 0, 1]])
    return images, poses, K


def _occ_ema(G=8, seed=10):
    rng = np.random.default_rng(seed)
    ema = (rng.random((G, G, G)) ** 3 * 40.0).astype(np.float32)
    ema[rng.random((G, G, G)) < 0.5] = 0.0
    return ema


def _rcfg_kw(occ):
    return dict(N_samples=S, N_importance=S, use_viewdirs=True, white_bkgd=True,
                near=2.0, far=6.0, perturb=1.0, raw_noise_std=NOISE_OCC if occ else 0.0)


def _spec_kw():
    return dict(single_image=True, precrop_iters=1, precrop_frac=0.5)


# --- the port's side (the spawned ranks run this) ------------------------------------


def port_state(case, params):
    family, ls_ema, _ = CASES[case]
    tcfg = (tnerf.NeRFConfig(**MLP_KW) if family == "mlp"
            else thash.HashGridConfig(**HASH_KW))
    ts = create_train_state(tcfg, tcfg, "cpu", lrate=LR, lrate_decay=250)
    for b, m in ts.branches():
        m.load_state_dict(params[b], strict=True)
    if ls_ema:
        ts.init_ema()
        ts.loss_map = TL.init_loss_map(N_IMG, H, W, TILE)
    return ts, tcfg


def run_port(case, params, world, draws, overrides):
    """STEPS steps of ``case`` from ``params`` ({"coarse", "fine": state
    dict}) with this rank's pinned ``draws`` / ``overrides`` (one a step;
    None: the step's own generator draws): per step the parameters, the
    reduced gradients, the aux values, the EMA shadow and the loss map."""
    draws = draws or [None] * STEPS
    overrides = overrides or [None] * STEPS
    _, ls_ema, occ = CASES[case]
    images, poses, K = _scene()
    ts, tcfg = port_state(case, params)
    rcfg = RenderConfig(**_rcfg_kw(occ))
    spec = tpipe.PixelSamplerSpec.from_K(H, W, K, N_RAND, **_spec_kw())
    if occ:
        step = TOT.make_occ_train_step(rcfg, tcfg, spec, n_candidates=C_OCC, n_keep=K_OCC,
                                       explore=0.05, world=world)
        grid = TOT.binarize_density_grid(TOT.DensityGrid(
            torch.from_numpy(_occ_ema()), torch.from_numpy(OCC_LO), torch.from_numpy(OCC_HI)))
    else:
        step = make_train_step(rcfg, tcfg, tcfg, spec, world=world,
                               loss_sampling=TL.LossSamplingSpec(tile=TILE) if ls_ema else None,
                               ema_decay=0.9 if ls_ema else 0.0)
    out = []
    for i in range(STEPS):
        args = (ts, torch.from_numpy(images), torch.from_numpy(poses),
                torch.Generator().manual_seed(i))
        if occ:
            aux = step(ts, grid, *args[1:], draws=draws[i])
        else:
            ov = overrides[i] and {k: torch.from_numpy(v) for k, v in overrides[i].items()}
            aux = step(*args, draws=draws[i], overrides=ov)
        out.append(dict(
            params={k: v.detach().clone() for k, v in ts.named_parameters().items()},
            grads={k: v.grad.clone() for k, v in ts.named_parameters().items()},
            aux={k: float(v) for k, v in aux.items()},
            ema=None if ts.ema is None else {b: {k: v.clone() for k, v in e.items()}
                                             for b, e in ts.ema.items()},
            loss_map=None if ts.loss_map is None else ts.loss_map.clone()))
    return out


def _cli_rank(job, world):
    """Two ranks train the tiny scene through apps.train.train: --mesh_shape
    3 raises first; each rank reports its parameters and its saves."""
    from nerf_shared_tpu_torch.apps import train as tapp
    from nerf_shared_tpu_torch.config import config_parser

    saves = []
    real = tapp.ckpt_utils.save_checkpoints
    tapp.ckpt_utils.save_checkpoints = lambda *a, **k: saves.append(a[3]) or real(*a, **k)
    argv = ["--config", job["config"], "--device", "cpu"]
    try:
        tapp.train(config_parser().parse_args(argv + ["--mesh_shape", "3"]))
        mesh3 = None
    except ValueError as e:
        mesh3 = str(e)
    state = tapp.train(config_parser().parse_args(argv + ["--mesh_shape", "2"]))
    return dict(mesh3=mesh3, saves=saves,
                params={k: v.detach().clone() for k, v in state.named_parameters().items()})


def _worker(job_path):
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    torch.set_num_threads(1)
    world = distributed.initialize("cpu", init_method=job["init_method"])
    try:
        if "config" in job:
            out = _cli_rank(job, world)
        else:
            out = {case: run_port(case, c["params"], world, c["draws"][world.rank],
                                  c["overrides"][world.rank])
                   for case, c in job["cases"].items()}
    finally:
        distributed.shutdown(world)
    with open(f"{job_path}.{world.rank}", "wb") as f:
        pickle.dump(out, f)


def _spawn(tmp, n, job, timeout=240):
    """Run ``job`` on ``n`` spawned gloo ranks; returns each rank's output."""
    path = os.path.join(tmp, f"job{n}.pkl")
    job = dict(job, init_method="file://" + os.path.join(tmp, f"store{n}"))
    with open(path, "wb") as f:
        pickle.dump(job, f)
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", WORLD_SIZE=str(n))
    procs = [subprocess.Popen([sys.executable, "-m", "tests.test_torch_parallel", path],
                              cwd=REPO, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    logs = [p.communicate(timeout=timeout)[0] for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} of {n} failed:\n{logs[r]}"
    outs = []
    for r in range(n):
        with open(f"{path}.{r}", "rb") as f:
            outs.append(pickle.load(f))
    return outs, logs


# --- the JAX side -----------------------------------------------------------------


def _jax_case(case, n, seed=3):
    """JAX's sharded step on n virtual devices, STEPS steps: its results
    and the draws of each device, as the port's ``draws`` / ``overrides``."""
    import jax
    import jax.numpy as jnp

    from nerf_shared_tpu.models import hashgrid as jhash
    from nerf_shared_tpu.models import nerf as jnerf
    from nerf_shared_tpu.parallel.mesh import make_mesh as j_make_mesh
    from nerf_shared_tpu.render.renderer import RenderConfig as JRenderConfig
    from nerf_shared_tpu.train import loss_sampling as JL
    from nerf_shared_tpu.train import occ_train as JOT
    from nerf_shared_tpu.train import pipeline as jpipe
    from nerf_shared_tpu.train.state import create_train_state as j_create_state
    from nerf_shared_tpu.train.step import make_fused_train_step
    from nerf_shared_tpu_torch.models.nerf import params_tree_from_jax
    from tests.test_torch_loss_sampling import weighted_draws
    from tests.test_torch_occ_train import _loss_draws
    from tests.test_torch_train import _key_words

    family, ls_ema, occ = CASES[case]
    jcfg = jnerf.NeRFConfig(**MLP_KW) if family == "mlp" else jhash.HashGridConfig(**HASH_KW)
    to_port = tnerf.params_from_jax if family == "mlp" else params_tree_from_jax
    js = j_create_state(jax.random.PRNGKey(seed), jcfg, jcfg, lrate=LR, lrate_decay=250)
    if ls_ema:
        js = js.replace(aux_state={
            "ema": {k: jax.tree_util.tree_map(jnp.copy, js.params[k])
                    for k in ("coarse", "fine")},
            "loss_map": JL.init_loss_map(N_IMG, H, W, TILE)})
    params0 = {b: to_port(jax.device_get(js.params[b])) for b in ("coarse", "fine")}
    images, poses, K = _scene()
    jspec = jpipe.PixelSamplerSpec.from_K(H, W, K, N_RAND, **_spec_kw())
    jr = JRenderConfig(**_rcfg_kw(occ))
    mesh = j_make_mesh((n,))
    local = -(-N_RAND // n)
    if occ:
        jstep = JOT.make_occ_train_step(jr, jcfg, jspec, n_candidates=C_OCC,
                                        n_keep=K_OCC, explore=0.05, mesh=mesh, donate=False)
        jocc = JOT.binarize_density_grid(JOT.DensityGrid(
            jnp.asarray(_occ_ema()), jnp.asarray(OCC_LO), jnp.asarray(OCC_HI)))
    else:
        jstep = make_fused_train_step(
            jr, jcfg, jcfg, jspec, mesh=mesh, donate=False,
            loss_sampling=JL.LossSamplingSpec(tile=TILE) if ls_ema else None,
            ema_decay=0.9 if ls_ema else 0.0)
    want, draws, overrides = [], [[] for _ in range(n)], [[] for _ in range(n)]
    for i in range(STEPS):
        key = jax.random.PRNGKey(100 + i)
        if occ:
            js, jaux = jstep(js, jocc, jnp.asarray(images), jnp.asarray(poses), key)
        else:
            js, jaux = jstep(js, jnp.asarray(images), jnp.asarray(poses), key)
        ema = js.aux_state.get("ema") if js.aux_state else None
        want.append(dict(
            params={b: to_port(jax.device_get(js.params[b])) for b in ("coarse", "fine")},
            aux={k: float(v) for k, v in jax.device_get(jaux).items()},
            ema=None if ema is None else {b: to_port(jax.device_get(ema[b]))
                                          for b in ("coarse", "fine")},
            loss_map=None if not ls_ema else np.asarray(js.aux_state["loss_map"])))
        for r in range(n):
            k_sample, k_render = jax.random.split(jax.random.fold_in(key, r))
            if ls_ema:
                d = weighted_draws(k_sample, N_IMG, local, TILE)
            else:
                k_img, k_y, k_x = jax.random.split(k_sample, 3)
                d = {"img_idx": int(jax.random.randint(k_img, (), 0, N_IMG)),
                     "key_y": _key_words(k_y), "key_x": _key_words(k_x)}
            if occ:
                d.update(_loss_draws(k_render, local, C_OCC, K_OCC, NOISE_OCC))
            k_strat, k_u, _, _ = jax.random.split(k_render, 4)
            overrides[r].append(
                {"t_rand": np.array(jax.random.uniform(k_strat, (local, S))),
                 "u": np.array(jax.random.uniform(k_u, (local, S)))})
            draws[r].append(d)
    return dict(params=params0, draws=draws, overrides=overrides), want


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """{n: (JAX's results, each rank's port results, the jobs)} for n = 2,
    3: JAX's cases compile in threads, then both worlds' ranks run at once."""
    import concurrent.futures as cf

    tmp = str(tmp_path_factory.mktemp("dp"))
    keys = [(n, case) for n in (2, 3) for case in CASES]
    with cf.ThreadPoolExecutor(4) as pool:
        done = dict(zip(keys, pool.map(lambda k: _jax_case(k[1], k[0]), keys)))
        jobs = {n: {c: done[(n, c)][0] for c in CASES} for n in (2, 3)}
        spawned = {n: pool.submit(_spawn, tmp, n, {"cases": jobs[n]}) for n in (2, 3)}
        return {n: ({c: done[(n, c)][1] for c in CASES}, spawned[n].result()[0], jobs[n])
                for n in (2, 3)}


def _fragile_close(got, want, grads, fragile, i, lr_of, key):
    """got / want {name: tensor}: within 1e-6 but where a reduced gradient
    came within 1e-6 of zero without being zero (so far), and within 2 lr
    a step everywhere."""
    for k, v in got.items():
        g = grads[k]
        f = fragile[(key, k)] = fragile.get((key, k), torch.zeros_like(g, dtype=torch.bool)) | (
            (g.abs() < 1e-6) & (g != 0))
        d = (v - want[k]).abs()
        assert float(torch.where(f, 0.0, d).max()) <= 1e-6, (i, key, k)
        assert float(d.max()) <= 2 * lr_of(k) * (i + 1) + 1e-6, (i, key, k)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_jax(sharded, case, n):
    want, outs, _ = sharded[n]
    want = want[case]
    _, ls_ema, occ = CASES[case]
    lr_of = lambda k: 2e-2 if k.split(".")[0] in ("tables", "planes") else LR  # noqa: E731
    for r in range(1, n):
        # every rank holds the same state after each step
        for i in range(STEPS):
            for k, v in outs[0][case][i]["params"].items():
                assert torch.equal(v, outs[r][case][i]["params"][k]), (r, i, k)
    got = outs[0][case]
    fragile = {}
    for i in range(STEPS):
        for k in ("loss", "img_loss", "psnr"):
            assert got[i]["aux"][k] == pytest.approx(want[i]["aux"][k], rel=1e-5), (i, k)
        if not occ:
            assert got[i]["aux"]["psnr0"] == pytest.approx(want[i]["aux"]["psnr0"], rel=1e-5)
        for b in ("coarse", "fine"):
            mine = {k[1]: v for k, v in got[i]["params"].items() if k[0] == b}
            grads = {k[1]: v for k, v in got[i]["grads"].items() if k[0] == b}
            if occ and b == "fine":
                for k, v in mine.items():
                    d = (v - want[i]["params"][b][k]).abs()
                    assert float(d.max()) <= 2 * LR * (i + 1) + 1e-6, (i, k)
                    assert float(torch.quantile(d.flatten(), 0.98)) <= 1e-6, (i, k)
                continue
            _fragile_close(mine, want[i]["params"][b], grads, fragile, i, lr_of, b)
            if ls_ema:
                for k, e in got[i]["ema"][b].items():
                    f = fragile[(b, k)]
                    de = (e - want[i]["ema"][b][k]).abs()
                    assert float(torch.where(f, 0.0, de).max()) <= 1e-6, (i, b, k)
        if ls_ema:
            np.testing.assert_allclose(got[i]["loss_map"].numpy(), want[i]["loss_map"],
                                       rtol=0, atol=1e-6)
    if ls_ema:
        assert float((got[-1]["loss_map"] - 1.0).abs().max()) > 1e-3


@pytest.mark.parametrize("n", [2, 3])
def test_reduced_gradient_is_the_union_batch_gradient(sharded, n):
    """The ranks' mean gradient (p.grad after the sharded step) equals the
    gradient of one process over the union of their batches (batches of
    equal size, so the mean of the ranks' mean losses is the union's)."""
    _, outs, jobs = sharded[n]
    job = jobs["mlp"]
    local = -(-N_RAND // n)
    images, poses, K = _scene()
    rcfg = RenderConfig(**_rcfg_kw(False))
    ts, tcfg = port_state("mlp", job["params"])
    rays, tgts, ov = [], [], {"t_rand": [], "u": []}
    for r in range(n):
        spec = tpipe.PixelSamplerSpec.from_K(H, W, K, local, **_spec_kw())
        img, y, x = tpipe.sample_pixels(None, N_IMG, 0, spec, job["draws"][r][0])
        ro, rd, tg = tpipe.pixel_rays(torch.from_numpy(images), torch.from_numpy(poses),
                                      spec, img, y, x)
        rays.append((ro, rd))
        tgts.append(tg)
        for k in ov:
            ov[k].append(torch.from_numpy(job["overrides"][r][0][k]))
    from nerf_shared_tpu_torch.train.step import nerf_loss, pack_ray_batch

    batch = pack_ray_batch(torch.cat([a for a, _ in rays]), torch.cat([b for _, b in rays]),
                           rcfg, H, W, float(K[0, 0]))
    params = {b: m.params() for b, m in ts.branches()}
    loss, _ = nerf_loss(params, batch, torch.cat(tgts), rcfg, tcfg, tcfg,
                        overrides={k: torch.cat(v) for k, v in ov.items()})
    loss.backward()
    reduced = outs[0]["mlp"][0]["grads"]
    for key, p in ts.named_parameters().items():
        tol = 1e-5 * max(1.0, float(p.grad.abs().max()))
        torch.testing.assert_close(reduced[key], p.grad, rtol=1e-5, atol=tol, msg=str(key))


@pytest.fixture
def world_of_one(tmp_path):
    world = distributed.initialize("cpu", init_method=f"file://{tmp_path}/store1")
    try:
        yield world
    finally:
        distributed.shutdown(world)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("case", list(CASES))
def test_world_size_one_is_the_unsharded_step_bit_for_bit(sharded, world_of_one, case):
    """A process group of one rank (its collectives run): every output
    of the sharded step equals the unsharded step's exactly."""
    assert world_of_one.launched and world_of_one.size == 1
    params = sharded[2][2][case]["params"]
    # the steps' own generators draw (seeded by the step), the same in both
    a = run_port(case, params, None, None, None)
    b = run_port(case, params, world_of_one, None, None)
    for i in range(STEPS):
        for field in ("params", "grads"):
            for k, v in a[i][field].items():
                assert torch.equal(v, b[i][field][k]), (i, field, k)
        assert a[i]["aux"] == b[i]["aux"], i
        if a[i]["loss_map"] is not None:
            assert torch.equal(a[i]["loss_map"], b[i]["loss_map"])
            for br, e in a[i]["ema"].items():
                assert all(torch.equal(v, b[i]["ema"][br][k]) for k, v in e.items())


# --- the exact-epoch walk ---------------------------------------------------------------


@pytest.mark.parametrize("n,local", [(2, 7), (3, 5)])
def test_ranks_cut_the_global_exact_epoch_batch_into_parts(n, local):
    spec = tpipe.PixelSamplerSpec(H=4, W=5, fx=1.0, fy=1.0, cx=2.0, cy=2.0, N_rand=local,
                                  single_image=False, exact_epochs=True)
    whole = tpipe.PixelSamplerSpec(H=4, W=5, fx=1.0, fy=1.0, cx=2.0, cy=2.0,
                                   N_rand=n * local, single_image=False, exact_epochs=True)
    seen = []
    for step in range(6):
        parts = [tpipe.sample_pixels(None, 2, step, spec, rank=r, n_ranks=n)
                 for r in range(n)]
        want = tpipe.sample_pixels(None, 2, step, whole)
        for got, w in zip((torch.cat([p[j] for p in parts]) for j in range(3)), want):
            assert torch.equal(got, w)
        seen += (want[0] * 20 + want[1] * 5 + want[2]).tolist()
    # every pixel once per epoch (40 pixels), the walk going on across ranks
    assert sorted(seen[:40]) == list(range(40))


def test_jax_sharded_exact_epoch_walk_repeats_pixels():
    """The reference fault (ROADMAP C): JAX's sharded step offsets device d
    by d * local_n but advances the walk by local_n a step, so device d - 1
    at step s + 1 draws exactly device d's pixels of step s."""
    import jax
    import jax.numpy as jnp

    from nerf_shared_tpu.train import pipeline as jpipe

    n, local = 2, 6
    images, poses, K = _scene()
    spec = jpipe.PixelSamplerSpec.from_K(H, W, K, local, single_image=False,
                                         exact_epochs=True)
    key = jax.random.PRNGKey(0)

    def draw(step, d):
        return jpipe.sample_ray_batch(key, jnp.asarray(images), jnp.asarray(poses),
                                      jnp.asarray(step), spec, batch_offset=d * local)

    for s in range(3):
        for d in range(1, n):
            a, b = draw(s, d), draw(s + 1, d - 1)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    # the port's ranks draw the step's global batch: no repeat within an epoch
    tspec = tpipe.PixelSamplerSpec.from_K(H, W, K, local, single_image=False,
                                          exact_epochs=True)
    flat = []
    for s in range(N_IMG * H * W // (n * local)):
        for d in range(n):
            i, y, x = tpipe.sample_pixels(None, N_IMG, s, tspec, rank=d, n_ranks=n)
            flat += (i * H * W + y * W + x).tolist()
    assert len(set(flat)) == len(flat)


# --- the mesh and the CLI ---------------------------------------------------------------


def test_mesh_shape_is_checked_against_the_world():
    one, two = World(0, 1, "cpu", False), World(1, 2, "cpu", True)
    assert make_mesh(None, one) is one and make_mesh([1], one) is one
    assert make_mesh([2], two) is two and make_mesh([2, 1], two) is two
    with pytest.raises(NotImplementedError, match="parallel/tensor.py"):
        make_mesh([2, 2], two)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        make_mesh([2], one)
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        make_mesh([3], two)


def _tiny(tmp_path, **over):
    from tests.test_e2e import _write_config, _write_scene

    datadir = str(tmp_path / "scene")
    _write_scene(datadir)
    kw = dict(N_iters=20, i_print=10, i_weights=20, N_rand=32)
    kw.update(over)
    return _write_config(str(tmp_path), datadir, str(tmp_path / "logs"), **kw)


def test_two_ranks_train_through_the_cli(tmp_path):
    outs, logs = _spawn(str(tmp_path), 2, {"config": _tiny(tmp_path)})
    assert "WORLD_SIZE (2)" in outs[0]["mesh3"] and "WORLD_SIZE (2)" in outs[1]["mesh3"]
    for k, v in outs[0]["params"].items():
        assert torch.equal(v, outs[1]["params"][k]), k
    assert outs[0]["saves"] == [20, 20] and outs[1]["saves"] == []
    assert "[TRAIN] Iter: 20" in logs[0] and "[TRAIN]" not in logs[1]
    assert "data parallel: rank 1 of 2, 16 rays a rank a step" in logs[1]
    ckpts = sorted(os.listdir(str(tmp_path / "logs" / "tiny_e2e")))
    assert "000020.ckpt.npz" in ckpts


def test_mesh_of_two_axes_raises_in_the_trainer(tmp_path):
    from nerf_shared_tpu_torch.apps import train as tapp
    from nerf_shared_tpu_torch.config import config_parser

    args = config_parser().parse_args(["--config", _tiny(tmp_path), "--device", "cpu",
                                       "--mesh_shape", "2", "2"])
    with pytest.raises(NotImplementedError, match="tensor parallelism.*parallel/tensor.py"):
        tapp.train(args)


def test_multihost_without_a_launcher_trains_single_process(tmp_path, capsys, monkeypatch):
    from nerf_shared_tpu_torch.apps import train as tapp
    from nerf_shared_tpu_torch.config import config_parser

    for k in distributed.LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    cfg = _tiny(tmp_path, N_iters=4, i_print=2, i_weights=4)
    state = tapp.train(config_parser().parse_args(["--config", cfg, "--device", "cpu",
                                                   "--multihost", "True"]))
    out = capsys.readouterr().out
    assert "torch.distributed not initialized" in out and "single-process" in out
    assert state.step == 4 and not torch.distributed.is_initialized()


if __name__ == "__main__":
    _worker(sys.argv[1])
