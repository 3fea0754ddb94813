"""The port's occupancy-gated trainer on the CPU, against the JAX package:
the random-K selection, the density grid (init, binarize, whole-grid and
``max_probes`` refreshes), the occ loss and its gradients on an MLP and the
grid families, one full step with Adam from a state whose coarse moments
are non-zero, ``sync_coarse_from_fine``, and the CLI's two-phase schedule
(the steps of every refresh and of ``[PHASE]``, resume with and without a
re-sync).

The JAX functions take a key and have no draws seam, so the tests split
the key as they do and hand the draws to the port as numpy arrays:
``k_strat, k_sel, k_noise = split(key, 3)``, ``k_u, k_x = split(k_sel)``
for the loss; ``k_idx, k = split(key)``, ``split(k, n_blocks)`` for a
refresh. Every JAX network runs its plain path (``use_pallas`` off).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_shared_tpu.apps.train import run as j_run
from nerf_shared_tpu.config import config_parser as jax_parser
from nerf_shared_tpu.models import hashgrid as jhash
from nerf_shared_tpu.models import nerf as jnerf
from nerf_shared_tpu.models import triplane as jtri
from nerf_shared_tpu.render.renderer import RenderConfig as JRenderConfig
from nerf_shared_tpu.train import occ_train as JOT
from nerf_shared_tpu.train import pipeline as jpipe
from nerf_shared_tpu.train.state import create_train_state as j_create_state
from nerf_shared_tpu.train.state import sync_coarse_from_fine as j_sync
from nerf_shared_tpu.train.step import pack_ray_batch as j_pack
from nerf_shared_tpu_torch.apps import train as tapp
from nerf_shared_tpu_torch.models import hashgrid as thash
from nerf_shared_tpu_torch.models import nerf as tnerf
from nerf_shared_tpu_torch.models import triplane as ttri
from nerf_shared_tpu_torch.models.nerf import params_tree_from_jax
from nerf_shared_tpu_torch.parallel.distributed import World
from nerf_shared_tpu_torch.render.renderer import RenderConfig
from nerf_shared_tpu_torch.train import occ_train as TOT
from nerf_shared_tpu_torch.train import pipeline as tpipe
from nerf_shared_tpu_torch.train.state import create_train_state, sync_coarse_from_fine
from nerf_shared_tpu_torch.train.step import pack_ray_batch
from tests.test_e2e import _write_config, _write_scene
from tests.test_torch_grid_train import HASH_KW, TRI_KW
from tests.test_torch_train import _key_words, _scene

MLP_KW = dict(D=4, W=64, skips=(2,), use_viewdirs=True, multires=4,
              multires_views=2, output_ch=5)
FAMILIES = {
    "mlp": (jnerf.NeRFConfig, tnerf.NeRFConfig, MLP_KW),
    "hashgrid": (jhash.HashGridConfig, thash.HashGridConfig, HASH_KW),
    "triplane": (jtri.TriplaneConfig, ttri.TriplaneConfig, TRI_KW),
}
LO, HI = np.full(3, -1.5, np.float32), np.full(3, 1.5, np.float32)


def _to_port(family, tree):
    return (tnerf.params_from_jax(tree) if family == "mlp" else params_tree_from_jax(tree))


def _shared(family, seed=0, lrate=5e-3):
    jc, tc, kw = FAMILIES[family]
    jcfg, tcfg = jc(**kw), tc(**kw)
    jstate = j_create_state(jax.random.PRNGKey(seed), jcfg, jcfg, lrate=lrate,
                            lrate_decay=250)
    tstate = create_train_state(tcfg, tcfg, "cpu", lrate=lrate, lrate_decay=250)
    params = jax.device_get(jstate.params)
    for b, m in tstate.branches():
        m.load_state_dict(_to_port(family, params[b]), strict=True)
    return jcfg, jstate, tcfg, tstate


def _rcfgs(**kw):
    base = dict(N_samples=8, N_importance=8, use_viewdirs=True, white_bkgd=True,
                near=2.0, far=6.0, perturb=1.0)
    base.update(kw)
    return JRenderConfig(**base), RenderConfig(**base)


def _ema(G=8, seed=0, uninit=0.1):
    """A density EMA with a spread of values and some _UNINIT cells in its
    upper slabs along x; the lowest three slabs are empty."""
    rng = np.random.default_rng(seed)
    ema = (rng.random((G, G, G)) ** 3 * 40.0).astype(np.float32)
    ema[rng.random((G, G, G)) < 0.5] = 0.0
    ema[rng.random((G, G, G)) < uninit] = JOT._UNINIT
    ema[:3] = 0.0
    return ema


def _grids(ema):
    jd = JOT.DensityGrid(jnp.asarray(ema), jnp.asarray(LO), jnp.asarray(HI))
    td = TOT.DensityGrid(torch.from_numpy(ema), torch.from_numpy(LO), torch.from_numpy(HI))
    return jd, td


# --- _random_k_of_occupied ---------------------------------------------------


@pytest.mark.parametrize("explore,weighted", [(0.0, False), (0.3, False), (0.0, True),
                                              (0.2, True)])
def test_random_k_of_occupied_matches_jax_exactly(explore, weighted):
    rng = np.random.default_rng(3)
    R, C, K = 64, 24, 8
    z = np.sort(rng.uniform(2.0, 6.0, (R, C)), -1).astype(np.float32)
    occ = rng.random((R, C)) < np.linspace(0.05, 0.9, R)[:, None]
    w = (rng.random((R, C)) * 5.0).astype(np.float32) if weighted else None
    far = np.full((R, 1), 6.0, np.float32)
    key = jax.random.PRNGKey(11)
    jz, jv = JOT._random_k_of_occupied(key, jnp.asarray(z), jnp.asarray(occ), K,
                                       jnp.asarray(far), explore=explore,
                                       weights=None if w is None else jnp.asarray(w))
    k_u, k_x = jax.random.split(key)
    draws = {"u": np.asarray(jax.random.uniform(k_u, (R, C), minval=1e-7, maxval=1.0)),
             "explore_u": np.asarray(jax.random.uniform(k_x, (R, C)))}
    tz, tv = TOT._random_k_of_occupied(torch.from_numpy(z), torch.from_numpy(occ), K,
                                       torch.from_numpy(far), explore=explore,
                                       weights=None if w is None else torch.from_numpy(w),
                                       draws=draws)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    # fewer than K occupied candidates: all of them, padded at far
    assert (tv.numpy().sum(-1) <= K).all() and not tv.numpy().all()
    assert (np.diff(tz.numpy(), axis=-1) >= 0).all()


# --- the density grid ----------------------------------------------------------


@pytest.mark.parametrize("dilation,alpha", [(1, 1e-3), (0, 1e-2), (2, 0.5)])
def test_init_and_binarize_match_jax(dilation, alpha):
    ji = JOT.init_density_grid(LO, HI, 8)
    ti = TOT.init_density_grid(LO, HI, 8)
    np.testing.assert_array_equal(ti.ema.numpy(), np.asarray(ji.ema))
    np.testing.assert_array_equal(ti.aabb_min.numpy(), np.asarray(ji.aabb_min))
    assert bool(TOT.binarize_density_grid(ti).grid.all())
    jd, td = _grids(_ema())
    for force in (False, True):
        jb = JOT.binarize_density_grid(jd, alpha_threshold=alpha, dilation=dilation,
                                       force_occupied=force)
        tb = TOT.binarize_density_grid(td, alpha_threshold=alpha, dilation=dilation,
                                       force_occupied=force)
        np.testing.assert_array_equal(tb.grid.numpy(), np.asarray(jb.grid))
        assert (tb.sigma is None) == (jb.sigma is None) == force
        if not force:
            np.testing.assert_allclose(tb.sigma.numpy(), np.asarray(jb.sigma),
                                       rtol=1e-6, atol=1e-6)
            assert 0.0 < tb.occupied_fraction() < 1.0


def _refresh_draws(key, G, block, max_probes=None):
    """The draws of JAX's update_density_grid for ``key``."""
    n = G ** 3
    k_idx, k = jax.random.split(key)
    draws = {}
    m = n
    if max_probes is not None and max_probes < n:
        m = max_probes
        draws["idx"] = np.asarray(jax.random.randint(k_idx, (m,), 0, n))
    block = min(block, m)
    keys = jax.random.split(k, -(-m // block))
    draws["jitter"] = np.concatenate([np.asarray(jax.random.uniform(
        kk, (block, 3), minval=-0.5, maxval=0.5)) for kk in keys])[:m]
    return draws


@pytest.mark.parametrize("family,max_probes", [("mlp", None), ("mlp", 300),
                                               ("hashgrid", None), ("hashgrid", 200)])
def test_update_density_grid_matches_jax(family, max_probes):
    """Two refreshes (the first replaces _UNINIT, the second decays), whole
    grid and max_probes, blocks of 128 with a padded tail: within 1e-5
    relative. A cell drawn twice by max_probes keeps the largest of its
    updates in the port (JAX keeps one of them, unspecified): there the
    port is at least JAX's value."""
    jcfg, jstate, tcfg, tstate = _shared(family, seed=2)
    jr, tr = _rcfgs()
    G = 8
    ema = _ema(G, seed=4, uninit=0.3)
    jd, td = _grids(ema)
    for rep in range(2):
        key = jax.random.PRNGKey(20 + rep)
        draws = _refresh_draws(key, G, 128, max_probes)
        jd = JOT.update_density_grid(jd, jstate.params["fine"], jcfg, jr, key, decay=0.9,
                                     block=128, max_probes=max_probes)
        td = TOT.update_density_grid(td, tstate.fine.params(), tcfg, tr, decay=0.9,
                                     block=128, max_probes=max_probes, draws=draws)
        got, want = td.ema.numpy().ravel(), np.asarray(jd.ema).ravel()
        dup = np.zeros(G ** 3, bool)
        if max_probes is not None:
            idx, cnt = np.unique(draws["idx"], return_counts=True)
            dup[idx[cnt > 1]] = True
            assert dup.any() and (got[dup] >= want[dup] * (1 - 1e-5) - 1e-6).all()
        np.testing.assert_allclose(got[~dup], want[~dup], rtol=1e-5, atol=1e-6)
        # keep both sides on one grid for the next pass
        jd = jd._replace(ema=jnp.asarray(got.reshape(G, G, G)))
    assert (got < JOT._UNINIT).sum() > 0


# --- the loss and the step -------------------------------------------------------


def _rays(N=48, seed=5):
    rng = np.random.default_rng(seed)
    ro = (rng.standard_normal((N, 3)) * 0.2 + [0, 0, 4]).astype(np.float32)
    rd = (rng.standard_normal((N, 3)) * 0.25 + [0, 0, -1]).astype(np.float32)
    tgt = rng.random((N, 3)).astype(np.float32)
    return ro, rd, tgt


def _loss_draws(key, N, C, K, noise_std):
    k_strat, k_sel, k_noise = jax.random.split(key, 3)
    k_u, k_x = jax.random.split(k_sel)
    return {"t_rand": np.asarray(jax.random.uniform(k_strat, (N, C))),
            "u": np.asarray(jax.random.uniform(k_u, (N, C), minval=1e-7, maxval=1.0)),
            "explore_u": np.asarray(jax.random.uniform(k_x, (N, C))),
            "noise": np.asarray(jax.random.normal(k_noise, (N, K))) * np.float32(noise_std)}


@pytest.mark.parametrize("family,budget,tv_reg", [("mlp", False, 0.0), ("mlp", True, 0.0),
                                                  ("hashgrid", True, 0.0),
                                                  ("triplane", False, 0.1)])
def test_occ_nerf_loss_and_gradients_match_jax(family, budget, tv_reg):
    """Loss and every aux to 1e-5 relative, the fine gradients to 1e-3 of
    each tensor's max, zero coarse gradients; sigma noise 1, explore 0.1,
    a grid with occupied and empty cells, budgeting by the EMA."""
    jcfg, jstate, tcfg, tstate = _shared(family, seed=6)
    jr, tr = _rcfgs(raw_noise_std=1.0)
    ro, rd, tgt = _rays()
    C, K, N = 16, 6, ro.shape[0]
    jd, td = _grids(_ema(seed=7, uninit=0.05))
    jocc = JOT.binarize_density_grid(jd)
    tocc = TOT.binarize_density_grid(td)
    key = jax.random.PRNGKey(31)
    jb = j_pack(jnp.asarray(ro), jnp.asarray(rd), jr, 8, 8, 10.0)
    (jl, jaux), jg = jax.value_and_grad(JOT.occ_nerf_loss, has_aux=True)(
        jstate.params, jocc, jb, jnp.asarray(tgt), key, jr, jcfg, C, K, explore=0.1,
        density=jd if budget else None, tv_reg=tv_reg)
    tb = pack_ray_batch(torch.from_numpy(ro), torch.from_numpy(rd), tr, 8, 8, 10.0)
    params = {b: m.params() for b, m in tstate.branches()}
    tl, taux = TOT.occ_nerf_loss(params, tocc, tb, torch.from_numpy(tgt), tr, tcfg, C, K,
                                 explore=0.1, density=td if budget else None,
                                 tv_reg=tv_reg, draws=_loss_draws(key, N, C, K, 1.0))
    tl.backward()
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    assert sorted(taux) == sorted(jaux)
    for k in jaux:
            assert float(taux[k].detach()) == pytest.approx(float(jaux[k]), rel=1e-5), k
    assert 0 < float(taux["n_active_mean"]) < K
    want = _to_port(family, jax.device_get(jg["fine"]))
    for k, p in tstate.fine.named_parameters():
        tol = 1e-3 * max(1e-6, float(want[k].abs().max()))
        torch.testing.assert_close(p.grad, want[k], rtol=0, atol=tol, msg=k)
    assert all(p.grad is None for p in tstate.coarse.parameters())
    assert all(not np.asarray(g).any() for g in jax.tree_util.tree_leaves(jg["coarse"]))


def _warm_moments(jstate, tstate, family, seed=8):
    """One Adam update from random gradients on both sides, so every
    moment (the coarse branch's too) is non-zero."""
    rng = np.random.default_rng(seed)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)),
        jstate.params)
    jstate = jstate.apply_gradients(grads)
    for b, m in tstate.branches():
        g = _to_port(family, jax.device_get(grads[b]))
        for k, p in m.named_parameters():
            p.grad = g[k].clone()
    tstate.apply_gradients()
    return jstate


@pytest.mark.parametrize("family", ["mlp", "hashgrid"])
def test_occ_step_with_adam_moves_coarse_as_jax(family):
    """One make_occ_train_step step from a state with non-zero coarse Adam
    moments: the coarse branch's zero gradients decay its moments and move
    it as optax does (to 1e-6); the fine branch to 1e-6 on 98% of its
    entries and within 2 lr on all (Adam's g / (|g| + eps) turns the last
    fp32 digits of a gradient near zero into up to 2 lr, as in the
    trajectory test of tests/test_torch_train.py)."""
    jcfg, jstate, tcfg, tstate = _shared(family, seed=9)
    jstate = _warm_moments(jstate, tstate, family)
    jr, tr = _rcfgs(raw_noise_std=0.5)
    images, poses, Kmat = _scene(n=3, H=8, W=8, seed=4)
    kw = dict(single_image=True, precrop_iters=0)
    jspec = jpipe.PixelSamplerSpec.from_K(8, 8, Kmat, 16, **kw)
    tspec = tpipe.PixelSamplerSpec.from_K(8, 8, Kmat, 16, **kw)
    C, K = 12, 5
    jd, td = _grids(_ema(seed=10, uninit=0.0))
    before_c = {k: v.detach().clone() for k, v in tstate.coarse.named_parameters()}
    key = jax.random.PRNGKey(41)
    jstep = JOT.make_occ_train_step(jr, jcfg, jspec, n_candidates=C, n_keep=K,
                                    explore=0.05, donate=False)
    jstate2, _ = jstep(jstate, JOT.binarize_density_grid(jd), jnp.asarray(images),
                       jnp.asarray(poses), key)
    k_sample, k_render = jax.random.split(key)
    k_img, k_y, k_x = jax.random.split(k_sample, 3)
    draws = {"img_idx": int(jax.random.randint(k_img, (), 0, 3)),
             "key_y": _key_words(k_y), "key_x": _key_words(k_x),
             **_loss_draws(k_render, 16, C, K, 0.5)}
    tstep = TOT.make_occ_train_step(tr, tcfg, tspec, n_candidates=C, n_keep=K,
                                    explore=0.05)
    aux = tstep(tstate, TOT.binarize_density_grid(td), torch.from_numpy(images),
                torch.from_numpy(poses), torch.Generator().manual_seed(0), draws=draws)
    assert sorted(aux) == ["acc_mean", "img_loss", "loss", "n_active_mean", "psnr"]
    assert tstate.step == tstate.count == 2 == int(jstate2.step)
    for branch, m in tstate.branches():
        want = _to_port(family, jax.device_get(jstate2.params[branch]))
        for k, p in m.named_parameters():
            d = (p.detach() - want[k]).abs()
            if branch == "coarse":
                assert float(d.max()) <= 1e-6, k
                assert float((p.detach() - before_c[k]).abs().max()) > 0, k
            else:
                assert float(d.max()) <= 2 * 5e-3 + 1e-6, k
                assert float(torch.quantile(d.flatten(), 0.98)) <= 1e-6, k


def test_sync_coarse_from_fine_matches_jax():
    """Parameters and both Adam moments copied from fine to coarse as JAX
    copies them (the step counts too), into distinct tensors; a later
    update of the fine branch leaves the coarse copy alone."""
    jcfg, jstate, tcfg, tstate = _shared("mlp", seed=12)
    jstate = _warm_moments(jstate, tstate, "mlp", seed=13)
    jstate = _warm_moments(jstate, tstate, "mlp", seed=14)
    js = j_sync(jstate)
    assert sync_coarse_from_fine(tstate) is tstate
    want = tnerf.params_from_jax(jax.device_get(js.params["coarse"]))
    opt = tstate.optimizer.state
    adam = next(s for s in jax.tree_util.tree_leaves(
        js.opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu"))
    mu = tnerf.params_from_jax(jax.device_get(adam.mu["coarse"]))
    nu = tnerf.params_from_jax(jax.device_get(adam.nu["coarse"]))
    fine = tstate.fine.params()
    for k, p in tstate.coarse.named_parameters():
        torch.testing.assert_close(p.detach(), fine[k].detach(), rtol=0, atol=0, msg=k)
        for n in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(opt[p][n], opt[fine[k]][n], rtol=0, atol=0, msg=k)
        torch.testing.assert_close(p.detach(), want[k], rtol=0, atol=1e-6, msg=k)
        torch.testing.assert_close(opt[p]["exp_avg"], mu[k], rtol=1e-5, atol=1e-7, msg=k)
        torch.testing.assert_close(opt[p]["exp_avg_sq"], nu[k], rtol=1e-5, atol=1e-7, msg=k)
        assert int(opt[p]["step"]) == int(adam.count) == 2
        assert opt[p]["exp_avg"].data_ptr() != opt[fine[k]]["exp_avg"].data_ptr()
        assert p.data_ptr() != fine[k].data_ptr()
    synced = {k: v.detach().clone() for k, v in fine.items()}
    tstate.optimizer.zero_grad(set_to_none=True)
    for p in tstate.fine.parameters():
        p.grad = torch.ones_like(p)
    tstate.optimizer.step()
    for k, p in tstate.coarse.named_parameters():
        torch.testing.assert_close(p.detach(), synced[k], rtol=0, atol=0, msg=k)
        assert not torch.equal(fine[k].detach(), synced[k]), k
    cfg2 = tnerf.NeRFConfig(**{**MLP_KW, "W": 32})
    other = create_train_state(tcfg, cfg2, "cpu")
    with pytest.raises(ValueError, match="one architecture"):
        sync_coarse_from_fine(other)


def test_occ_step_guards_match_jax():
    """n_keep > n_candidates raises JAX's ValueError; a data-parallel world
    builds the sharded step (tests/test_torch_parallel.py runs it), where
    the step took no mesh before."""
    jr, tr = _rcfgs()
    cfg = tnerf.NeRFConfig(**MLP_KW)
    spec = tpipe.PixelSamplerSpec(H=4, W=4, fx=1, fy=1, cx=2, cy=2, N_rand=4)
    jspec = jpipe.PixelSamplerSpec(H=4, W=4, fx=1, fy=1, cx=2, cy=2, N_rand=4)
    with pytest.raises(ValueError) as jerr:
        JOT.make_occ_train_step(jr, jnerf.NeRFConfig(**MLP_KW), jspec, n_candidates=8,
                                n_keep=9)
    with pytest.raises(ValueError) as terr:
        TOT.make_occ_train_step(tr, cfg, spec, n_candidates=8, n_keep=9)
    assert str(terr.value) == str(jerr.value)
    assert callable(TOT.make_occ_train_step(tr, cfg, spec, world=World(0, 2, "cpu", True)))


# --- the CLI -----------------------------------------------------------------------


def _record(monkeypatch, module, events):
    """Wrap ``module``'s make_occ_train_step and update_density_grid: each
    step records ("step", state.step, the step's sigma noise), each refresh
    ("refresh",)."""
    make, update = module.make_occ_train_step, module.update_density_grid

    def make_rec(rcfg, *a, **kw):
        fn = make(rcfg, *a, **kw)

        def step(state, *args, **kwargs):
            events.append(("step", int(state.step), float(rcfg.raw_noise_std)))
            return fn(state, *args, **kwargs)

        return step

    def update_rec(*a, **kw):
        events.append(("refresh",))
        return update(*a, **kw)

    monkeypatch.setattr(module, "make_occ_train_step", make_rec)
    monkeypatch.setattr(module, "update_density_grid", update_rec)


def _schedule(events, inner):
    """(refresh steps, {step: noise}) from recorded events; a JAX event is
    a dispatch of ``inner`` steps, a port event one step."""
    refresh, noise, last = [], {}, None
    for e in events:
        if e[0] == "step":
            for s in range(e[1], e[1] + inner):
                noise[s] = e[2]
            last = e[1] + inner
        else:
            refresh.append(last)
    return refresh, noise


def test_cli_two_phase_schedule_matches_jax(tmp_path, monkeypatch, capsys):
    """--train_occ --train_occ_until 7 with cadences whose gcd is 2 (i_print
    2, i_weights 4): the steps of every density-grid refresh, the warm-up
    steps (sigma noise) and the [PHASE] line equal the JAX trainer's; a
    resume from step 12 (past the switching dispatch) enters the
    hierarchical phase without a re-sync, and a resume from step 8 (the end
    of the last occ-gated dispatch) switches and syncs, as JAX does."""
    root = str(tmp_path)
    datadir = os.path.join(root, "scene")
    os.makedirs(datadir)
    _write_scene(datadir)
    occ = ["--train_occ", "True", "--train_occ_until", "7", "--train_occ_res", "8",
           "--train_occ_candidates", "12", "--train_occ_keep", "6",
           "--train_occ_warmup", "3", "--train_occ_probe_budget", "100"]
    common = dict(N_iters=12, i_print=2, i_weights=4, i_testset=0, i_img=0)
    for name in ("j", "t"):
        os.makedirs(os.path.join(root, name))
    jcfg, tcfg = (_write_config(os.path.join(root, name), datadir,
                                os.path.join(root, f"{name}logs"), expname=name, **common)
                  for name in ("j", "t"))

    jev, tev = [], []
    _record(monkeypatch, JOT, jev)
    j_run(jax_parser().parse_args(["--config", jcfg] + occ))
    jout = capsys.readouterr().out
    _record(monkeypatch, TOT, tev)
    syncs = []
    monkeypatch.setattr(tapp, "sync_coarse_from_fine",
                        lambda st: syncs.append(st.step) or sync_coarse_from_fine(st))
    state = tapp.main(["--config", tcfg, "--device", "cpu"] + occ)
    tout = capsys.readouterr().out

    def phase(out):
        return [ln for ln in out.splitlines() if ln.startswith("[PHASE]")]

    assert phase(tout) == phase(jout) == [
        "[PHASE] step 8: occ -> hierarchical; coarse seeded from fine (+Adam moments)"]
    jref, jnoise = _schedule(jev, 2)
    tref, tnoise = _schedule(tev, 1)
    assert tref == jref == [2, 4, 6, 8]
    assert tnoise == jnoise and sorted(tnoise) == list(range(8))
    assert [tnoise[s] for s in range(8)] == [1.0] * 4 + [0.0] * 4
    assert syncs == [8] and state.step == 12
    assert "refreshed per dispatch of 2 steps" in tout

    # resume past the switching dispatch: no re-sync, as JAX
    tev.clear()
    tapp.main(["--config", tcfg, "--device", "cpu", "--N_iters", "14"] + occ)
    jev.clear()
    j_run(jax_parser().parse_args(["--config", jcfg, "--N_iters", "14"] + occ))
    out = capsys.readouterr().out
    assert phase(out) == ["[PHASE] resume at step 13 > 7: hierarchical phase"] * 2
    assert syncs == [8] and tev == [] and jev == []

    # resume from the checkpoint at the end of the last occ-gated dispatch
    for name, cfg in (("t", tcfg), ("j", jcfg)):
        logdir = os.path.join(root, f"{name}logs", name)
        for f in os.listdir(logdir):
            if f[:6].isdigit() and int(f[:6]) > 8:
                os.remove(os.path.join(logdir, f))
    tapp.main(["--config", tcfg, "--device", "cpu", "--N_iters", "10"] + occ)
    j_run(jax_parser().parse_args(["--config", jcfg, "--N_iters", "10"] + occ))
    out = capsys.readouterr().out
    assert phase(out) == [
        "[PHASE] step 8: occ -> hierarchical; coarse seeded from fine (+Adam moments)"] * 2
    assert syncs == [8, 8]


def test_cli_hooks_render_through_the_training_grid(tmp_path, monkeypatch, capsys):
    """Before the switch the render hooks go through the occupancy engine on
    the training grid (all occupied while warming up), after it the dense
    hierarchical path; --warmup_noise is off under --train_occ."""
    root = str(tmp_path)
    datadir = os.path.join(root, "scene")
    os.makedirs(datadir)
    _write_scene(datadir)
    cfg = _write_config(root, datadir, os.path.join(root, "logs"), expname="h",
                        N_iters=8, i_print=2, i_weights=8, i_testset=0, i_img=2)
    seen = []
    from nerf_shared_tpu_torch.render.renderer import Renderer

    render = Renderer.render_from_batch_poses

    def spy(self, *a, **kw):
        g = kw.get("occ_grid")
        seen.append(None if g is None else float(g.grid.float().mean()))
        return render(self, *a, **kw)

    monkeypatch.setattr(Renderer, "render_from_batch_poses", spy)
    built = []
    make_train_step = tapp.make_train_step
    monkeypatch.setattr(tapp, "make_train_step",
                        lambda rcfg, *a, **kw: built.append(rcfg.raw_noise_std)
                        or make_train_step(rcfg, *a, **kw))
    tapp.main(["--config", cfg, "--device", "cpu", "--train_occ", "True",
               "--train_occ_until", "4", "--train_occ_res", "8",
               "--train_occ_warmup", "3", "--warmup_noise", "100"])
    out = capsys.readouterr().out
    assert out.count("[VAL]") == 4
    assert seen[0] == 1.0 and seen[1] is not None and seen[2:] == [None, None]
    assert built == [0.0]


def test_cli_last_window_stops_at_n_iters(tmp_path, monkeypatch):
    """N_iters 5 in dispatches of 2 steps: the JAX trainer's last dispatch
    runs both its steps (to step 6) and refreshes after it; the port stops
    at step 5 and refreshes there (a deliberate difference, ROADMAP C)."""
    root = str(tmp_path)
    datadir = os.path.join(root, "scene")
    os.makedirs(datadir)
    _write_scene(datadir)
    occ = ["--train_occ", "True", "--train_occ_res", "8", "--train_occ_candidates", "12",
           "--train_occ_keep", "6", "--train_occ_warmup", "0"]
    jev, tev = [], []
    cfgs = {}
    for name in ("j", "t"):
        os.makedirs(os.path.join(root, name))
        cfgs[name] = _write_config(os.path.join(root, name), datadir,
                                   os.path.join(root, f"{name}logs"), expname=name,
                                   N_iters=5, i_print=2, i_weights=4, i_testset=0, i_img=0)
    _record(monkeypatch, JOT, jev)
    j_run(jax_parser().parse_args(["--config", cfgs["j"]] + occ))
    _record(monkeypatch, TOT, tev)
    state = tapp.main(["--config", cfgs["t"], "--device", "cpu"] + occ)
    assert _schedule(jev, 2)[0] == [2, 4, 6]
    assert _schedule(tev, 1)[0] == [2, 4, 5] and state.step == 5
