"""The port's proposal sampler on the CPU, against the JAX package.

- ``distortion_loss`` and ``interlevel_loss`` (ops/compositing.py): values
  and gradients to 1e-6 of max(1, max|.|).
- ``factory.nerf_configs`` under --proposal for the MLP, hashgrid and
  triplane families, and the N_importance 0 raise.
- ``render_rays`` under ``RenderConfig.proposal`` for the MLP and the mixed
  hashgrid hierarchy, draws pinned: every returned map to 1e-5, the
  proposal histogram as ``weights0`` / ``z_vals0``, no ``rgb0``.
- The proposal network never reaches a kernel wrapper (``fused_train_op``,
  ``fused_nerf_forward``, ``fused_nerf_forward_rays``, ``fused_render_rays``)
  whatever the flags say, while the fine network keeps its routes.
- ``nerf_loss`` with the interlevel and distortion losses: the loss to
  1e-5 relative and every gradient leaf to 1e-4 of its tensor's max.
- The mixed hierarchy's Adam groups; the gated renderer's refusal; a
  ``.tar`` of a mixed hierarchy refused.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_shared_tpu.config import config_parser as jax_parser
from nerf_shared_tpu.factory import nerf_configs as j_nerf_configs
from nerf_shared_tpu.models import hashgrid as jhash
from nerf_shared_tpu.models import nerf as jnerf
from nerf_shared_tpu.ops.compositing import distortion_loss as j_distortion
from nerf_shared_tpu.ops.compositing import interlevel_loss as j_interlevel
from nerf_shared_tpu.render import renderer as JR
from nerf_shared_tpu.train.state import create_train_state as j_create_state
from nerf_shared_tpu.train.step import nerf_loss as j_nerf_loss
from nerf_shared_tpu.train.step import pack_ray_batch as j_pack
from nerf_shared_tpu_torch.config import config_parser
from nerf_shared_tpu_torch.factory import nerf_configs
from nerf_shared_tpu_torch.models import hashgrid as thash
from nerf_shared_tpu_torch.models import nerf as tnerf
from nerf_shared_tpu_torch.ops.compositing import distortion_loss, interlevel_loss
from nerf_shared_tpu_torch.render import renderer as TR
from nerf_shared_tpu_torch.train.state import create_train_state
from nerf_shared_tpu_torch.train.step import nerf_loss, pack_ray_batch
from nerf_shared_tpu_torch.utils import checkpoints as tckpt
from tests.test_torch_train import _batch, _overrides

PROP_KW = dict(D=2, W=16, output_ch=4, skips=(4,), use_viewdirs=False, multires=4,
               multires_views=2)
FINE_KW = dict(D=3, W=32, skips=(1,), use_viewdirs=True, multires=4,
               multires_views=2, output_ch=5)
HASH_KW = dict(L=3, log2_T=7, F=2, base_res=4, max_res=16, hidden=16, geo_feat=7,
               rgb_depth=2, layout="split", aabb_min=(-3.0,) * 3, aabb_max=(3.0,) * 3)


def to_torch(tree):
    """A JAX branch pytree (MLP or grid) -> the port's state dict."""
    if "pts_linears" in tree:
        return tnerf.params_from_jax(tree)
    return tnerf.params_tree_from_jax(tree)


def _shared(family="nerf", seed=0, lrate=5e-4):
    """A proposal MLP coarse and an MLP (or split hashgrid) fine: the JAX
    TrainState and the port's with the same weights."""
    jp = jnerf.NeRFConfig(**PROP_KW)
    tp = tnerf.NeRFConfig(**PROP_KW)
    if family == "nerf":
        jf, tf = jnerf.NeRFConfig(**FINE_KW), tnerf.NeRFConfig(**FINE_KW)
    else:
        jf, tf = jhash.HashGridConfig(**HASH_KW), thash.HashGridConfig(**HASH_KW)
    jstate = j_create_state(jax.random.PRNGKey(seed), jp, jf, lrate=lrate, lrate_decay=250)
    tstate = create_train_state(tp, tf, "cpu", lrate=lrate, lrate_decay=250)
    params = jax.device_get(jstate.params)
    for b, m in tstate.branches():
        m.load_state_dict(to_torch(params[b]), strict=True)
    return (jp, jf, jstate), (tp, tf, tstate)


def _rcfgs(**kw):
    base = dict(N_samples=8, N_importance=8, use_viewdirs=True, white_bkgd=True,
                near=2.0, far=6.0, proposal=True)
    base.update(kw)
    return JR.RenderConfig(**base), TR.RenderConfig(**base)


def _hist(N=12, Sp=9, Sf=17, seed=0):
    """Sorted proposal and fine depths in [2, 6] and positive weights."""
    rng = np.random.default_rng(seed)
    zp = np.sort(rng.uniform(2, 6, (N, Sp)), -1).astype(np.float32)
    zf = np.sort(rng.uniform(2, 6, (N, Sf)), -1).astype(np.float32)
    wp = (rng.random((N, Sp)) / Sp * 1.5).astype(np.float32)
    wf = (rng.random((N, Sf)) / Sf * 1.5).astype(np.float32)
    return zp, wp, zf, wf


def _close(got, want, tol=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


# --- ops/compositing.py -------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_distortion_loss_and_gradients_match_jax(seed):
    _, _, z, w = _hist(seed=seed)
    jl, (jgz, jgw) = jax.value_and_grad(
        lambda a, b: j_distortion(a, b, 2.0, 6.0), argnums=(0, 1))(jnp.asarray(z),
                                                                 jnp.asarray(w))
    tz, tw = torch.from_numpy(z).requires_grad_(), torch.from_numpy(w).requires_grad_()
    tl = distortion_loss(tz, tw, 2.0, 6.0)
    tl.backward()
    _close(tl, jl)
    _close(tz.grad, jgz)
    _close(tw.grad, jgw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interlevel_loss_and_gradients_match_jax(seed):
    """The gradient reaches the proposal's depths and weights only: the
    fine histogram's are zero in both."""
    arrs = _hist(seed=seed)
    jl, jg = jax.value_and_grad(j_interlevel, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, arrs))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrs]
    tl = interlevel_loss(*ts)
    tl.backward()
    _close(tl, jl)
    assert float(tl.detach()) > 0
    for t, g in zip(ts, jg):
        _close(t.grad if t.grad is not None else torch.zeros_like(t), g)
    assert ts[2].grad is None and ts[3].grad is None
    assert not np.asarray(jg[2]).any() and not np.asarray(jg[3]).any()


# --- factory.py ---------------------------------------------------------------


@pytest.mark.parametrize("family", ["nerf", "hashgrid", "triplane"])
def test_proposal_configs_match_jax(family):
    argv = ["--proposal", "True", "--N_importance", "64", "--proposal_depth", "3",
            "--proposal_width", "32", "--model_type", family, "--hash_levels", "4"]
    jc, jf = j_nerf_configs(jax_parser().parse_args(argv))
    tc, tf = nerf_configs(config_parser().parse_args(argv))
    assert isinstance(tc, tnerf.NeRFConfig)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert (tc.D, tc.W, tc.output_ch, tc.use_viewdirs) == (3, 32, 4, False)
    assert type(tf).__name__ == type(jf).__name__
    assert dataclasses.asdict(tf) == dataclasses.asdict(jf)


@pytest.mark.parametrize("family", ["nerf", "hashgrid", "triplane"])
def test_proposal_without_importance_samples_raises(family):
    argv = ["--proposal", "True", "--N_importance", "0", "--model_type", family]
    with pytest.raises(ValueError, match="N_importance"):
        j_nerf_configs(jax_parser().parse_args(argv))
    with pytest.raises(ValueError, match="N_importance"):
        nerf_configs(config_parser().parse_args(argv))


# --- render/renderer.py -------------------------------------------------------


def _rays(jr, tr, N=24, seed=2):
    ro, rd, target = _batch(N=N, seed=seed)
    jb = j_pack(jnp.asarray(ro), jnp.asarray(rd), jr, 8, 8, 10.0)
    tb = pack_ray_batch(torch.from_numpy(ro), torch.from_numpy(rd), tr, 8, 8, 10.0)
    return jb, tb, target


@pytest.mark.parametrize("family", ["nerf", "hashgrid"])
@pytest.mark.parametrize("retweights", [True, False])
def test_proposal_render_rays_matches_jax(family, retweights):
    """perturb 1 with t_rand and u pinned: every map to 1e-5; the proposal
    histogram is weights0 / z_vals0 (with retweights); no rgb0 / disp0 /
    acc0 in either package."""
    (jp, jf, jstate), (tp, tf, tstate) = _shared(family, seed=4)
    jr, tr = _rcfgs(perturb=1.0)
    jb, tb, _ = _rays(jr, tr)
    ov = _overrides(24, 8, 8, seed=5)
    want = JR.render_rays(jstate.params["coarse"], jstate.params["fine"], jb,
                          jax.random.PRNGKey(0), jr, jp, jf, retweights=retweights,
                          overrides={k: jnp.asarray(v) for k, v in ov.items()})
    with torch.no_grad():
        got = TR.render_rays(tstate.coarse.params(), tstate.fine.params(), tb, tr, tp, tf,
                             retweights=retweights,
                             overrides={k: torch.from_numpy(v) for k, v in ov.items()})
    assert set(got) == set(want)
    assert not {"rgb0", "disp0", "acc0"} & set(got)
    assert ({"weights0", "z_vals0", "weights", "z_vals"} <= set(got)) == retweights
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    if retweights:
        assert got["z_vals0"].shape == (24, 8) and got["z_vals"].shape == (24, 16)


def _route_recorder(monkeypatch):
    """Replace each kernel wrapper the renderer calls with its plain path,
    recording the network configs it is handed."""
    seen = []

    def record(name, fn):
        def wrapper(params, cfg, *a, **k):
            seen.append((name, cfg))
            return fn(params, cfg, *a, **k)
        monkeypatch.setattr(TR, name, wrapper)

    for name in ("fused_train_op", "fused_nerf_forward", "fused_nerf_forward_rays",
                 "fused_render_rays"):
        record(name, getattr(TR, name))
    return seen


@pytest.mark.parametrize("flags,fine_route", [
    (dict(fused_backward=True), "fused_train_op"),
    (dict(use_pallas=True), "fused_nerf_forward_rays"),
    (dict(use_pallas=True, fused_composite=True), "fused_render_rays"),
    (dict(use_pallas=True, fused_backward=True), "fused_train_op"),
])
def test_proposal_network_never_reaches_a_kernel_wrapper(monkeypatch, flags, fine_route):
    """Under each kernel flag the fine MLP takes its kernel's wrapper and
    the proposal MLP none (JAX runs it through plain XLA); the maps equal
    the all-flags-off render's on the CPU."""
    (_, _, _), (tp, tf, tstate) = _shared("nerf", seed=6)
    _, tr_off = _rcfgs(perturb=0.0)
    tr_on = dataclasses.replace(tr_off, **flags)
    _, tb, _ = _rays(JR.RenderConfig(N_samples=8, N_importance=8, near=2.0, far=6.0),
                     tr_off)
    seen = _route_recorder(monkeypatch)
    with torch.no_grad():
        got = TR.render_rays(tstate.coarse.params(), tstate.fine.params(), tb, tr_on,
                             tp, tf, retweights=True)
        want = TR.render_rays(tstate.coarse.params(), tstate.fine.params(), tb, tr_off,
                              tp, tf, retweights=True)
    assert all(cfg is not tp for _, cfg in seen), seen
    assert (fine_route, tf) in seen
    for k in ("rgb_map", "acc_map", "weights0"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-6, msg=k)


def test_proposal_coarse_in_the_guided_engine_takes_the_plain_route(monkeypatch):
    """The guided fine pass (48 placed samples in the card's engine) under
    a proposal coarse: the proposal stays plain, the fine pass runs
    through B3's wrapper; the frame equals the plain render's."""
    (_, _, _), (tp, tf, tstate) = _shared("nerf", seed=7)
    _, tr_off = _rcfgs(perturb=0.0, guided=6)
    _, tb, _ = _rays(JR.RenderConfig(N_samples=8, N_importance=8, near=2.0, far=6.0),
                     tr_off)
    seen = _route_recorder(monkeypatch)
    with torch.no_grad():
        got = TR.render_rays(tstate.coarse.params(), tstate.fine.params(), tb,
                             dataclasses.replace(tr_off, use_pallas=True), tp, tf)
        want = TR.render_rays(tstate.coarse.params(), tstate.fine.params(), tb, tr_off,
                              tp, tf)
    assert seen == [("fused_nerf_forward_rays", tf)]
    torch.testing.assert_close(got["rgb_map"], want["rgb_map"], rtol=1e-6, atol=1e-6)


def test_gated_renderer_refuses_the_proposal():
    (_, _, _), (tp, tf, tstate) = _shared("nerf", seed=8)
    r = TR.Renderer(N_samples=8, N_importance=8, near=2.0, far=6.0, proposal=True)
    K = np.array([[10.0, 0, 4], [0, 10.0, 4], [0, 0, 1]])
    c2w = np.eye(4)[:3]
    with pytest.raises(ValueError, match="density-only"):
        r.render_image_gated(8, 8, K, c2w, tstate.coarse, tstate.fine)
    with pytest.raises(ValueError, match="density-only"):
        JR.Renderer(N_samples=8, N_importance=8, near=2.0, far=6.0,
                    proposal=True).render_image_gated(8, 8, K, c2w, None, None)


# --- train/step.py nerf_loss ----------------------------------------------------


@pytest.mark.parametrize("family", ["nerf", "hashgrid"])
@pytest.mark.parametrize("prop_reg,dist_reg", [(1.0, 0.0), (0.5, 0.01), (1.0, 0.1)])
def test_nerf_loss_with_interlevel_and_distortion_matches_jax(family, prop_reg, dist_reg):
    """perturb 0 and no noise: JAX's nerf_loss draws nothing and runs as it
    is. Loss and each aux to 1e-5 relative; every gradient leaf of both
    branches to 1e-4 of its tensor's max. Seed 10 gives both families a
    live proposal at init (at some seeds its densities are all negative,
    and the interlevel loss has no gradient)."""
    (jp, jf, jstate), (tp, tf, tstate) = _shared(family, seed=10)
    jr, tr = _rcfgs(perturb=0.0)
    jb, tb, target = _rays(jr, tr)
    (jl, jaux), jg = jax.value_and_grad(j_nerf_loss, has_aux=True)(
        jstate.params, jb, jnp.asarray(target), jax.random.PRNGKey(0), jr, jp, jf,
        prop_reg=prop_reg, dist_reg=dist_reg)
    params = {b: m.params() for b, m in tstate.branches()}
    tl, taux = nerf_loss(params, tb, torch.from_numpy(target), tr, tp, tf,
                         prop_reg=prop_reg, dist_reg=dist_reg)
    tl.backward()
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    assert set(taux) == set(jaux)
    assert "img_loss0" not in taux and ("dist_loss" in taux) == (dist_reg > 0)
    for k in jaux:
        assert float(taux[k]) == pytest.approx(float(jaux[k]), rel=1e-5, abs=1e-7), k
    for b, m in tstate.branches():
        want = to_torch(jax.device_get(jg[b]))
        for k, p in m.named_parameters():
            w = want[k]
            torch.testing.assert_close(p.grad, w, rtol=1e-4,
                                       atol=1e-4 * max(1.0, float(w.abs().max())),
                                       msg=f"{b} {k}")
        assert any(float(p.grad.abs().max()) > 0 for p in m.parameters()), b


def test_nerf_loss_returns_the_per_ray_error():
    (_, _, _), (tp, tf, tstate) = _shared("nerf", seed=11)
    _, tr = _rcfgs(perturb=0.0)
    _, tb, target = _rays(JR.RenderConfig(N_samples=8, N_importance=8, near=2.0,
                                          far=6.0), tr)
    params = {b: m.params() for b, m in tstate.branches()}
    t = torch.from_numpy(target)
    _, aux = nerf_loss(params, tb, t, tr, tp, tf, return_ray_err=True)
    assert aux["ray_err"].shape == (24,) and not aux["ray_err"].requires_grad
    assert float(aux["ray_err"].mean()) == pytest.approx(float(aux["img_loss"]), rel=1e-6)


# --- the mixed hierarchy's state and checkpoints --------------------------------


def test_mixed_hierarchy_group_learning_rates():
    """A proposal MLP coarse + split hashgrid fine: the fine tables in the
    "grid" group at 2e-2, the proposal and the fine decoder in "net" at
    lrate; Adam's first unit-gradient update moves each entry by its
    group's rate, as in JAX's test_mixed_hierarchy_grid_lrate_defaults."""
    (_, _, jstate), (_, _, tstate) = _shared("hashgrid", seed=0, lrate=5e-4)
    labels = {g["label"]: g for g in tstate.optimizer.param_groups}
    assert set(labels) == {"net", "grid"} and labels["grid"]["base_lr"] == 2e-2
    grid_ids = {id(p) for p in labels["grid"]["params"]}
    assert grid_ids == {id(p) for p in tstate.fine.tables}
    assert all(id(p) not in grid_ids for p in tstate.coarse.parameters())
    before = {k: v.detach().clone() for k, v in tstate.fine.params().items()}
    before_c = tstate.coarse.params()["pts_linears.0.weight"].detach().clone()
    for p in tstate.parameters():
        p.grad = torch.ones_like(p)
    tstate.apply_gradients()
    jnew = jstate.apply_gradients(jax.tree_util.tree_map(jnp.ones_like, jstate.params))
    d_table = float((tstate.fine.params()["tables.0"] - before["tables.0"]).abs().mean())
    d_net = float((tstate.coarse.params()["pts_linears.0.weight"] - before_c).abs().mean())
    assert d_table == pytest.approx(2e-2, rel=1e-3)
    assert d_net == pytest.approx(5e-4, rel=1e-3)
    for b, m in tstate.branches():
        want = to_torch(jax.device_get(jnew.params[b]))
        for k, v in m.state_dict().items():
            torch.testing.assert_close(v, want[k], rtol=1e-5, atol=1e-7, msg=f"{b} {k}")


def test_mixed_hierarchy_tar_is_refused(tmp_path):
    """A mixed hierarchy has no .tar layout: --ckpt_format tar raises,
    both writes the .ckpt.npz alone, which the JAX loader reads."""
    (_, _, jstate), (_, _, tstate) = _shared("hashgrid", seed=1)
    tstate.step = 3
    with pytest.raises(ValueError, match="only defined for the 'nerf' model family"):
        tckpt.save_checkpoints(str(tmp_path), "mixed", tstate, 3, fmt="tar")
    paths = tckpt.save_checkpoints(str(tmp_path), "mixed", tstate, 3, fmt="both")
    assert [os.path.basename(p) for p in paths] == ["000003.ckpt.npz"]
    from nerf_shared_tpu.utils import checkpoints as jckpt

    params, _, step = jckpt.load_native(paths[0])
    assert step == 3 and set(params) == {"coarse", "fine"}
    for b, m in tstate.branches():
        want = to_torch(params[b])
        for k, v in m.state_dict().items():
            torch.testing.assert_close(v, want[k], rtol=0, atol=0)


def test_params_from_jax_carries_the_proposal_network():
    """The proposal shape at its defaults (D 2, W 64, no viewdirs, output
    4, the lego encoding): JAX's weights load strictly into the port's
    module, and both networks give the same raw outputs to 1e-5."""
    kw = dict(D=2, W=64, output_ch=4, skips=(4,), use_viewdirs=False, multires=10,
              multires_views=4)
    jcfg, tcfg = jnerf.NeRFConfig(**kw), tnerf.NeRFConfig(**kw)
    jparams = jnerf.init_nerf_params(jax.random.PRNGKey(2), jcfg)
    model = tnerf.NeRF(tcfg)
    model.load_state_dict(tnerf.params_from_jax(jax.device_get(jparams)), strict=True)
    pts = np.random.default_rng(0).uniform(-2, 2, (5, 7, 3)).astype(np.float32)
    want = jnerf.apply_nerf(jparams, jcfg, jnp.asarray(pts), None)
    with torch.no_grad():
        got = model(torch.from_numpy(pts))
    assert got.shape == (5, 7, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
