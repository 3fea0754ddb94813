"""``--debug_nans`` on the CPU (utils/debug.py, ops/cuda/common.check_outputs),
against the JAX package's ``utils/debug.py`` and ``jax_debug_nans``.

- A NaN put into an input of each kernel wrapper (B1-B5, P1, P2, through
  their plain versions on CPU tensors, fp32 and bf16) raises
  FloatingPointError naming the kernel, the wrapper and the input (a
  kernel's ReLU may drop a NaN before its output); a NaN made inside
  raises naming the output; with the checks off the wrapper returns the
  NaNs.
- A NaN put into a parameter of a tiny training step raises: in the
  forward (B1's check, --fused_backward) or, through anomaly mode, in the
  backward (the plain network); the JAX step raises under jax_debug_nans.
- A clean step with the checks on equals the step with them off, bit for
  bit; the trainer turns the checks on for its run and off when it returns.
- ``check_finite`` and ``assert_shape`` give the JAX functions' messages.

``jax_debug_nans`` is global: each JAX call here sets it in a ``try`` and
restores it in ``finally``, so no other test of the worker sees it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_shared_tpu.models import nerf as jnerf
from nerf_shared_tpu.render.renderer import RenderConfig as JRenderConfig
from nerf_shared_tpu.train import pipeline as jpipe
from nerf_shared_tpu.train.state import create_train_state as j_create_state
from nerf_shared_tpu.train.step import make_fused_train_step
from nerf_shared_tpu.utils import debug as jdebug
from nerf_shared_tpu_torch.apps import train as tapp
from nerf_shared_tpu_torch.config import config_parser
from nerf_shared_tpu_torch.models import nerf as tnerf
from nerf_shared_tpu_torch.ops.cuda import common, composite, fused_mlp, fused_mlp_bwd
from nerf_shared_tpu_torch.ops.cuda import fused_render, gather
from nerf_shared_tpu_torch.render.renderer import RenderConfig
from nerf_shared_tpu_torch.train import pipeline as tpipe
from nerf_shared_tpu_torch.train.state import create_train_state
from nerf_shared_tpu_torch.train.step import make_train_step
from nerf_shared_tpu_torch.utils import debug as tdebug
from tests.test_e2e import _write_config, _write_scene
from tests.test_torch_train import _scene

KW = dict(D=3, W=32, skips=(1,), use_viewdirs=True, multires=4, multires_views=2,
          output_ch=5)
BF = torch.bfloat16


@pytest.fixture
def nan_checks():
    tdebug.enable_nan_checks(True)
    try:
        yield
    finally:
        tdebug.enable_nan_checks(False)


def _net(seed=0):
    cfg = tnerf.NeRFConfig(**KW)
    m = tnerf.NeRF(cfg, generator=torch.Generator().manual_seed(seed))
    return cfg, {k: v.detach() for k, v in m.params().items()}


def _inputs(n=6, S=5, seed=1):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    rd = f(n, 3)
    z = torch.sort(torch.from_numpy(rng.random((n, S)).astype(np.float32)) * 4 + 2,
                   -1).values
    return dict(pts=f(n, S, 3), vd=rd / rd.norm(dim=-1, keepdim=True), ro=f(n, 3) * 0.1,
                rd=rd, z=z, g=f(n, S, 4), raw=f(n, S, 4))


def _with_nan(t, where=0):
    t = t.clone()
    t.view(-1)[where] = float("nan")
    return t


def _call(kernel, dtype):
    """A call of ``kernel``'s wrapper with a NaN in one input."""
    cfg, p = _net()
    x = _inputs()
    if kernel == "B1":
        if dtype == BF:
            return lambda: fused_mlp_bwd.fused_train_op(p, cfg, _with_nan(x["pts"]), x["vd"],
                                                        BF)
        return lambda: fused_mlp.fused_nerf_forward(p, cfg, _with_nan(x["pts"]), x["vd"])
    if kernel == "B1 train":
        return lambda: fused_mlp_bwd.fused_train_op(p, cfg, _with_nan(x["pts"]), x["vd"])
    if kernel == "B2":
        return lambda: fused_mlp_bwd.fused_mlp_backward(p, cfg, x["pts"], x["vd"],
                                                        _with_nan(x["g"]), dtype)
    if kernel == "B3":
        return lambda: fused_mlp.fused_nerf_forward_rays(p, cfg, _with_nan(x["ro"]), x["rd"],
                                                         x["z"], x["vd"], dtype)
    if kernel == "B4":
        return lambda: fused_render.fused_render_rays(p, cfg, x["ro"], x["rd"],
                                                      _with_nan(x["z"], 7), x["vd"],
                                                      compute_dtype=dtype)
    if kernel == "B5":
        return lambda: composite.composite_fused(_with_nan(x["raw"], 3), x["z"], x["rd"])
    table = torch.randn(10, 4)
    idx = torch.tensor([1, 3, 3, 9], dtype=torch.int32)
    if kernel == "P1":
        return lambda: gather.gather_rows(_with_nan(table, 4), idx)
    return lambda: gather.scatter_add_rows(idx, _with_nan(torch.randn(4, 4)), 10)


CASES = [("B1", torch.float32, "B1", "fused_nerf_forward"),
         ("B1 train", torch.float32, "B1", "fused_train_op"),
         ("B1", BF, "B1 bf16", "fused_train_op"),
         ("B2", torch.float32, "B2", "fused_mlp_backward"),
         ("B2", BF, "B2 bf16", "fused_mlp_backward"),
         ("B3", torch.float32, "B3", "fused_nerf_forward_rays"),
         ("B3", BF, "B3 bf16", "fused_nerf_forward_rays"),
         ("B4", torch.float32, "B4", "fused_render_rays"),
         ("B4", BF, "B4 bf16", "fused_render_rays"),
         ("B5", torch.float32, "B5", "composite_fused"),
         ("P1", torch.float32, "P1", "gather_rows"),
         ("P2", torch.float32, "P2", "scatter_add_rows")]


@pytest.mark.parametrize("kernel,dtype,label,wrapper", CASES,
                         ids=[f"{c[0]}-{c[1]}".replace("torch.", "") for c in CASES])
def test_a_nan_into_each_wrapper_raises_naming_the_kernel(nan_checks, kernel, dtype, label,
                                                          wrapper):
    call = _call(kernel, dtype)
    with pytest.raises(FloatingPointError,
                       match=rf"kernel {label} \({wrapper}\): input \S+ contains 1 "
                             "non-finite values"):
        call()


@pytest.mark.parametrize("kernel,module,plain", [
    ("B1", fused_mlp, "apply_nerf"), ("B5", composite, "plain_composite"),
    ("P1", gather, "plain_gather_rows"), ("P2", gather, "plain_scatter_add_rows")])
def test_a_nan_made_inside_raises_naming_the_output(nan_checks, monkeypatch, kernel, module,
                                                    plain):
    """Finite inputs, a plain version that returns a NaN: the output check
    names the kernel and the output."""
    real = getattr(module, plain)

    def poisoned(*a, **k):
        out = real(*a, **k)
        first = out if isinstance(out, torch.Tensor) else out[0]
        first.view(-1)[0] = float("nan")
        return out

    monkeypatch.setattr(module, plain, poisoned)
    cfg, p = _net()
    x = _inputs()
    call = {"B1": lambda: fused_mlp.fused_nerf_forward(p, cfg, x["pts"], x["vd"]),
            "B5": lambda: composite.composite_fused(x["raw"], x["z"], x["rd"]),
            "P1": lambda: gather.gather_rows(torch.randn(10, 4),
                                             torch.tensor([1, 3], dtype=torch.int32)),
            "P2": lambda: gather.scatter_add_rows(torch.tensor([1, 3], dtype=torch.int32),
                                                  torch.randn(2, 4), 10)}[kernel]
    with pytest.raises(FloatingPointError,
                       match=rf"kernel {kernel} \(\w+\): output \w+ contains 1 non-finite"):
        call()


@pytest.mark.parametrize("kernel", ["B1", "B2", "B3", "B4", "B5", "P1", "P2"])
def test_with_the_checks_off_the_wrappers_pass_nans_through(kernel):
    assert not common.NAN_CHECKS
    out = _call(kernel, torch.float32)()
    flat = out if isinstance(out, torch.Tensor) else (
        list(out[0].values()) + [out[1]] if isinstance(out[0], dict) else list(out))
    flat = [flat] if isinstance(flat, torch.Tensor) else flat
    assert any(bool(torch.isnan(t).any()) for t in flat if t is not None)


def test_enable_nan_checks_turns_on_anomaly_mode_and_the_kernel_checks():
    assert not common.NAN_CHECKS and not torch.is_anomaly_enabled()
    tdebug.enable_nan_checks(True)
    try:
        assert common.NAN_CHECKS and torch.is_anomaly_enabled()
    finally:
        tdebug.enable_nan_checks(False)
    assert not common.NAN_CHECKS and not torch.is_anomaly_enabled()


# --- a training step --------------------------------------------------------------


def _states(seed=3):
    jcfg = jnerf.NeRFConfig(**KW)
    js = j_create_state(jax.random.PRNGKey(seed), jcfg, jcfg, lrate=5e-3, lrate_decay=250)
    tcfg = tnerf.NeRFConfig(**KW)
    ts = create_train_state(tcfg, tcfg, "cpu", lrate=5e-3, lrate_decay=250)
    params = jax.device_get(js.params)
    with torch.no_grad():
        for b, m in ts.branches():
            m.load_state_dict(tnerf.params_from_jax(params[b]))
    return jcfg, js, tcfg, ts


def _step_setup(fused_backward):
    images, poses, K = _scene(n=3, H=8, W=8, seed=4)
    kw = dict(single_image=True, precrop_iters=0)
    rcfg = dict(N_samples=8, N_importance=8, use_viewdirs=True, white_bkgd=True,
                near=2.0, far=6.0)
    tstep = make_train_step(RenderConfig(**rcfg, fused_backward=fused_backward),
                            tnerf.NeRFConfig(**KW), tnerf.NeRFConfig(**KW),
                            tpipe.PixelSamplerSpec.from_K(8, 8, K, 16, **kw))
    jstep = make_fused_train_step(JRenderConfig(**rcfg), jnerf.NeRFConfig(**KW),
                                  jnerf.NeRFConfig(**KW),
                                  jpipe.PixelSamplerSpec.from_K(8, 8, K, 16, **kw),
                                  donate=False)
    return images, poses, tstep, jstep


def _poison(ts, js):
    """A NaN in the fine network's first weight of both states."""
    with torch.no_grad():
        ts.fine.params()["pts_linears.0.weight"][0, 0] = float("nan")
    p = jax.tree_util.tree_map(lambda a: a, js.params)
    w = p["fine"]["pts_linears"][0]["w"]
    p["fine"]["pts_linears"][0]["w"] = w.at[0, 0].set(jnp.nan)
    return js.replace(params=p)


@pytest.mark.parametrize("fused_backward", [True, False])
def test_a_nan_parameter_raises_in_the_step_as_in_jax(nan_checks, fused_backward):
    """--fused_backward: B1's check raises in the forward; the plain
    network: anomaly mode raises in the backward (the first backward
    function that returns a NaN). The JAX step raises FloatingPointError
    under jax_debug_nans."""
    _, js, _, ts = _states()
    js = _poison(ts, js)
    images, poses, tstep, jstep = _step_setup(fused_backward)
    if fused_backward:
        with pytest.raises(FloatingPointError, match=r"kernel B1 \(fused_train_op\)"):
            tstep(ts, torch.from_numpy(images), torch.from_numpy(poses),
                  torch.Generator().manual_seed(0))
    else:
        with pytest.raises(RuntimeError, match="returned nan values"):
            tstep(ts, torch.from_numpy(images), torch.from_numpy(poses),
                  torch.Generator().manual_seed(0))
    before = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        with pytest.raises(FloatingPointError):
            out = jstep(js, jnp.asarray(images), jnp.asarray(poses), jax.random.PRNGKey(0))
            jax.block_until_ready(out)
    finally:
        jax.config.update("jax_debug_nans", before)
    assert not jax.config.jax_debug_nans


@pytest.mark.parametrize("fused_backward", [True, False])
def test_a_clean_step_with_the_checks_on_is_the_step_with_them_off(fused_backward):
    images, poses, tstep, _ = _step_setup(fused_backward)
    out = []
    for on in (False, True):
        _, _, _, ts = _states()
        tdebug.enable_nan_checks(on)
        try:
            for i in range(3):
                aux = tstep(ts, torch.from_numpy(images), torch.from_numpy(poses),
                            torch.Generator().manual_seed(i))
        finally:
            tdebug.enable_nan_checks(False)
        out.append(({k: v.detach().clone() for k, v in ts.named_parameters().items()},
                    float(aux["loss"])))
    (p0, l0), (p1, l1) = out
    assert l0 == l1
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k


def test_the_trainer_turns_the_checks_on_for_its_run_and_off_after(tmp_path, monkeypatch):
    """--debug_nans: the checks are on inside the run, off after it (and
    after a run that raises); the run's weights are the flag-off run's."""
    datadir, logdir = str(tmp_path / "scene"), str(tmp_path / "logs")
    _write_scene(datadir)
    cfg = _write_config(str(tmp_path), datadir, logdir, N_iters=6, i_print=3, i_weights=6)
    seen = []
    real = tapp.make_train_step

    def spy(*a, **k):
        fn = real(*a, **k)

        def step(*sa, **sk):
            seen.append((common.NAN_CHECKS, torch.is_anomaly_enabled()))
            return fn(*sa, **sk)
        return step

    monkeypatch.setattr(tapp, "make_train_step", spy)
    states = []
    for flag in ("False", "True"):
        args = config_parser().parse_args(["--config", cfg, "--device", "cpu",
                                           "--debug_nans", flag, "--expname", "e" + flag,
                                           "--fused_backward", "true"])
        states.append(tapp.train(args))
        assert not common.NAN_CHECKS and not torch.is_anomaly_enabled()
    assert seen == [(False, False)] * 6 + [(True, True)] * 6
    a, b = (s.named_parameters() for s in states)
    assert all(torch.equal(a[k], b[k]) for k in a)
    args = config_parser().parse_args(["--device", "cpu", "--debug_nans", "True",
                                       "--datadir", str(tmp_path / "missing")])
    with pytest.raises(Exception):
        tapp.train(args)
    assert not common.NAN_CHECKS and not torch.is_anomaly_enabled()


# --- check_finite / assert_shape -------------------------------------------------------


TREES = [np.array([1.0, np.nan]),
         {"b": [np.ones(2), np.array([np.inf, 1.0, np.nan])], "a": {"x": np.ones(3)}},
         {1: None, 0: (np.ones(1), np.array([[np.nan]]))},
         [np.ones(2), {"k": np.array(np.nan)}],
         {"loss": np.float32(np.inf)}]


@pytest.mark.parametrize("i", range(len(TREES)))
@pytest.mark.parametrize("as_torch", [False, True])
def test_check_finite_gives_the_jax_message(i, as_torch):
    tree = TREES[i]
    with pytest.raises(FloatingPointError) as want:
        jdebug.check_finite(tree, "params")
    if as_torch:
        tree = jax.tree_util.tree_map(lambda a: torch.as_tensor(np.asarray(a)), tree)
    with pytest.raises(FloatingPointError) as got:
        tdebug.check_finite(tree, "params")
    assert str(got.value) == str(want.value)


def test_check_finite_passes_finite_trees_and_bf16():
    tdebug.check_finite({"a": torch.ones(3, dtype=BF), "b": [np.zeros(2)]}, "ok")
    jdebug.check_finite({"a": np.ones(3), "b": [np.zeros(2)]}, "ok")


@pytest.mark.parametrize("shape,want", [((2, 3), (2, 3)), ((2, 3), (None, 3)),
                                        ((2, 3), (2, 4)), ((2, 3), (2,)),
                                        ((4,), (None, None))])
def test_assert_shape_gives_the_jax_message(shape, want):
    results = []
    for mod, x in ((jdebug, np.zeros(shape)), (tdebug, torch.zeros(shape))):
        try:
            mod.assert_shape(x, want, "rays")
            results.append(None)
        except AssertionError as e:
            results.append(str(e))
    assert results[0] == results[1]
