"""The transmittance's backward (ops/compositing.py ``exclusive_cumprod``)
against autograd of ``torch.cumprod`` plus the leading 1, and the training
graphs that run it.

torch's own cumprod backward tests its input for zeros with ``.item()``,
a host wait in every training step; the port's backward makes no host
read. On zero-free input (every factor of the composite, 1 - alpha +
1e-10, is at least 1e-10) its gradients are torch's bit for bit; rows
with a zero factor match to fp32 rounding. The graph walks guard the
training routes against a return of torch's node. The tests marked
``card`` skip without an NVIDIA card; where there is one they run with
``python -m pytest --noconftest -m card tests/test_torch_transmittance.py``
(this file imports no JAX, ``tests/conftest.py`` does).
"""

import dataclasses
import os

import pytest
import torch

from nerf_shared_tpu_torch.config import config_parser, resolve_fused_backward
from nerf_shared_tpu_torch.factory import get_renderer, get_train_state, nerf_configs
from nerf_shared_tpu_torch.ops.compositing import exclusive_cumprod, raw2outputs
from nerf_shared_tpu_torch.train.step import nerf_loss, pack_ray_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _torch_exclusive_cumprod(x, dim=-1):
    cp = torch.cumprod(x, dim=dim)
    ones = torch.ones_like(cp.narrow(dim, 0, 1))
    return torch.cat([ones, cp.narrow(dim, 0, x.shape[dim] - 1)], dim=dim)


def _factors(n, S, seed, device="cpu"):
    """1 - alpha + 1e-10 as the composite forms it: alpha in [0, 1], the
    last sample saturated (the 1e10 sentinel interval) and a third of the
    rows with saturated samples throughout (factors of 1e-10)."""
    g = torch.Generator().manual_seed(seed)
    alpha = torch.rand(n, S, generator=g)
    alpha[:, -1] = 1.0
    sat = torch.rand(n, S, generator=g) < 0.3
    alpha[::3] = torch.where(sat[::3], 1.0, alpha[::3])
    cot = torch.randn(n, S, generator=g)
    return (1.0 - alpha + 1e-10).to(device), cot.to(device)


def _grads(fn, x, cot, dim=-1):
    x = x.clone().requires_grad_(True)
    out = fn(x, dim=dim)
    (out * cot).sum().backward()
    return out.detach(), x.grad


@pytest.mark.parametrize("S", [1, 64, 192])
def test_backward_is_torchs_bit_for_bit_on_zero_free_input(S):
    x, cot = _factors(256, S, seed=S)
    assert (x > 0).all()
    out, got = _grads(exclusive_cumprod, x, cot)
    ref, want = _grads(_torch_exclusive_cumprod, x, cot)
    assert torch.equal(out, ref)
    assert torch.equal(got, want)


def test_backward_along_another_dim():
    x, cot = _factors(64, 48, seed=5)
    x, cot = x.t().reshape(48, 8, 8), cot.t().reshape(48, 8, 8)
    out, got = _grads(exclusive_cumprod, x, cot, dim=0)
    ref, want = _grads(_torch_exclusive_cumprod, x, cot, dim=0)
    assert torch.equal(out, ref) and torch.equal(got, want)


@pytest.mark.parametrize("S", [1, 64, 192])
def test_backward_with_zero_factors_matches_torch(S):
    x, cot = _factors(256, S, seed=10 + S)
    g = torch.Generator().manual_seed(S)
    x = torch.where(torch.rand(x.shape, generator=g) < 0.05, 0.0, x)
    x[0] = 0.0                              # every factor zero
    x[1, S // 2] = 0.0                      # at least one zero
    if S > 2:
        x[2, :2] = 0.0                      # two zeros in a row
    out, got = _grads(exclusive_cumprod, x, cot)
    ref, want = _grads(_torch_exclusive_cumprod, x, cot)
    assert torch.equal(out, ref)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1.3e-6, atol=1e-6)


def test_double_backward_float64():
    g = torch.Generator().manual_seed(0)
    x = (torch.rand(3, 7, generator=g, dtype=torch.float64) * 0.9 + 0.1).requires_grad_(True)
    assert torch.autograd.gradcheck(exclusive_cumprod, (x,))
    assert torch.autograd.gradgradcheck(exclusive_cumprod, (x,))


def _node_names(t):
    names, seen, stack = set(), set(), [t.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or id(fn) in seen:
            continue
        seen.add(id(fn))
        names.add(type(fn).__name__)
        stack.extend(nxt for nxt, _ in fn.next_functions)
    return names


def test_raw2outputs_graph_holds_no_cumprod_backward():
    g = torch.Generator().manual_seed(1)
    raw = torch.randn(16, 12, 4, generator=g, requires_grad=True)
    z = torch.sort(torch.rand(16, 12, generator=g) * 4 + 2, dim=-1).values
    rd = torch.randn(16, 3, generator=g)
    rgb, disp, acc, w, depth = raw2outputs(raw, z, rd, raw_noise_std=1.0, white_bkgd=True,
                                           generator=g)
    names = _node_names(rgb.sum() + disp.sum() + acc.sum() + w.sum() + depth.sum())
    assert "_ExclusiveCumprodBackward" in names
    assert "CumprodBackward0" not in names


TINY = ["--netdepth", "2", "--netwidth", "32", "--netdepth_fine", "2", "--netwidth_fine",
        "32", "--multires", "4", "--multires_views", "2", "--N_samples", "8",
        "--N_importance", "8", "--N_rand", "32"]


@pytest.mark.parametrize("config, extra", [
    ("lego.txt", []),
    ("fern.txt", []),
    ("lego.txt", ["--proposal", "True"]),
])
def test_training_loss_graph_holds_no_cumprod_backward(config, extra, tmp_path):
    """nerf_loss under the render config the trainer hands make_train_step
    (apps/train.py): the recipe's composites, sigma noise for fern, the
    proposal branch."""
    args = config_parser().parse_args(
        ["--config", os.path.join(ROOT, "configs", config), "--device", "cpu",
         "--basedir", str(tmp_path), "--no_reload"] + TINY + extra)
    ccfg, fcfg = nerf_configs(args)
    state = get_train_state(args, "cpu", cfgs=(ccfg, fcfg))
    renderer = get_renderer(args, {"near": 2.0, "far": 6.0}, "cpu")
    rcfg = dataclasses.replace(renderer.cfg, use_pallas=False, fused_composite=False,
                               fused_backward=resolve_fused_backward(args, "cpu"), guided=0)
    g = torch.Generator().manual_seed(3)
    rays_o = torch.randn(32, 3, generator=g) * 0.1 + torch.tensor([0.0, 0.0, 4.0])
    rays_d = torch.randn(32, 3, generator=g) * 0.3 + torch.tensor([0.0, 0.0, -1.0])
    batch = pack_ray_batch(rays_o, rays_d, rcfg, 16, 16, 20.0)
    loss, _ = nerf_loss({b: m.params() for b, m in state.branches()}, batch,
                        torch.rand(32, 3, generator=g), rcfg, ccfg, fcfg,
                        prop_reg=args.proposal_loss_weight, generator=g)
    names = _node_names(loss)
    assert "_ExclusiveCumprodBackward" in names
    assert "CumprodBackward0" not in names


@pytest.mark.card
def test_backward_is_torchs_bit_for_bit_on_the_card(card):
    for S in (64, 192):
        x, cot = _factors(1024, S, seed=S, device=card)
        out, got = _grads(exclusive_cumprod, x, cot)
        ref, want = _grads(_torch_exclusive_cumprod, x, cot)
        assert torch.equal(out, ref) and torch.equal(got, want)


@pytest.mark.card
def test_lego_train_step_makes_no_host_sync(card, tmp_path):
    """One nerf-lego step (1024 rays, 64 + 128 samples, kernels B1 and B2)
    under ``set_sync_debug_mode("error")``, after a first step that builds
    the kernels."""
    from nerf_shared_tpu_torch.train.pipeline import PixelSamplerSpec
    from nerf_shared_tpu_torch.train.step import make_train_step

    args = config_parser().parse_args(
        ["--config", os.path.join(ROOT, "configs", "lego.txt"), "--device", "cuda",
         "--basedir", str(tmp_path), "--no_reload"])
    ccfg, fcfg = nerf_configs(args)
    state = get_train_state(args, card, cfgs=(ccfg, fcfg))
    renderer = get_renderer(args, {"near": 2.0, "far": 6.0}, card)
    rcfg = dataclasses.replace(renderer.cfg, use_pallas=False, fused_composite=False,
                               fused_backward=resolve_fused_backward(args, card), guided=0)
    assert rcfg.fused_backward and (rcfg.N_samples, rcfg.N_importance) == (64, 128)
    H = W = 400
    K = [[555.6, 0.0, 200.0], [0.0, 555.6, 200.0], [0.0, 0.0, 1.0]]
    spec = PixelSamplerSpec.from_K(H, W, K, args.N_rand, single_image=True,
                                   precrop_iters=args.precrop_iters,
                                   precrop_frac=args.precrop_frac)
    step = make_train_step(rcfg, ccfg, fcfg, spec)
    g = torch.Generator().manual_seed(0)
    images = torch.rand(4, H, W, 3, generator=g).to(card)
    poses = torch.eye(4)[:3].repeat(4, 1, 1)
    poses[:, :, 3] = torch.tensor([0.0, 0.0, 4.0]) + 0.1 * torch.randn(4, 3, generator=g)
    poses = poses.to(card)
    step(state, images, poses, g)
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        aux = step(state, images, poses, g)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    assert args.N_rand == 1024 and torch.isfinite(aux["loss"]).item()
