#!/usr/bin/env python3
"""Smoke run of the PyTorch port (nerf_shared_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--profile]

Phases (any failure exits non-zero and prints no result line):

1. build    nvcc builds every kernel (B1-B5) from csrc/, one process per
            source, in parallel, into build/nerf_shared_tpu_torch/.
2. kernels  at the lego width (8x256, skip at 4, viewdirs, multires 10/4)
            with seeded weights and rays at the main path's shapes (one ray
            block of --chunk 32768 rays): B3 at S=64 and S=192 and B4 at
            S=192 against their plain PyTorch versions, one gradient through
            each autograd.Function, and median times. B5 (the composite) at
            32768 rays x S = 64, 192, 48 (guided) and 32 (froxel K) and at
            odd shapes (S=1, S=21 with 37 rays, opaque and empty rays), with
            and without a white background, and its gradient.
3. serving  a synthetic 800x800 blender scene loaded with configs/lego.txt
            (half_res: 400x400 frames), a .tar of seeded random lego-width
            weights, and the port's HTTP service on port 0: three render
            requests (GET and POST) and /metrics. Checks HTTP 200, decodable
            400x400x3 PNGs, a finite float frame that matches the plain
            renderer on a band of rays, and B3 and B5 each launched exactly
            2 x ceil(160000 / chunk) times per frame.
4. fused    one request through an engine with --fused_composite True: B4
            and B5 (the coarse pass) launched, pixels match phase 3's frame
            within 1e-3 on rays clear of the 1e10 sentinel.
5. training kernels
            B1 and B2 at the lego width with seeded weights at both training
            shapes of configs/lego.txt (1024 rays x 64 coarse samples =
            65,536 points; x 192 fine = 196,608), and at the odd shapes of
            phase 2, against their plain versions; median times. Then one
            full training step (N_rand 1024, 64 + 128 samples) through the
            kernels and through the plain path with the same draws: loss,
            every gradient and the post-Adam parameters must agree.
6. training a 3-D-consistent blender scene (benchmarks/hard_scene.py,
            800x800 frames -> 400x400 under half_res) trained with
            configs/lego.txt through apps/train.main for a few hundred
            steps, resumed for more, then --render_only --render_test.
            Checks B1 and B2 launched 2 x steps times, train PSNR rising,
            the held-out PSNR >= 2 dB above an all-white frame, Adam state
            in the .tar and .ckpt.npz, and the resume on the lr schedule.
7. fast     phase 6's checkpoint served over HTTP with configs/lego.txt
            through the fast engines: --render_guided 48, --render_gate
            1e-3, --occ_grid 128 --occ_keep 32 --occ_fine 16 (froxels) and
            the same with --occ_mode grid. Per engine: two requests of
            one pose giving the same finite 400x400 frame, /info's engine
            name, the B1/B3/B5 launches (exact where
            fixed: guided 10 B3 + 10 B5, a 128^3 grid build 128 B1), the
            frame against the same engine through the plain versions on the
            same grid within 1e-3 (rays whose difference is a flip of the
            1e10 sentinel excepted, at most 1 in 1000), latency, occupied
            fraction and PSNR against the dense frame and the held-out view.

``--profile`` adds one dense frame, five training steps and one frame of
each fast engine under torch.profiler (device time by kernel, device busy
share). Before the last
line it prints the kernels JSON line and the card's
``nvidia-smi --query-gpu=name,power.limit`` line; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import multiprocessing
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
# the card's peaks used for bounds (NVIDIA H100 SXM data sheet): fp32 on
# the CUDA cores (the port's fp32 path uses no TF32) and HBM bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def log(msg):
    print(msg, flush=True)


def time_ms(fn, reps):
    """Median milliseconds of ``fn`` on the card, fenced with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        ts.append(start.elapsed_time(end))
    return statistics.median(ts)


def device_ms(fn, reps, kernel=None):
    """Device milliseconds per call of ``fn`` under torch.profiler over
    ``reps`` calls after a warm-up: the time of the CUDA kernels whose name
    contains ``kernel``, or of every CUDA kernel when it is None. For a
    launch shorter than the host's per-call cost, where CUDA events around
    the call measure the host."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and (kernel is None or kernel in e.name))
    if us <= 0:
        raise AssertionError(f"the profiler recorded no device time for {kernel}")
    return us / 1e3 / reps


def lego_rays(n, S, seed, device):
    """Seeded rays like a 400x400 lego frame's: origins on the radius-4
    orbit, directions through the scene, depths in [2, 6] (S=64: the
    perturb-0 linspace; S=192: that union 128 inverse-CDF-like draws)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    theta = torch.rand(n, generator=g) * 2 * math.pi
    o = torch.stack([4 * torch.sin(theta), 1.5 * torch.ones(n),
                     4 * torch.cos(theta)], -1)
    d = -o + torch.randn(n, 3, generator=g) * 0.8
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True) * (
        1 + 0.1 * torch.rand(n, 1, generator=g))
    vd = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    z = torch.linspace(2.0, 6.0, 64).expand(n, 64)
    if S > 64:
        extra = 2.0 + 4.0 * torch.rand(n, S - 64, generator=g)
        z = torch.sort(torch.cat([z, extra], -1), -1).values
    to = dict(device=device, dtype=torch.float32)
    return (o.to(**to).contiguous(), d.to(**to).contiguous(),
            z.to(**to).contiguous(), vd.to(**to).contiguous())


def bound(cfg, params, n, S):
    """(bound_ms, bound_by) of the network on n rays x S samples: its FLOPs
    over the fp32 peak vs its bytes (rays, depths, weights in; raw out)
    over the memory rate."""
    from nerf_shared_tpu_torch.ops.cuda.fused_mlp import flops_per_point, network_bytes

    flops = flops_per_point(cfg) * n * S
    nbytes = 4 * (n * 9 + n * S + n * S * 4) + network_bytes(params, cfg)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def abs_err(got, want, tol):
    """(max |got - want|, whether it is within tol * max(1, max|want|))."""
    err = float((got - want).abs().max())
    return err, err <= tol * max(1.0, float(want.abs().max()))


def check_other_shapes(device, tol):
    """B3 and B4 against their plain versions on the architectures the TPU
    kernels also take: no viewdirs (output_ch 5), the stonehenge encoder
    (multires 15/6: 132 embedding columns), identity embedding, odd widths
    and depths, two skips, and sample counts that fill no tile."""
    import torch

    from nerf_shared_tpu_torch.models.nerf import NeRF, NeRFConfig
    from nerf_shared_tpu_torch.ops.cuda import fused_mlp, fused_render

    archs = [dict(D=3, W=64, skips=(1,), use_viewdirs=False, output_ch=5),
             dict(D=8, W=256, skips=(4,), multires=15, multires_views=6),
             dict(D=2, W=30, skips=(0,), i_embed=-1),
             dict(D=5, W=128, skips=(1, 3), multires=6, multires_views=2)]
    with torch.no_grad():
        for i, kw in enumerate(archs):
            cfg = NeRFConfig(**kw)
            params = {k: v.detach() for k, v in NeRF(
                cfg, device=device,
                generator=torch.Generator().manual_seed(i)).params().items()}
            for S in (1, 7, 65):
                o, d, z, vd = lego_rays(37, 64, seed=i, device=device)
                z = z[:, :S].contiguous() if S <= 64 else torch.sort(torch.cat(
                    [z, z[:, :S - 64] + 0.01], -1), -1).values.contiguous()
                vd = vd if cfg.use_viewdirs else None
                raw_p = fused_mlp.plain_nerf_forward_rays(params, cfg, o, d, z, vd)
                e3, ok3 = abs_err(fused_mlp.fused_nerf_forward_rays(
                    params, cfg, o, d, z, vd), raw_p, tol)
                mask = raw_p[:, -1, 3].abs() >= 1e-2
                got = fused_render.fused_render_rays(params, cfg, o, d, z, vd)
                want = fused_render.plain_render_rays(params, cfg, o, d, z, vd)
                checked = [abs_err(g[mask], w[mask], tol) for g, w in zip(got, want)]
                e4 = max(e for e, _ in checked)
                log(f"  {kw} S={S}: B3 max err {e3:.1e}, B4 max err {e4:.1e} "
                    f"over {int(mask.sum())}/37 masked rays (tol {tol:g})")
                if not (ok3 and all(ok for _, ok in checked)):
                    raise AssertionError(f"kernels disagree at {kw} S={S}")


def phase_kernels(device, n=32768):
    import torch

    from nerf_shared_tpu_torch.models.nerf import NeRF, NeRFConfig
    from nerf_shared_tpu_torch.ops.cuda import fused_mlp, fused_render

    cfg = NeRFConfig(D=8, W=256, skips=(4,), use_viewdirs=True, multires=10,
                     multires_views=4)
    model = NeRF(cfg, device=device, generator=torch.Generator().manual_seed(0))
    params = {k: v.detach() for k, v in model.params().items()}
    # fp32 sums over up to 283 terms in another order than cuBLAS, through
    # 10 layers; sin/cos see bit-identical arguments (see fused_mlp.py)
    tol = 2e-4
    cases = []

    with torch.no_grad():
        for S in (64, 192):
            o, d, z, vd = lego_rays(n, S, seed=S, device=device)
            got = fused_mlp.fused_nerf_forward_rays(params, cfg, o, d, z, vd)
            want = fused_mlp.plain_nerf_forward_rays(params, cfg, o, d, z, vd)
            torch.cuda.synchronize()
            err, ok = abs_err(got, want, tol)
            ms = time_ms(lambda: fused_mlp.fused_nerf_forward_rays(
                params, cfg, o, d, z, vd), 5)
            plain_ms = time_ms(lambda: fused_mlp.plain_nerf_forward_rays(
                params, cfg, o, d, z, vd), 5)
            bms, by = bound(cfg, params, n, S)
            log(f"B3 fused_mlp S={S}: max err {err:.3e} (tol {tol:g}, scaled by "
                f"max(1, max|plain|)), {ms:.2f} ms, plain {plain_ms:.2f} ms, "
                f"bound {bms:.2f} ms ({by})")
            if not ok:
                raise AssertionError(f"B3 S={S} disagrees with its plain version")
            cases.append(dict(kernel="fused_mlp", S=S, n_rays=n, max_abs_err=err,
                              ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by))

        S = 192
        o, d, z, vd = lego_rays(n, S, seed=7, device=device)
        got = fused_render.fused_render_rays(params, cfg, o, d, z, vd,
                                             white_bkgd=True, want_weights=True)
        want = fused_render.plain_render_rays(params, cfg, o, d, z, vd,
                                              white_bkgd=True)
        raw = fused_mlp.plain_nerf_forward_rays(params, cfg, o, d, z, vd)
        mask = raw[:, -1, 3].abs() >= 1e-2  # clear of the 1e10 sentinel flip
        checked = [abs_err(g[mask], w[mask], tol) for g, w in zip(got, want)]
        errs = [e for e, _ in checked]
        err = max(errs)
        ms = time_ms(lambda: fused_render.fused_render_rays(
            params, cfg, o, d, z, vd, white_bkgd=True, want_weights=False), 5)
        plain_ms = time_ms(lambda: fused_render.plain_render_rays(
            params, cfg, o, d, z, vd, white_bkgd=True), 5)
        bms, by = bound(cfg, params, n, S)
        log(f"B4 fused_render S={S}: max err {err:.3e} over {int(mask.sum())}/"
            f"{n} masked rays (rgb, disp, acc, weights, depth: "
            f"{', '.join(f'{e:.1e}' for e in errs)}; tol {tol:g}), {ms:.2f} ms, "
            f"plain {plain_ms:.2f} ms, bound {bms:.2f} ms ({by})")
        if not (all(ok for _, ok in checked) and int(mask.sum()) >= n // 20):
            raise AssertionError("B4 disagrees with its plain version")
        cases.append(dict(kernel="fused_render", S=S, n_rays=n, max_abs_err=err,
                          ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by))

    check_other_shapes(device, tol)

    # one gradient through each autograd.Function (backward recomputes
    # through the plain version) against autograd of the plain version
    o, d, z, vd = lego_rays(256, 64, seed=11, device=device)
    R = torch.randn(256, 64, 4, generator=torch.Generator().manual_seed(1)).to(device)

    def grad_o(fn):
        oo = o.clone().requires_grad_(True)
        fn(oo).backward()
        return oo.grad

    for name, f_kernel, f_plain in (
        ("fused_mlp", lambda oo: (fused_mlp.fused_nerf_forward_rays(
            params, cfg, oo, d, z, vd) * R).sum(),
         lambda oo: (fused_mlp.plain_nerf_forward_rays(
             params, cfg, oo, d, z, vd) * R).sum()),
        ("fused_render", lambda oo: sum(t.sum() for t in fused_render.fused_render_rays(
            params, cfg, oo, d, z, vd, white_bkgd=True)[:3]),
         lambda oo: sum(t.sum() for t in fused_render.plain_render_rays(
             params, cfg, oo, d, z, vd, white_bkgd=True)[:3])),
    ):
        gk, gp = grad_o(f_kernel), grad_o(f_plain)
        gerr, ok = abs_err(gk, gp, 1e-4)
        log(f"{name} gradient wrt rays_o: max err {gerr:.3e} (tol 1e-4, "
            "scaled by max(1, max|grad|))")
        if not ok:
            raise AssertionError(f"{name} gradient disagrees")
    return cases


def composite_inputs(n, S, seed, device):
    """Seeded composite inputs at a ray block's shape: raw [n, S, 4] ~ N(0, 2),
    depths and directions of lego_rays (S > 64: its sorted union)."""
    import torch

    _, d, z, _ = lego_rays(n, max(S, 64), seed, device)
    if S < 64:
        z = z[:, torch.linspace(0, 63, S).round().long()].contiguous()
    elif S > 64:
        z = z[:, :S].contiguous()
    g = torch.Generator().manual_seed(seed)
    raw = (torch.randn(n, S, 4, generator=g) * 2).to(device)
    return raw, z, d


def check_composite(device, n=32768):
    """B5 against its plain version: rgb, acc and weights within 1e-5
    absolute, depth and disp within 1e-5 relative (the same fp32 formula;
    the transmittance is a product in another association order), at the
    main path's shapes and the odd ones, with its times and its gradient."""
    import torch

    from nerf_shared_tpu_torch.ops.cuda import composite

    tol = 1e-5

    def errors(got, want):
        ab = {k: float((got[i] - want[i]).abs().max()) if got[i].numel() else 0.0
              for k, i in (("rgb", 0), ("acc", 2), ("weights", 3))}
        rel = {k: float(((got[i] - want[i]).abs() / want[i].abs().clamp(min=1e-12)).max())
               for k, i in (("disp", 1), ("depth", 4))}
        return ab, rel

    def check(label, raw, z, d):
        worst = 0.0
        for wb in (False, True):
            with torch.no_grad():
                got = composite.composite_fused(raw, z, d, white_bkgd=wb)
                want = composite.plain_composite(raw, z, d, white_bkgd=wb)
            torch.cuda.synchronize()
            ab, rel = errors(got, want)
            log(f"  B5 {label} white_bkgd={wb}: abs {', '.join(f'{k} {v:.1e}' for k, v in ab.items())}; "
                f"rel {', '.join(f'{k} {v:.1e}' for k, v in rel.items())} (tol {tol:g})")
            if max(ab.values()) > tol or max(rel.values()) > tol:
                raise AssertionError(f"B5 disagrees with its plain version at {label}")
            worst = max(worst, *ab.values())
        return worst

    cases = []
    for S, what in ((64, "coarse"), (192, "dense fine"), (48, "guided fine"),
                    (32, "froxel K")):
        raw, z, d = composite_inputs(n, S, seed=100 + S, device=device)
        err = check(f"{n} rays S={S} ({what})", raw, z, d)
        # device time (the profiler): a launch is shorter than the host's cost
        # of one call, which CUDA events around the call would measure
        with torch.no_grad():
            ms = device_ms(lambda: composite.composite_fused(raw, z, d, True), 20,
                           "composite_kernel")
            plain_ms = device_ms(lambda: composite.plain_composite(raw, z, d, True), 20)
            call_ms = time_ms(lambda: composite.composite_fused(raw, z, d, True), 20)
        t_bytes = composite.bytes_moved(n, S) / PEAK_BYTES
        t_ops = 40 * n * S / PEAK_FP32_FLOPS  # ~40 fp32 operations a sample
        bms, by = 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
        log(f"B5 composite S={S}: {ms:.4f} ms on the device ({call_ms:.4f} ms a call "
            f"by CUDA events), plain {plain_ms:.4f} ms on the device, bound {bms:.4f} ms "
            f"({by})")
        cases.append(dict(kernel="composite", S=S, n_rays=n, max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, call_ms=call_ms, bound_ms=bms, bound_by=by))
    for S in (1, 21):
        raw, z, d = composite_inputs(37, S, seed=S, device=device)
        check(f"37 rays S={S}", raw, z, d)
    R, S = 16, 24
    raw = torch.zeros(R, S, 4, device=device)
    raw[: R // 2, 0, 3] = 1e4       # opaque first sample
    raw[R // 2:, :, 3] = -100.0     # empty rays
    z = torch.linspace(2, 6, S, device=device).expand(R, S).contiguous()
    d = torch.tensor([[0.0, 0.0, -1.0]], device=device).expand(R, 3).contiguous()
    check("opaque and empty rays", raw, z, d)
    acc = composite.composite_fused(raw, z, d, white_bkgd=True)[2]
    if not (acc[: R // 2].min() > 0.999999 and acc[R // 2:].max() < 1e-6):
        raise AssertionError(f"B5 opaque / empty rays: acc {acc.tolist()}")

    # the gradient through the autograd.Function (remat through the plain
    # version) against autograd of the plain version
    raw, z, d = composite_inputs(256, 48, seed=5, device=device)
    g = torch.Generator().manual_seed(6)
    cot = [torch.randn(256, 3, generator=g).to(device),
           torch.randn(256, 48, generator=g).to(device)]

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in (raw, z, d)]
        rgb, _, _, w, _ = fn(*leaves, white_bkgd=True)
        ((rgb * cot[0]).sum() + (w * cot[1]).sum()).backward()
        return [t.grad for t in leaves]

    gerr = max(rel_err(a, b) for a, b in zip(grads(composite.composite_fused),
                                             grads(composite.plain_composite)))
    log(f"B5 gradient wrt raw, z, rays_d: max err {gerr:.1e} of max|grad| (tol 1e-5)")
    if not gerr <= 1e-5:
        raise AssertionError("B5 gradient disagrees")
    return cases


def lego_points(n, S, seed, device):
    """Points [n, S, 3] on seeded lego-like rays, their unit directions
    [n, 3] and a seeded cotangent g [n, S, 4] of the raw outputs."""
    import torch

    o, d, z, vd = lego_rays(n, S, seed, device)
    z = z[:, :S]
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).contiguous()
    g = torch.randn(n, S, 4, generator=torch.Generator().manual_seed(seed + 1))
    return pts, vd, g.to(device)


def rel_err(got, want):
    """max |got - want| / max(1e-12, max |want|)."""
    return float((got - want).abs().max()) / max(1e-12, float(want.abs().max()))


def bwd_bound(cfg, params, n):
    """(bound_ms, bound_by) of B2 on n points: its FLOPs (three forwards
    less the narrow heads) over the fp32 peak vs its bytes (points,
    directions, cotangent and weights in; dx and the gradients out)."""
    from nerf_shared_tpu_torch.ops.cuda.fused_mlp import network_bytes
    from nerf_shared_tpu_torch.ops.cuda.fused_mlp_bwd import flops_per_point_bwd

    flops = flops_per_point_bwd(cfg) * n
    nbytes = 4 * (n * 3 + n * 4 + n * 6) + 2 * network_bytes(params, cfg)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_train_kernels(cfg, params, pts, vd, g, tol_fwd, tol_bwd, label):
    """B1 and B2 against their plain versions on one input; returns
    (B1 max abs err, B2 errors by tensor relative to max |grad|)."""
    import torch

    from nerf_shared_tpu_torch.models.nerf import apply_nerf
    from nerf_shared_tpu_torch.ops.cuda import fused_mlp, fused_mlp_bwd

    with torch.no_grad():
        e1, ok1 = abs_err(fused_mlp.fused_nerf_forward(params, cfg, pts, vd),
                          apply_nerf(params, cfg, pts, vd), tol_fwd)
    got = fused_mlp_bwd.fused_mlp_backward(params, cfg, pts, vd, g)
    want = fused_mlp_bwd.plain_mlp_backward(params, cfg, pts, vd, g)
    torch.cuda.synchronize()
    pairs = [(got[0][k], w) for k, w in want[0].items()] + [(got[1], want[1])]
    names = list(want[0]) + ["dpts"]
    if vd is not None:
        pairs.append((got[2], want[2]))
        names.append("ddirs")
    errs = {k: rel_err(a, b) for k, (a, b) in zip(names, pairs)}
    e2 = max(float((a - b).abs().max()) for a, b in pairs)
    worst = max(errs, key=errs.get)
    log(f"  {label}: B1 max err {e1:.1e} (tol {tol_fwd:g} x max(1, max|plain|)); "
        f"B2 max abs err {e2:.1e}, worst {worst} {errs[worst]:.1e} of its max|grad| "
        f"(tol {tol_bwd:g}) over {len(errs)} tensors")
    if not ok1:
        raise AssertionError(f"B1 disagrees with its plain version at {label}")
    if not errs[worst] <= tol_bwd:
        raise AssertionError(f"B2 disagrees with its plain version at {label}: {errs}")
    return e1, e2, errs


def phase_train_kernels(device):
    """Phase 5: B1 and B2 at both training shapes of the lego recipe and at
    the odd shapes, with times."""
    import torch

    from nerf_shared_tpu_torch.models.nerf import NeRF, NeRFConfig, apply_nerf
    from nerf_shared_tpu_torch.ops.cuda import fused_mlp, fused_mlp_bwd

    cfg = NeRFConfig(D=8, W=256, skips=(4,), use_viewdirs=True, multires=10,
                     multires_views=4)
    params = {k: v.detach() for k, v in NeRF(
        cfg, device=device, generator=torch.Generator().manual_seed(5)).params().items()}
    # B1: as B3 (fp32 sums over <= 283 terms in another order than cuBLAS).
    # B2: each gradient sums up to 196,608 per-point products in fp32 in
    # another order than cuBLAS (per-block partials, then a fixed-order sum
    # over 132 blocks): the error is held relative to max |grad| per tensor
    tol_fwd, tol_bwd = 2e-4, 1e-3
    cases = []
    for S in (64, 192):
        n_rays = 1024
        pts, vd, g = lego_points(n_rays, S, seed=S, device=device)
        e1, e2, errs = check_train_kernels(cfg, params, pts, vd, g, tol_fwd, tol_bwd,
                                           f"lego N={n_rays * S} S={S}")
        with torch.no_grad():
            ms1 = time_ms(lambda: fused_mlp.fused_nerf_forward(params, cfg, pts, vd), 5)
            plain1 = time_ms(lambda: apply_nerf(params, cfg, pts, vd), 5)
        ms2 = time_ms(lambda: fused_mlp_bwd.fused_mlp_backward(params, cfg, pts, vd, g), 5)
        plain2 = time_ms(lambda: fused_mlp_bwd.plain_mlp_backward(params, cfg, pts, vd, g), 5)
        b1, by1 = bound(cfg, params, n_rays, S)
        b2, by2 = bwd_bound(cfg, params, n_rays * S)
        log(f"B1 fused_mlp points N={n_rays * S}: {ms1:.2f} ms, plain {plain1:.2f} ms, "
            f"bound {b1:.2f} ms ({by1})")
        log(f"B2 fused_mlp_bwd N={n_rays * S}: {ms2:.2f} ms, plain {plain2:.2f} ms, "
            f"bound {b2:.2f} ms ({by2})")
        cases.append(dict(kernel="fused_mlp_points", S=S, n_points=n_rays * S,
                          max_abs_err=e1, ms=ms1, plain_ms=plain1, bound_ms=b1,
                          bound_by=by1))
        cases.append(dict(kernel="fused_mlp_bwd", S=S, n_points=n_rays * S,
                          max_abs_err=e2, max_rel_err=max(errs.values()), ms=ms2,
                          plain_ms=plain2, bound_ms=b2, bound_by=by2))
    archs = [dict(D=3, W=64, skips=(1,), use_viewdirs=False, output_ch=5),
             dict(D=8, W=256, skips=(4,), multires=15, multires_views=6),
             dict(D=2, W=30, skips=(0,), i_embed=-1),
             dict(D=5, W=128, skips=(1, 3), multires=6, multires_views=2)]
    for i, kw in enumerate(archs):
        acfg = NeRFConfig(**kw)
        ap = {k: v.detach() for k, v in NeRF(
            acfg, device=device, generator=torch.Generator().manual_seed(i)).params().items()}
        for n_rays, S in ((37, 7), (300, 65)):
            pts, vd, g = lego_points(n_rays, S, seed=10 + i, device=device)
            vd = vd if acfg.use_viewdirs else None
            g = g[..., :fused_mlp.out_channels(acfg)].contiguous() if acfg.use_viewdirs \
                else torch.cat([g, g[..., :1]], -1).contiguous()
            check_train_kernels(acfg, ap, pts, vd, g, tol_fwd, tol_bwd,
                                f"{kw} N={n_rays * S}")
    return cases, check_train_step(device)


def train_step_setup(device, fused):
    """A lego-recipe training step on a seeded state: (state, step_fn,
    images, poses, overrides, spec). Two 400x400 seeded images, 64 + 128
    samples per ray, N_rand 1024 inside the precrop window; the stratified
    jitter and inverse-CDF draws are pinned."""
    import torch

    from nerf_shared_tpu_torch.data.poses import pose_spherical
    from nerf_shared_tpu_torch.models.nerf import NeRFConfig
    from nerf_shared_tpu_torch.render.renderer import RenderConfig
    from nerf_shared_tpu_torch.train.pipeline import PixelSamplerSpec
    from nerf_shared_tpu_torch.train.state import create_train_state
    from nerf_shared_tpu_torch.train.step import make_train_step

    cfg = NeRFConfig(D=8, W=256, skips=(4,), use_viewdirs=True, multires=10,
                     multires_views=4, output_ch=5)
    H = 400
    focal = 0.5 * H / math.tan(0.5 * 0.6911112)
    K = [[focal, 0, H / 2], [0, focal, H / 2], [0, 0, 1]]
    g = torch.Generator().manual_seed(21)
    images = torch.rand(2, H, H, 3, generator=g).to(device)
    poses = torch.stack([torch.as_tensor(pose_spherical(a, -30.0, 4.0)[:3, :4])
                         for a in (0.0, 120.0)]).float().to(device)
    spec = PixelSamplerSpec.from_K(H, H, K, 1024, single_image=True,
                                   precrop_iters=500, precrop_frac=0.5)
    rcfg = RenderConfig(perturb=1.0, N_importance=128, N_samples=64,
                        use_viewdirs=True, white_bkgd=True, near=2.0, far=6.0,
                        fused_backward=fused)
    overrides = {"t_rand": torch.rand(1024, 64, generator=g).to(device),
                 "u": torch.rand(1024, 128, generator=g).to(device)}
    state = create_train_state(cfg, cfg, device, seed=3, lrate=5e-4, lrate_decay=500)
    return state, make_train_step(rcfg, cfg, cfg, spec), images, poses, overrides


def check_train_step(device):
    """One training step through B1 + B2 and through the plain path from
    the same state and draws; returns the step times (ms, median of 3
    after one warm-up step each)."""
    import torch

    from nerf_shared_tpu_torch.ops.cuda import fused_mlp, fused_mlp_bwd

    out = {}
    for fused in (True, False):
        state, step, images, poses, ov = train_step_setup(device, fused)
        before = (fused_mlp.POINT_LAUNCHES, fused_mlp_bwd.LAUNCHES)
        aux = step(state, images, poses, torch.Generator().manual_seed(9), overrides=ov)
        torch.cuda.synchronize()
        launched = (fused_mlp.POINT_LAUNCHES - before[0], fused_mlp_bwd.LAUNCHES - before[1])
        out[fused] = dict(loss=float(aux["loss"]), launched=launched,
                          grads=[p.grad.detach().clone() for p in state.parameters()],
                          params=[p.detach().clone() for p in state.parameters()])

        def again():
            step(state, images, poses, torch.Generator().manual_seed(9), overrides=ov)

        out[fused]["ms"] = time_ms(again, 3)
    k, p = out[True], out[False]
    if k["launched"] != (2, 2) or p["launched"] != (0, 0):
        raise AssertionError(f"step launches: kernels {k['launched']}, plain {p['launched']}")
    loss_err = abs(k["loss"] - p["loss"]) / abs(p["loss"])
    grad_err = max(rel_err(a, b) for a, b in zip(k["grads"], p["grads"]))
    # Adam's first update is u(g) = lr * g / (|g| + eps) (m and v start at
    # zero), so three checks of the post-Adam parameters:
    # - everywhere they differ by u(g_plain) - u(g_kernel), to fp32 rounding;
    # - where |g_plain| is over 100 eps and over 100 |g_kernel - g_plain|,
    #   that difference is below lr * 1e-4, so they agree to 1e-6 outright;
    # - the entries that moved apart by more than 1e-6 (|g| near eps, or a
    #   sign flip of a gradient near 0) are at most 1 in 100: 307 and 1,656
    #   of 1,191,688 in two runs on the H100, so a wholesale flip of the
    #   small gradients fails while the run-to-run spread passes
    lr, eps = 5e-4, 1e-8
    n_par, n_sure, moved, adam_err, param_err, moved_g = 0, 0, 0, 0.0, 0.0, 0.0

    def adam1(g):
        return lr * g / (g.abs() + eps)

    for pk, pp, gk, gp in zip(k["params"], p["params"], k["grads"], p["grads"]):
        du = adam1(gp) - adam1(gk)
        adam_err = max(adam_err, float(((pk - pp) - du).abs().max()))
        far = du.abs() > 1e-6
        moved += int(far.sum())
        if bool(far.any()):
            moved_g = max(moved_g, float(gp[far].abs().max() / gp.abs().max()))
        sure = (gp.abs() > 100 * eps) & (gp.abs() > 100 * (gk - gp).abs())
        if bool(sure.any()):
            param_err = max(param_err, float((pk - pp)[sure].abs().max()))
        n_sure += int(sure.sum())
        n_par += gp.numel()
    moved_tol = n_par // 100
    log(f"train step (N_rand 1024, 64 + 128 samples): kernels {k['ms']:.2f} ms, plain "
        f"{p['ms']:.2f} ms; loss rel err {loss_err:.1e} (tol 1e-5), worst gradient "
        f"{grad_err:.1e} of max|grad| (tol 1e-3); post-Adam params: {param_err:.1e} "
        f"apart on the {n_sure} of {n_par} entries whose gradient dwarfs eps and the "
        f"gradient difference (tol 1e-6), {adam_err:.1e} from Adam's update of the "
        f"two gradients everywhere (tol 1e-6), {moved} entries moved apart by more "
        f"than 1e-6 (tol {moved_tol}), the largest |grad| among them {moved_g:.1e} "
        "of its tensor's max")
    if not (loss_err <= 1e-5 and grad_err <= 1e-3 and param_err <= 1e-6
            and adam_err <= 1e-6 and moved <= moved_tol):
        raise AssertionError("the kernel training step disagrees with the plain step")
    return {"kernel_ms": k["ms"], "plain_ms": p["ms"], "loss_rel_err": loss_err,
            "grad_rel_err": grad_err, "param_err": param_err, "adam_err": adam_err,
            "moved": moved, "moved_tol": moved_tol, "moved_max_grad": moved_g,
            "sure": n_sure, "n_params": n_par}


def _render_view(job):
    """One RGBA view of the hard scene, written as a PNG (pool worker)."""
    sys.path.insert(0, REPO)
    import numpy as np

    from benchmarks import hard_scene
    from nerf_shared_tpu_torch.data.images import imwrite_u8

    path, pose, size, focal = job
    rgba = hard_scene.render_gt_rgba(np.asarray(pose), size, size, focal)
    imwrite_u8(path, (np.clip(rgba, 0, 1) * 255).astype(np.uint8))


def write_train_scene(root, size=800, n_train=24, n_val=2, n_test=2, workers=8):
    """A 3-D-consistent blender-format scene: benchmarks/hard_scene.py's
    textured sphere and rods, seen from a radius-4 orbit at heights 12-50
    degrees, near 2, far 6; views rendered in a spawn-context pool."""
    sys.path.insert(0, REPO)
    import numpy as np

    from benchmarks import hard_scene

    n = n_train + n_val + n_test
    rng = np.random.default_rng(11)
    poses = []
    for i in range(n):
        th = 2 * np.pi * i / n
        phi = np.deg2rad(12.0 + 38.0 * rng.random())
        eye = 4.0 * np.array([np.cos(phi) * np.sin(th), np.sin(phi),
                              np.cos(phi) * np.cos(th)])
        poses.append(hard_scene._look_at(eye))
    focal = 1.1 * size
    order = np.random.default_rng(5).permutation(n)
    splits = {"train": order[:n_train], "val": order[n_train:n_train + n_val],
              "test": order[n_train + n_val:]}
    jobs = []
    for split, idxs in splits.items():
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for j, i in enumerate(idxs):
            rel = f"{split}/r_{j}"
            jobs.append((os.path.join(root, rel + ".png"), poses[i].tolist(), size, focal))
            pose = np.eye(4)
            pose[:3] = poses[i]
            frames.append({"file_path": rel, "transform_matrix": pose.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": float(2 * np.arctan(0.5 * size / focal)),
                       "near": hard_scene.NEAR, "far": hard_scene.FAR,
                       "frames": frames}, f)
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        pool.map(_render_view, jobs)


class _Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, text):
        self.buf.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def run_train_cli(argv):
    """apps.train.main(argv) with its stdout kept -> (result, text)."""
    from nerf_shared_tpu_torch.apps import train

    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        result = train.main(argv)
    return result, tee.buf.getvalue()


def phase_training(device, steps=600, more=200):
    """Phase 6: train, resume and render_only through the CLI."""
    import re

    import numpy as np
    import torch

    from nerf_shared_tpu_torch.config import config_parser
    from nerf_shared_tpu_torch.data.datasets import load_datasets
    from nerf_shared_tpu_torch.ops.cuda import composite, fused_mlp
    from nerf_shared_tpu_torch.train.state import lr_at

    scene, logs = os.path.join(WORK, "train_scene"), os.path.join(WORK, "train_logs")
    t0 = time.perf_counter()
    write_train_scene(scene)
    log(f"phase 6: wrote the 28-view 800x800 scene in {time.perf_counter() - t0:.1f} s")
    base = ["--config", os.path.join(REPO, "configs", "lego.txt"), "--datadir", scene,
            "--basedir", logs, "--expname", "lego_smoke", "--device", device,
            "--testskip", "1", "--i_print", "50", "--i_testset", "0",
            "--i_video", "0", "--i_img", "200", "--i_weights", str(steps)]

    zero_counts()
    t0 = time.perf_counter()
    state, text = run_train_cli(base + ["--N_iters", str(steps)])
    first_wall = time.perf_counter() - t0
    state2, text2 = run_train_cli(base + ["--N_iters", str(steps + more)])
    wall = time.perf_counter() - t0
    launches = launch_counts()
    zero_counts()
    _, text3 = run_train_cli(base + ["--N_iters", str(steps + more), "--render_only",
                                     "--render_test"])
    render_launches = {"fused_mlp": fused_mlp.LAUNCHES, "composite": composite.LAUNCHES}

    total = steps + more
    if launches["fused_mlp_points"] != 2 * total or launches["fused_mlp_bwd"] != 2 * total:
        raise AssertionError(f"expected B1 and B2 launched {2 * total} times: {launches}")
    train_lines = re.findall(r"\[TRAIN\] Iter: (\d+) Loss: \S+\s+PSNR: (\S+)\s+rays/sec: (\S+)",
                             text + text2)
    psnrs = [float(p) for _, p, _ in train_lines]
    rps = [float(r.replace(",", "")) for _, _, r in train_lines]
    vals = re.findall(r"\[VAL\] Iter: (\d+) view (\d+) PSNR: (\S+) SSIM: (\S+)", text + text2)
    if "Reloading from" not in text2:
        raise AssertionError("the resumed run did not reload its checkpoint")
    if state2.count != total or state2.step != total:
        raise AssertionError(f"resume: Adam count {state2.count}, step {state2.step}, "
                             f"expected {total}")
    lr = state2.optimizer.param_groups[0]["lr"]
    if abs(lr - lr_at(5e-4, 500, total - 1)) > 1e-12:
        raise AssertionError(f"resumed lr {lr} is off the schedule")
    if not psnrs or psnrs[-1] <= psnrs[0] + 1.0:
        raise AssertionError(f"train PSNR did not rise: {psnrs}")

    # the held-out view against an all-white frame
    args = config_parser().parse_args(base)
    ds = load_datasets(args)
    it, view, vpsnr, vssim = vals[-1]
    white = float(np.mean((1.0 - ds.images[int(view)]) ** 2))
    white_psnr = -10.0 * math.log10(white)
    log(f"held-out view {view} at step {it}: PSNR {float(vpsnr):.2f} dB, SSIM {vssim}; "
        f"all-white frame {white_psnr:.2f} dB")
    if not float(vpsnr) >= white_psnr + 2.0:
        raise AssertionError("held-out PSNR is not 2 dB above the all-white frame")

    # both checkpoint formats carry Adam state
    expdir = os.path.join(logs, "lego_smoke")
    tar = torch.load(os.path.join(expdir, f"{total:06d}.tar"), map_location="cpu",
                     weights_only=True)
    st = tar["optimizer_state_dict"]["state"]
    with np.load(os.path.join(expdir, f"{total:06d}.ckpt.npz")) as z:
        npz_count = int(z["opt/count"])
        npz_mu = float(np.abs(z["opt/mu/fine/pts_linears/0/w"]).max())
    if not (len(st) == len(state2.parameters()) and int(st[0]["step"]) == total
            and npz_count == total
            and float(st[0]["exp_avg"].abs().max()) > 0 and npz_mu > 0):
        raise AssertionError("checkpoints lack Adam state")
    pngs = sorted(f for f in os.listdir(os.path.join(
        expdir, f"renderonly_test_{total:06d}")) if f.endswith(".png"))
    per_view = 2 * len(ds.i_test) * math.ceil(400 * 400 / args.chunk)
    if len(pngs) != len(ds.i_test) or render_launches != {"fused_mlp": per_view,
                                                          "composite": per_view}:
        raise AssertionError(f"render_only: {len(pngs)} PNGs, launches {render_launches}")
    ms_step = 1e3 * args.N_rand / statistics.median(rps[1:])
    log(f"trained {steps} + {more} steps in {wall:.1f} s ({first_wall:.1f} s for the first "
        f"{steps}, hooks and start-up included); median {statistics.median(rps[1:]):,.0f} "
        f"rays/s = {ms_step:.1f} ms per step; train PSNR {psnrs[0]:.2f} -> {psnrs[-1]:.2f} "
        f"dB; launches {launches}; render_only {len(pngs)} views, launches "
        f"{render_launches}")
    return {"launches": launches, "ms_per_step": ms_step,
            "rays_per_s": statistics.median(rps[1:]), "train_psnr": psnrs,
            "val": [(int(a), int(b), float(c), float(d)) for a, b, c, d in vals],
            "white_psnr": white_psnr, "render_launches": render_launches,
            "base_argv": base}


def profile_train_step(device, steps=5):
    """``steps`` consecutive kernel training steps under torch.profiler
    (after one warm-up step): device busy share of their wall time and the
    top kernels. Several steps, so the host's run-ahead between steps is
    part of the window, as it is in training."""
    import torch

    state, step, images, poses, ov = train_step_setup(device, True)
    step(state, images, poses, torch.Generator().manual_seed(9), overrides=ov)
    torch.cuda.synchronize()

    def run():
        for i in range(steps):
            step(state, images, poses, torch.Generator().manual_seed(i), overrides=ov)

    _profile(f"{steps} training steps", run)


def write_scene(root, size=800, n_train=2, n_val=1, n_test=2):
    """A blender-format scene: an RGBA blob seen from the lego orbit."""
    import numpy as np

    from nerf_shared_tpu_torch.data.images import imwrite_u8
    from nerf_shared_tpu_torch.data.poses import pose_spherical

    yy, xx = np.mgrid[:size, :size]
    blob = ((yy - size / 2) ** 2 + (xx - size / 2) ** 2) < (size / 3) ** 2
    img = np.zeros((size, size, 4), np.uint8)
    img[..., 0], img[..., 1], img[..., 3] = blob * 200, blob * 80, blob * 255
    for split, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for i in range(n):
            rel = f"{split}/r_{i}"
            imwrite_u8(os.path.join(root, rel + ".png"), img)
            pose = pose_spherical(360.0 * i / n, -30.0, 4.0)
            frames.append({"file_path": rel, "transform_matrix": pose.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.6911112, "frames": frames}, f)


def http(url, body=None):
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


class Served:
    """The port's HTTP service on port 0, as apps/serve.main builds it (on
    ``ds`` when given, so several services share one loaded dataset)."""

    def __init__(self, argv, ds=None):
        from nerf_shared_tpu_torch.apps.serve import RenderService, make_server, serve_parser
        from nerf_shared_tpu_torch.apps.train import build_eval_engine

        self.args = serve_parser().parse_args(argv)
        self.service = RenderService(self.args, build_eval_engine(self.args, ds=ds))
        self.server = make_server(self.service, "127.0.0.1", 0)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        host, port = self.server.server_address[:2]
        self.base = f"http://{host}:{port}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join()


def frame_mask(engine, c2w):
    """Pixels whose final fine sample has |sigma| >= 1e-2 (clear of the 1e10
    sentinel), from a B3 render of the frame with raw outputs."""
    import torch

    with torch.no_grad():
        _, _, _, extras = engine.renderer.render(
            engine.H, engine.W, engine.K, engine.coarse, engine.fine,
            chunk=engine.args.chunk, c2w=c2w, retraw=True)
    return (extras["raw"][..., -1, 3].abs() >= 1e-2).cpu().numpy()


def phase_serving(device, size=800):
    import dataclasses

    import numpy as np
    import torch

    from nerf_shared_tpu_torch.data.images import png_decode
    from nerf_shared_tpu_torch.data.poses import pose_spherical
    from nerf_shared_tpu_torch.models.nerf import NeRF, NeRFConfig
    from nerf_shared_tpu_torch.ops.cuda import composite, fused_mlp, fused_render
    from nerf_shared_tpu_torch.render.renderer import Renderer
    from nerf_shared_tpu_torch.utils.checkpoints import save_tar
    from nerf_shared_tpu_torch.utils.metrics import to8b

    scene, logs = os.path.join(WORK, "scene"), os.path.join(WORK, "logs")
    t0 = time.perf_counter()
    write_scene(scene, size)
    g = torch.Generator().manual_seed(1)
    cfg = NeRFConfig(D=8, W=256, skips=(4,), use_viewdirs=True, multires=10,
                     multires_views=4, output_ch=5)
    coarse, fine = NeRF(cfg, generator=g), NeRF(cfg, generator=g)
    save_tar(os.path.join(logs, "smoke", "000000.tar"), coarse.state_dict(),
             fine.state_dict(), 0)
    argv = ["--config", os.path.join(REPO, "configs", "lego.txt"),
            "--datadir", scene, "--basedir", logs, "--expname", "smoke",
            "--port", "0", "--device", device]
    served = Served(argv)
    eng = served.service.engine
    log(f"scene + checkpoint + engine in {time.perf_counter() - t0:.1f} s: "
        f"{eng.W}x{eng.H} frames, chunk {eng.args.chunk}, engine {eng.engine_name}")
    H = size // 2  # lego.txt: half_res
    if (eng.H, eng.W) != (H, H):
        raise AssertionError(f"expected {H}x{H} frames, got {eng.W}x{eng.H}")
    per_frame = 2 * math.ceil(eng.H * eng.W / eng.args.chunk)

    pose_a = pose_spherical(30.0, -30.0, 4.0)
    try:
        zero_counts()
        t0 = time.perf_counter()
        replies = [
            http(served.base + "/render?theta=30&phi=-30&radius=4"),
            http(served.base + "/render", {"c2w": pose_a.tolist(), "fmt": "npy"}),
            http(served.base + "/render?theta=120&phi=-20&radius=4.5"),
        ]
        wall = time.perf_counter() - t0
        launches = {"fused_mlp": fused_mlp.LAUNCHES,
                    "fused_render": fused_render.LAUNCHES,
                    "composite": composite.LAUNCHES}
        code, ctype, metrics = http(served.base + "/metrics")
        health = json.loads(http(served.base + "/health")[2])
        info = json.loads(http(served.base + "/info")[2])
    finally:
        served.close()
    lat = served.service._latencies
    log(f"served 3 frames in {wall:.2f} s: {', '.join(f'{x * 1e3:.0f}' for x in lat)} "
        f"ms per frame (server side); launches {launches}; info {info}")
    if code != 200 or "nerf_render_frames_total 3" not in metrics.decode():
        raise AssertionError(f"/metrics: {code} {metrics[:200]!r}")
    if health != {"status": "ok", "step": 0} or info["device"] != device:
        raise AssertionError(f"/health {health} /info {info}")
    for status, ct, _ in replies:
        if status != 200:
            raise AssertionError(f"render request failed: {status} {ct}")
    png_a, png_b = png_decode(replies[0][2]), png_decode(replies[2][2])
    frame = np.load(io.BytesIO(replies[1][2]))
    for name, img in (("GET png", png_a), ("GET png", png_b)):
        if img.shape != (H, H, 3) or img.dtype != np.uint8:
            raise AssertionError(f"{name}: {img.shape} {img.dtype}")
    if frame.shape != (H, H, 3) or not np.isfinite(frame).all():
        raise AssertionError(f"POST npy frame is not a finite {H}x{H}x3 image")
    if not np.array_equal(to8b(frame), png_a):
        raise AssertionError("PNG and npy renders of one pose differ")
    if launches != {"fused_mlp": 3 * per_frame, "fused_render": 0,
                    "composite": 3 * per_frame}:
        raise AssertionError(f"expected {3 * per_frame} B3 and B5 launches, got {launches}")

    # the frame against the plain renderer on a band of 4000 rays
    plain = Renderer(**{**dataclasses.asdict(eng.renderer.cfg), "perturb": 0.0,
                        "use_pallas": False, "fused_composite": False})
    c2w = torch.as_tensor(pose_a[:3, :4], device=device)
    rays, _ = plain._pack_rays(eng.H, eng.W, eng.K, None, c2w, device)
    band = slice((H // 2 - 5) * H, (H // 2 + 5) * H)
    with torch.no_grad():
        ref = plain.render_flat_rays(rays[band], eng.coarse, eng.fine,
                                     chunk=eng.args.chunk, retraw=True)
    keep = (ref["raw"][:, -1, 3].abs() >= 1e-2).cpu().numpy()
    err = float(np.abs(frame.reshape(-1, 3)[band][keep]
                       - ref["rgb_map"].cpu().numpy()[keep]).max())
    log(f"served frame vs plain renderer on {int(keep.sum())}/{10 * H} band rays: "
        f"max err {err:.2e} (tol 1e-3)")
    if not err <= 1e-3:
        raise AssertionError("served frame disagrees with the plain renderer")
    mask = frame_mask(eng, c2w)

    # phase 4: the same request through an engine with --fused_composite
    served = Served(argv + ["--fused_composite", "True"])
    try:
        zero_counts()
        status, _, body = http(served.base + "/render",
                               {"c2w": pose_a.tolist(), "fmt": "npy"})
        fused_launches = {"fused_mlp": fused_mlp.LAUNCHES,
                          "fused_render": fused_render.LAUNCHES,
                          "composite": composite.LAUNCHES}
    finally:
        served.close()
    fused_frame = np.load(io.BytesIO(body))
    ferr = float(np.abs(fused_frame - frame)[mask].max())
    log(f"fused-composite frame: {served.service._latencies[0] * 1e3:.0f} ms, "
        f"launches {fused_launches}, max err vs phase 3 {ferr:.2e} over "
        f"{int(mask.sum())}/{mask.size} masked pixels (tol 1e-3)")
    if status != 200 or not np.isfinite(fused_frame).all():
        raise AssertionError("fused-composite request failed")
    if fused_launches != {"fused_mlp": per_frame // 2, "fused_render": per_frame // 2,
                          "composite": per_frame // 2}:
        raise AssertionError(f"fused-composite launches: {fused_launches}")
    if not ferr <= 1e-3:
        raise AssertionError("fused-composite frame disagrees with phase 3")
    return {"launches": {"dense": launches, "fused_composite": fused_launches},
            "frame_ms": {"dense": [x * 1e3 for x in lat],
                         "fused_composite": [x * 1e3 for x in
                                             served.service._latencies]},
            "engine": eng, "pose": pose_a}


FAST_ENGINES = (
    ("guided", ["--render_guided", "48"], "dense"),
    ("gated", ["--render_gate", "1e-3"], "gated"),
    ("occ_froxel", ["--occ_grid", "128", "--occ_keep", "32", "--occ_fine", "16"],
     "occ-froxel"),
    ("occ_grid", ["--occ_grid", "128", "--occ_keep", "32", "--occ_fine", "16",
                  "--occ_mode", "grid"], "occ-grid"),
)


def launch_counts():
    from nerf_shared_tpu_torch.ops.cuda import composite, fused_mlp, fused_mlp_bwd, fused_render

    return {"fused_mlp_points": fused_mlp.POINT_LAUNCHES, "fused_mlp": fused_mlp.LAUNCHES,
            "fused_render": fused_render.LAUNCHES, "fused_mlp_bwd": fused_mlp_bwd.LAUNCHES,
            "composite": composite.LAUNCHES}


def zero_counts():
    from nerf_shared_tpu_torch.ops.cuda import composite, fused_mlp, fused_mlp_bwd, fused_render

    fused_mlp.POINT_LAUNCHES = fused_mlp.LAUNCHES = fused_render.LAUNCHES = 0
    fused_mlp_bwd.LAUNCHES = composite.LAUNCHES = 0


def engine_maps(eng, kernels, c2w, guided=None):
    """(rgb [H,W,3], acc [H,W], z, active) of one pose through ``eng``'s
    path, as render_from_batch_poses dispatches it, with the kernels or
    through the plain versions (``kernels`` False); ``guided`` overrides the
    config's. z is the fine pass's sample depths [H,W,S] on the dense
    (guided) path, else None; active is the share of rays that reach the
    fine pass (gated) or keep an occupied sample (occupancy), else None."""
    import dataclasses

    import torch

    from nerf_shared_tpu_torch.apps.train import _occ_render_args
    from nerf_shared_tpu_torch.render.renderer import Renderer

    a = eng.args
    cfg = dataclasses.asdict(eng.renderer.cfg)
    cfg.update(perturb=0.0, raw_noise_std=0.0,
               use_pallas=kernels and cfg["use_pallas"],
               fused_composite=kernels and cfg["fused_composite"])
    if guided is not None:
        cfg["guided"] = guided
    r = Renderer(**cfg)
    with torch.no_grad():
        if eng.occ_grid is not None:
            o = _occ_render_args(a)
            _, out = r.render_image_occ(
                eng.H, eng.W, eng.K, c2w, eng.fine, eng.occ_grid, chunk=a.chunk,
                n_candidates=o["occ_candidates"], n_keep=o["occ_keep"],
                mode=o["occ_mode"], tile=o["occ_tile"], select=o["occ_select"],
                n_fine=o["occ_fine"])
            rgb, acc, z = out["rgb_map"], out["acc_map"], None
            active = float((out["n_active"] > 0).float().mean())
        elif a.render_gate > 0.0:
            _, out = r.render_image_gated(eng.H, eng.W, eng.K, c2w, eng.coarse,
                                          eng.fine, chunk=a.chunk,
                                          threshold=a.render_gate)
            rgb, acc, z = out["rgb_map"], out["acc_map"], None
            active = out["active_fraction"]
        else:
            rgb, _, acc, extras = r.render(eng.H, eng.W, eng.K, eng.coarse, eng.fine,
                                           chunk=a.chunk, c2w=c2w, retraw=False,
                                           retweights=True)
            z, active = extras["z_vals"].cpu().numpy(), None
    return rgb.float().cpu().numpy(), acc.float().cpu().numpy(), z, active


def plain_fine_pass(eng, c2w, z):
    """(rgb [H,W,3], acc [H,W]) of ``eng``'s fine network at the depths z
    [H,W,S] through the plain versions (network and raw2outputs)."""
    import torch

    from nerf_shared_tpu_torch.ops.compositing import raw2outputs
    from nerf_shared_tpu_torch.ops.cuda.fused_mlp import plain_nerf_forward_rays

    dev = eng.device
    rays, _ = eng.renderer._pack_rays(eng.H, eng.W, eng.K, None,
                                      torch.as_tensor(c2w, device=dev), dev)
    z = torch.as_tensor(z, device=dev).reshape(rays.shape[0], -1)
    params, cfg = eng.fine.params(), eng.fine.cfg
    rgb, acc = [], []
    with torch.no_grad():
        for i in range(0, rays.shape[0], eng.args.chunk):
            rb, zz = rays[i:i + eng.args.chunk], z[i:i + eng.args.chunk].contiguous()
            ro, rd, vd = (rb[:, 0:3].contiguous(), rb[:, 3:6].contiguous(),
                          rb[:, -3:].contiguous())
            raw = plain_nerf_forward_rays(params, cfg, ro, rd, zz, vd)
            out = raw2outputs(raw, zz, rd, white_bkgd=eng.renderer.cfg.white_bkgd)
            rgb.append(out[0])
            acc.append(out[2])
    return (torch.cat(rgb).reshape(eng.H, eng.W, 3).cpu().numpy(),
            torch.cat(acc).reshape(eng.H, eng.W).cpu().numpy())


def psnr(a, b):
    import numpy as np

    mse = float(np.mean((np.asarray(a, np.float64) - b) ** 2))
    return -10.0 * math.log10(mse) if mse > 0 else float("inf")


def phase_fast_serving(device, base_argv, profile=False):
    """Phase 7: the fast engines over HTTP on phase 6's checkpoint (with
    ``profile``, one more frame of each engine under torch.profiler)."""
    import numpy as np

    from nerf_shared_tpu_torch.apps.serve import serve_parser
    from nerf_shared_tpu_torch.data.datasets import load_datasets

    argv = base_argv + ["--port", "0"]
    ds = load_datasets(serve_parser().parse_args(argv))
    view = int(ds.i_test[0])
    pose, gt = ds.poses[view][:3, :4], ds.images[view]
    per_frame = None
    results, dense, bad = {}, None, []
    for name, flags, engine in FAST_ENGINES:
        zero_counts()
        t0 = time.perf_counter()
        served = Served(argv + flags, ds=ds)
        build_s = time.perf_counter() - t0
        build = launch_counts()
        eng = served.service.engine
        try:
            zero_counts()
            status, _, body = http(served.base + "/render",
                                   {"c2w": pose.tolist(), "fmt": "npy"})
            launches = launch_counts()
            status2, _, body2 = http(served.base + "/render",
                                     {"c2w": pose.tolist(), "fmt": "npy"})
            info = json.loads(http(served.base + "/info")[2])
        finally:
            served.close()
        frame = np.load(io.BytesIO(body))
        # the first request of an engine meets its shapes for the first time
        first_ms, ms = (t * 1e3 for t in served.service._latencies[:2])
        again = float(np.abs(np.load(io.BytesIO(body2)) - frame).max()) if status2 == 200 else None
        if again is None or not again <= 1e-6:
            raise AssertionError(f"{name}: a second request of the pose gave {status2}, "
                                 f"max difference {again}")
        if per_frame is None:
            per_frame = math.ceil(eng.H * eng.W / eng.args.chunk)
        if status != 200 or frame.shape != (eng.H, eng.W, 3) or not np.isfinite(frame).all():
            raise AssertionError(f"{name}: no finite {eng.H}x{eng.W} frame ({status})")
        if info["engine"] != engine or info["occ_fine"] != eng.args.occ_fine:
            raise AssertionError(f"{name}: /info {info}")
        if launches["fused_render"] or launches["fused_mlp_bwd"]:
            raise AssertionError(f"{name}: B2 or B4 launched: {launches}")
        b1, b3, b5 = (launches[k] for k in ("fused_mlp_points", "fused_mlp", "composite"))
        if name == "guided" and (b1, b3, b5) != (0, 2 * per_frame, 2 * per_frame):
            raise AssertionError(f"guided: expected {2 * per_frame} B3 and B5: {launches}")
        if name == "gated" and not (b3 == 0 and b1 >= per_frame and b5 == b1):
            raise AssertionError(f"gated: expected B1 and B5 once per stage block: {launches}")
        if name.startswith("occ"):
            if build["fused_mlp_points"] != 128 or sum(build.values()) != 128:
                raise AssertionError(f"{name}: the 128^3 grid build launched {build}")
            if not (b1 == 0 and b3 > 0 and b5 == b3):
                raise AssertionError(f"{name}: expected B3 + B5 pairs: {launches}")

        # the same engine through the plain versions on the same grid. Rays
        # whose acc moved as a flip of the last sample's 1e10 interval moves
        # it (|d rgb| <= |d acc|, |d acc| > 1e-3) are set apart. The guided
        # path places all its fine samples by inverse CDF, whose 1e-5 floor
        # on a CDF step is a discontinuity: 1e-7 differences of the coarse
        # weights move samples by up to ~6e-2 on a 400x400 lego frame. There the
        # fine pass is held through the plain versions at the kernel run's
        # own depths, and the unpinned comparison is printed beside it
        c2w = np.asarray(pose, np.float32)
        rgb_k, acc_k, z_k, active = engine_maps(eng, True, c2w)
        rgb_p, acc_p, z_p, _ = engine_maps(eng, False, c2w)
        same = float(np.abs(rgb_k - frame).max())
        pinned = ""
        if z_k is not None:
            moved = np.abs(z_k - z_p).max(-1) > 1e-5
            pinned = (f" at the kernel run's depths (unpinned: max err "
                      f"{float(np.abs(rgb_k - rgb_p).max()):.2e}, {int(moved.sum())} rays "
                      f"with samples moved > 1e-5, by up to {np.abs(z_k - z_p).max():.1e})")
            rgb_p, acc_p = plain_fine_pass(eng, c2w, z_k)
        d_rgb, d_acc = np.abs(rgb_k - rgb_p).max(-1), np.abs(acc_k - acc_p)
        flip = (d_acc > 1e-3) & (d_rgb <= d_acc + 1e-5)
        err = float(d_rgb[~flip].max())
        if dense is None:
            dense = engine_maps(eng, True, c2w, guided=0)[0]
        occ = eng.occ_grid.occupied_fraction() if eng.occ_grid is not None else None
        log(f"{name}: engine {info['engine']}, {ms:.1f} ms per frame ({first_ms:.1f} ms the "
            f"first, second request's frame {again:.1e} from the first; engine build "
            f"{build_s:.1f} s, launches {build}); request launches B1 {b1}, B3 {b3}, "
            f"B5 {b5}; vs plain versions{pinned} max err {err:.2e} over "
            f"{int((~flip).sum())}/{flip.size} rays ({int(flip.sum())} sentinel flips "
            f"set apart; tol 1e-3); HTTP frame vs direct render {same:.1e}; "
            f"occupied {occ}; active rays {active}; PSNR vs dense {psnr(frame, dense):.2f} dB, vs held-out "
            f"view {view} {psnr(frame, gt):.2f} dB")
        if not (err <= 1e-3 and same <= 1e-6 and flip.sum() <= flip.size // 1000):
            bad.append(name)
        if profile:
            _profile(f"{name} frame", lambda: eng.render_poses(pose[None]))
        results[name] = {
            "engine": info["engine"], "frame_ms": ms, "first_frame_ms": first_ms,
            "build_s": build_s,
            "build_launches": build, "launches": launches, "max_err": err,
            "sentinel_flips": int(flip.sum()), "occupied_fraction": occ,
            "active_fraction": active,
            "psnr_vs_dense": psnr(frame, dense), "psnr_vs_gt": psnr(frame, gt)}
    results["dense_psnr_vs_gt"] = psnr(dense, gt)
    log(f"dense frame of the same checkpoint vs held-out view {view}: "
        f"{results['dense_psnr_vs_gt']:.2f} dB")
    if bad:
        raise AssertionError(f"the kernels' frame disagrees with the plain versions: {bad}")
    return results


def _profile(what, fn):
    """fn() under torch.profiler: device time by kernel and the device's
    busy share of the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"profile {what}: {wall_ms:.1f} ms wall, device busy {busy:.1f} ms "
        f"({100 * busy / wall_ms:.1f}%)")
    for name, ms in top:
        log(f"  {ms:9.2f} ms  {100 * ms / busy:5.1f}%  {name[:90]}")


def profile_frame(eng, pose):
    """One dense frame under torch.profiler."""
    import torch

    eng.render_poses(pose[None])
    torch.cuda.synchronize()
    _profile("dense frame", lambda: eng.render_poses(pose[None]))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        from nerf_shared_tpu_torch.ops.cuda import common
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    device = "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} ({smi})")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)

    t0 = time.perf_counter()
    common.build()
    log(f"phase 1: built {', '.join(common.KERNELS)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in common.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    t0 = time.perf_counter()
    cases = phase_kernels(device) + check_composite(device)
    log(f"phase 2: kernels vs plain versions in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    served = phase_serving(device)
    log(f"phase 3+4: serving in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_cases, step = phase_train_kernels(device)
    cases += train_cases
    log(f"phase 5: training kernels in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    trained = phase_training(device)
    log(f"phase 6: training in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fast = phase_fast_serving(device, trained["base_argv"],
                              profile="--profile" in sys.argv[1:])
    log(f"phase 7: fast serving in {time.perf_counter() - t0:.1f} s")
    if "--profile" in sys.argv[1:]:
        profile_frame(served["engine"], served["pose"])
        profile_train_step(device)
    by_path = dict(served["launches"])
    by_path["training"] = trained["launches"]
    by_path["render_only"] = trained["render_launches"]
    for name, *_ in FAST_ENGINES:  # the engine's build (the grid) and its request
        r = fast[name]
        by_path[name] = {k: r["build_launches"][k] + r["launches"][k] for k in r["launches"]}

    sources = {
        "fused_mlp_points": ("nerf_shared_tpu_torch/csrc/fused_mlp.cu",
                             "nerf_shared_tpu/ops/pallas/fused_mlp.py:253"),
        "fused_mlp_bwd": ("nerf_shared_tpu_torch/csrc/fused_mlp_bwd.cu",
                          "nerf_shared_tpu/ops/pallas/fused_mlp_bwd.py:176"),
        "fused_mlp": ("nerf_shared_tpu_torch/csrc/fused_mlp.cu",
                      "nerf_shared_tpu/ops/pallas/fused_mlp.py:280"),
        "fused_render": ("nerf_shared_tpu_torch/csrc/fused_render.cu",
                         "nerf_shared_tpu/ops/pallas/fused_render.py:80"),
        "composite": ("nerf_shared_tpu_torch/csrc/composite.cu",
                      "nerf_shared_tpu/ops/pallas/composite.py:37")}
    kernels = []
    for name, (src, replaces) in sources.items():
        mine = [c for c in cases if c["kernel"] == name]
        main_case = max(mine, key=lambda c: c["S"])
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(p.get(name, 0) for p in by_path.values()),
            "launches_by_path": {k: p.get(name, 0) for k, p in by_path.items()},
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
            "library_ms": None,
            "cases": mine,
        })
    log(json.dumps({"frame_ms": served["frame_ms"], "train_step": step, "fast": fast,
                    "training": {k: trained[k] for k in (
                        "ms_per_step", "rays_per_s", "train_psnr", "val", "white_psnr")}}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
