#!/usr/bin/env python3
"""Smoke run of the PyTorch port (nerf_shared_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--profile]

Phases (any failure exits non-zero and prints no result line):

1. build    nvcc builds every kernel (B1-B5, P1-P2) from csrc/, one process
            per source, in parallel, into build/nerf_shared_tpu_torch/;
            cuobjdump counts the tensor-core MMA instructions (HGMMA) of
            each kernel of B1's, B3's and B4's libraries: B1's
            nerf_points_tc_kernel, B3's nerf_rays_tc_kernel and B4's
            nerf_render_tc_kernel must have some.
2. kernels  at the lego width (8x256, skip at 4, viewdirs, multires 10/4)
            with seeded weights and rays at the main path's shapes (one ray
            block of --chunk 32768 rays): B3 at S=64 and S=192 and B4 at
            S=192 against their plain PyTorch versions (2e-4 of max(1,
            max|plain|), and B3's raw and B4's rgb, acc and weights also
            within 5e-6, fp32 accuracy, which one TF32 product alone does
            not reach), the other architectures at S = 1, 7, 65, B4 at
            S = 7 and 65 run 200 times each with every run bit-identical
            to the first (tiles there hold a ray's end and the next ray's
            start), one gradient through
            each autograd.Function, and times in turns with the plain
            versions (median and min-max of 10 samples) beside two bounds:
            the split-fp32 design's (3 TF32 products a multiply-add on the
            tensor cores) and the fp32 CUDA cores'. B5 (the composite) at
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
            phase 2 (the four architectures at 37 x 7 and 300 x 65 points),
            against their plain versions (B1 within 2e-4 and FP32_TOL of
            max(1, max|plain|), as B3); B1 timed in turns with the plain
            chain (median and min-max of 10 samples) beside both bounds,
            as B3, and its weight pack's time; B2's median times. Then one
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
            1e10 sentinel excepted, at most 1 in 1000; guided and the
            --occ_fine pass, whose inverse-CDF samples move with the
            coarse pass's rounding, held at the kernel run's own depths,
            and the occupancy engines also as they are over the rays whose
            samples did not move (at most 3/4 of the live rays moved) and
            by their coarse pass alone as it is), latency, occupied
            fraction and PSNR against the dense frame and the held-out view.
            The 128^3 grid build timed through B1 and through the plain
            version in turns; each engine's frame ms and the build's on one
            line.
8. gather   P1 (row gather) and P2 (row scatter-add) against their plain
            versions: at the probe's shape (3,145,728 rows of 16 from
            65,536), the split L8/F8 hashgrid's per-level shapes (196,608
            and 65,536 rows of 64 from 4,096 and 16,384), the vertex
            L16/F2/T2^19 layout's one gather at a lego step's 262,144 points
            (33,554,432 rows of 2 from 8,388,608), triplane G256/C16
            (262,144 rows of 16 from 196,608), on uniform indices; then on
            main-path indices, built from seeded lego rays by the port's own
            index math (hashgrid_indices, triplane_indices): split levels 0,
            3 and 7 of a fine pass (196,608 rows of 64), the vertex
            layout's fine-pass gather (25,165,824 rows of 2 from 2^23) and
            one triplane plane gather (262,144 rows of 16); and odd shapes
            (R prime, R = 0, T = 1, w in 1, 2, 3, 4, 8, 16, 32, 64, buffers
            unaligned for the vector paths, all indices equal). P1 exact,
            P2 within 1e-5 of the largest |entry| (exact on integer
            updates). TableGather forward and backward against plain
            autograd. Timed: each kernel in turns with its library call
            (index_select; zeros + index_add_), median and min-max of 10
            samples, beside its plain version and its bytes bound over the
            distinct rows touched. Then the ported probe's eight rows.
9. grid     the split L8/F8/T14 hashgrid (--hash_max_res 512) trained with
            configs/lego.txt on phase 6's scene, resumed, --render_only, and
            served over HTTP (two requests): exact P1 / P2 / B5 launches per
            step and per frame, none of B1-B4, Adam groups in the
            checkpoint, the held-out PSNR >= 2 dB above an all-white frame,
            the frame against the same engine through the plain versions
            within 1e-3 (the fine pass at the kernel run's own depths).
            Then the hashgrid at its defaults (vertex L16/F2/T2^19) for 30
            steps (exactly 2 P1 + 2 P2 a step), and the triplane at its
            defaults for 100 steps with one upsample milestone (128 -> 256)
            and one served frame. Step and frame ms of each.

``--parent-tree`` (with ``--phases``) marks the parent side of an A/B:
phase 1 logs a tensor-core kernel that tree predates instead of failing.
``--profile`` adds one dense frame, five training steps, one frame of
each fast engine, five split and five vertex hashgrid training steps and
a hashgrid and a triplane frame under torch.profiler (device time by
kernel, device busy share, P1's and P2's shares). ``--phases 2,3,4,7``
runs the build and the listed phases alone (phase 7 runs phase 6 for its
checkpoint; 3 and 4 run together; no result lines; for iterating on a
phase and for nerf_shared_tpu_torch/benchmarks/ab_smoke.sh). Before the last
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
# the CUDA cores, dense TF32 on the tensor cores (B1, B3 and B4 run split fp32,
# three TF32 products a multiply-add; the fp32 path uses no plain TF32) and
# HBM bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
# B1's, B3's and B4's fp32-accuracy gate, beside the 2e-4 tolerance, as a
# share of max(1, max|plain|): split fp32 reads ~3.6e-7 at the lego width
# on an H100; one TF32 product a multiply-add alone (plain TF32) misses it
# by several times in tests/test_torch_tc_mlp.py's emulation of the kernel
FP32_TOL = 5e-6
# B3's and B4's design, and B1's, named in the kernels line
TC_DESIGN = ("split fp32 (3xTF32) on wgmma.m64nNk8 tensor cores, 128-point tiles, "
             "bulk-copy weight ring with mbarriers (csrc/mlp_tile_tc.cuh)")
B1_DESIGN = (TC_DESIGN + "; point-major encoder (f·x); each 8-row slice summed on the "
             "tensor cores from zero and added in fp32 on the CUDA cores")


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


def queued_ms(fn, reps=20, rounds=3):
    """Device milliseconds per call of ``fn``: CUDA events around ``reps``
    calls queued behind a ~30 ms spin kernel, so the host's per-call cost
    stays off the clock while it enqueues ahead (a call that waits for the
    card, as the plain versions' range checks do, counts that wait);
    median of ``rounds``. The profiler recorded only part of long sessions
    of short launches on the H100 (times below the bytes bound, or none)."""
    import torch

    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(rounds):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        ts.append(start.elapsed_time(end) / reps)
    return statistics.median(ts)


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


def bound(cfg, params, n, S, products=1, peak=PEAK_FP32_FLOPS):
    """(bound_ms, bound_by) of the network on n rays x S samples: its FLOPs
    times ``products`` (TF32 products a multiply-add) over ``peak`` vs its
    bytes (rays, depths, weights in; raw out) over the memory rate."""
    from nerf_shared_tpu_torch.ops.cuda.fused_mlp import flops_per_point, network_bytes

    flops = flops_per_point(cfg) * n * S * products
    nbytes = 4 * (n * 9 + n * S + n * S * 4) + network_bytes(params, cfg)
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def mlp_bounds(cfg, params, n, S):
    """B3's and B4's two bounds: (design ms, by), (fp32 CUDA-core ms, by)."""
    return (bound(cfg, params, n, S, products=3, peak=PEAK_TF32_FLOPS),
            bound(cfg, params, n, S))


def points_bounds(cfg, params, n, S):
    """B1's two bounds on n rays x S points, as mlp_bounds: its bytes are
    the points and the rays' directions in, raw out, and the weights."""
    from nerf_shared_tpu_torch.ops.cuda.fused_mlp import flops_per_point, network_bytes

    nbytes = 4 * (n * 3 + n * S * 3 + n * S * 4) + network_bytes(params, cfg)
    out = []
    for products, peak in ((3, PEAK_TF32_FLOPS), (1, PEAK_FP32_FLOPS)):
        t_ops = flops_per_point(cfg) * n * S * products / peak
        t_bytes = nbytes / PEAK_BYTES
        out.append((1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"))
    return tuple(out)


def spread(t):
    return f"{t[0]:.4f} [{t[1]:.4f}-{t[2]:.4f}]"


def abs_err(got, want, tol, fp32=False):
    """(max |got - want|, whether it is within min(tol, FP32_TOL if
    ``fp32``) * max(1, max|want|))."""
    err = float((got - want).abs().max())
    return err, err <= min(tol, FP32_TOL if fp32 else tol) * max(1.0, float(want.abs().max()))


def render_errs(got, want, mask, tol):
    """abs_err of B4's outputs (rgb, disp, acc, weights, depth) over the
    rays ``mask`` marks: rgb, acc and weights also within FP32_TOL (disp
    and depth pass through a division and the depth scale)."""
    return [abs_err(g[mask], w[mask], tol, fp32=i in (0, 2, 3))
            for i, (g, w) in enumerate(zip(got, want))]


def rays_at(n, S, seed, device):
    """lego_rays with S samples a ray: the first S of 64 for S <= 64, else
    64 more depths 0.01 past the first S - 64 merged in."""
    import torch

    o, d, z, vd = lego_rays(n, 64, seed=seed, device=device)
    z = z[:, :S].contiguous() if S <= 64 else torch.sort(torch.cat(
        [z, z[:, :S - 64] + 0.01], -1), -1).values.contiguous()
    return o, d, z, vd


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
                o, d, z, vd = rays_at(37, S, seed=i, device=device)
                vd = vd if cfg.use_viewdirs else None
                raw_p = fused_mlp.plain_nerf_forward_rays(params, cfg, o, d, z, vd)
                e3, ok3 = abs_err(fused_mlp.fused_nerf_forward_rays(
                    params, cfg, o, d, z, vd), raw_p, tol, fp32=True)
                mask = raw_p[:, -1, 3].abs() >= 1e-2
                got = fused_render.fused_render_rays(params, cfg, o, d, z, vd)
                want = fused_render.plain_render_rays(params, cfg, o, d, z, vd)
                checked = render_errs(got, want, mask, tol)
                e4 = max(e for e, _ in checked)
                log(f"  {kw} S={S}: B3 max err {e3:.1e}, B4 max err {e4:.1e} "
                    f"over {int(mask.sum())}/37 masked rays (tol {tol:g}; B3 and B4's "
                    f"rgb, acc, weights {FP32_TOL:g})")
                if not (ok3 and all(ok for _, ok in checked)):
                    raise AssertionError(f"kernels disagree at {kw} S={S}")


def check_render_repeats(device, params, cfg, tol, n=32768, runs=200):
    """B4 at S = 7 and 65 on n rays, ``runs`` times each: its tiles there
    hold the end of one ray and the start of the next, whose transmittance
    carry passes between tiles through shared memory. Every run's outputs
    (weights too) must be bit-identical to the first run's, and the first
    within tolerance of the plain version."""
    import torch

    from nerf_shared_tpu_torch.ops.cuda import fused_mlp, fused_render

    with torch.no_grad():
        for S in (7, 65):
            o, d, z, vd = rays_at(n, S, seed=S, device=device)
            first = fused_render.fused_render_rays(params, cfg, o, d, z, vd,
                                                   white_bkgd=True, want_weights=True)
            want = fused_render.plain_render_rays(params, cfg, o, d, z, vd,
                                                  white_bkgd=True)
            raw = fused_mlp.plain_nerf_forward_rays(params, cfg, o, d, z, vd)
            mask = raw[:, -1, 3].abs() >= 1e-2
            checked = render_errs(first, want, mask, tol)
            differ = 0
            for _ in range(runs - 1):
                got = fused_render.fused_render_rays(params, cfg, o, d, z, vd,
                                                     white_bkgd=True, want_weights=True)
                differ += int(any(not torch.equal(g, f) for g, f in zip(got, first)))
            log(f"  B4 {n} rays S={S}: {runs} runs, {differ} not bit-identical to the "
                f"first; max err {max(e for e, _ in checked):.1e} over "
                f"{int(mask.sum())}/{n} masked rays")
            if differ or not all(ok for _, ok in checked):
                raise AssertionError(f"B4 at S={S}: {differ} of {runs} runs differ from "
                                     "the first, or the first disagrees with plain")


def mlp_case(kernel, label, cfg, params, n, S, err, tol, t, tp):
    """Log and record a B3 / B4 timing: t and tp are the kernel's and the
    plain version's (median, min, max) ms in turns."""
    (bms, by), (fms, fby) = mlp_bounds(cfg, params, n, S)
    verdict = ("beats" if t[2] < tp[1] else "loses to" if t[1] > tp[2] else "ties")
    log(f"{label}: max err {err:.3e} (tol {tol:g}, scaled by max(1, max|plain|)), "
        f"{spread(t)} ms vs plain {spread(tp)} ms ({verdict} it; median [min-max] of "
        f"10 samples in turns); bound {bms:.2f} ms split fp32 on the tensor cores "
        f"({by}), {fms:.2f} ms fp32 on the CUDA cores ({fby}); "
        f"{100 * bms / t[0]:.1f}% of the design's bound")
    return dict(kernel=kernel, S=S, n_rays=n, max_abs_err=err, ms=t[0], ms_min=t[1],
                ms_max=t[2], plain_ms=tp[0], plain_min=tp[1], plain_max=tp[2],
                bound_ms=bms, bound_by=by, bound_fp32_cuda_cores_ms=fms,
                vs_plain=verdict, design=TC_DESIGN)


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
            err, ok = abs_err(got, want, tol, fp32=True)
            if not ok:
                raise AssertionError(f"B3 S={S} disagrees with its plain version "
                                     f"(max err {err:.3e}; tol {tol:g}, fp32 {FP32_TOL:g})")
            t, tp = in_turns(lambda: fused_mlp.fused_nerf_forward_rays(
                params, cfg, o, d, z, vd), lambda: fused_mlp.plain_nerf_forward_rays(
                params, cfg, o, d, z, vd), reps=3)
            cases.append(mlp_case("fused_mlp", f"B3 fused_mlp S={S}", cfg, params, n, S,
                                  err, tol, t, tp))

        S = 192
        o, d, z, vd = lego_rays(n, S, seed=7, device=device)
        got = fused_render.fused_render_rays(params, cfg, o, d, z, vd,
                                             white_bkgd=True, want_weights=True)
        want = fused_render.plain_render_rays(params, cfg, o, d, z, vd,
                                              white_bkgd=True)
        raw = fused_mlp.plain_nerf_forward_rays(params, cfg, o, d, z, vd)
        mask = raw[:, -1, 3].abs() >= 1e-2  # clear of the 1e10 sentinel flip
        checked = render_errs(got, want, mask, tol)
        errs = [e for e, _ in checked]
        err = max(errs)
        log(f"B4 fused_render S={S}: {int(mask.sum())}/{n} masked rays (rgb, disp, "
            f"acc, weights, depth: {', '.join(f'{e:.1e}' for e in errs)}; tol {tol:g}, "
            f"rgb, acc, weights {FP32_TOL:g})")
        if not (all(ok for _, ok in checked) and int(mask.sum()) >= n // 20):
            raise AssertionError("B4 disagrees with its plain version")
        t, tp = in_turns(lambda: fused_render.fused_render_rays(
            params, cfg, o, d, z, vd, white_bkgd=True, want_weights=False),
            lambda: fused_render.plain_render_rays(
                params, cfg, o, d, z, vd, white_bkgd=True), reps=3)
        cases.append(mlp_case("fused_render", f"B4 fused_render S={S}", cfg, params, n,
                              S, err, tol, t, tp))

    check_other_shapes(device, tol)
    check_render_repeats(device, params, cfg, tol)

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
    """B1 and B2 against their plain versions on one input, B1 also within
    FP32_TOL; returns (B1 max abs err, B2 max abs err, B2 errors by tensor
    relative to max |grad|)."""
    import torch

    from nerf_shared_tpu_torch.models.nerf import apply_nerf
    from nerf_shared_tpu_torch.ops.cuda import fused_mlp, fused_mlp_bwd

    with torch.no_grad():
        e1, ok1 = abs_err(fused_mlp.fused_nerf_forward(params, cfg, pts, vd),
                          apply_nerf(params, cfg, pts, vd), tol_fwd, fp32=True)
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
    log(f"  {label}: B1 max err {e1:.1e} (tol {tol_fwd:g}, fp32 {FP32_TOL:g}, "
        f"x max(1, max|plain|)); "
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
    # B1: as B3 (fp32 sums over <= 283 terms in another order than cuBLAS;
    # split fp32 on the tensor cores, so also FP32_TOL).
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
            t1, tp1 = in_turns(lambda: fused_mlp.fused_nerf_forward(params, cfg, pts, vd),
                               lambda: apply_nerf(params, cfg, pts, vd), reps=10)
            pack_ms = time_ms(lambda: fused_mlp.pack_network_tc(params, cfg, pts.device), 5)
        ms2 = time_ms(lambda: fused_mlp_bwd.fused_mlp_backward(params, cfg, pts, vd, g), 5)
        plain2 = time_ms(lambda: fused_mlp_bwd.plain_mlp_backward(params, cfg, pts, vd, g), 5)
        (b1, by1), (f1, fby1) = points_bounds(cfg, params, n_rays, S)
        b2, by2 = bwd_bound(cfg, params, n_rays * S)
        verdict = "beats" if t1[2] < tp1[1] else "loses to" if t1[1] > tp1[2] else "ties"
        log(f"B1 fused_mlp points N={n_rays * S}: {spread(t1)} ms vs plain {spread(tp1)} ms "
            f"({verdict} it; median [min-max] of 10 samples in turns); bound "
            f"{b1:.2f} ms split fp32 on the tensor cores ({by1}), {f1:.2f} ms fp32 on "
            f"the CUDA cores ({fby1}); {100 * b1 / t1[0]:.1f}% of the design's bound; "
            f"its weight pack (pack_network_tc) {pack_ms:.3f} ms a call")
        log(f"B2 fused_mlp_bwd N={n_rays * S}: {ms2:.2f} ms, plain {plain2:.2f} ms, "
            f"bound {b2:.2f} ms ({by2})")
        cases.append(dict(kernel="fused_mlp_points", S=S, n_points=n_rays * S,
                          max_abs_err=e1, ms=t1[0], ms_min=t1[1], ms_max=t1[2],
                          plain_ms=tp1[0], plain_min=tp1[1], plain_max=tp1[2],
                          bound_ms=b1, bound_by=by1, bound_fp32_cuda_cores_ms=f1,
                          vs_plain=verdict, pack_ms=pack_ms, design=B1_DESIGN))
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


def profile_grid_step(device, steps=5, vertex=False):
    """``steps`` consecutive hashgrid training steps (the phase-9 split
    recipe, or with ``vertex`` the family's defaults: vertex L16/F2/T2^19;
    on train_step_setup's two seeded 400x400 images and pinned draws) under
    torch.profiler, after one warm-up step."""
    import torch

    from nerf_shared_tpu_torch.models.hashgrid import HashGridConfig
    from nerf_shared_tpu_torch.render.renderer import RenderConfig
    from nerf_shared_tpu_torch.train.pipeline import PixelSamplerSpec
    from nerf_shared_tpu_torch.train.state import create_train_state
    from nerf_shared_tpu_torch.train.step import make_train_step

    _, _, images, poses, ov = train_step_setup(device, False)
    box = dict(aabb_min=(-4.72,) * 3, aabb_max=(4.72,) * 3)
    cfg = (HashGridConfig(**box) if vertex else
           HashGridConfig(L=8, F=8, log2_T=14, max_res=512, layout="split", **box))
    state = create_train_state(cfg, cfg, device, seed=3, lrate=5e-4, lrate_decay=500)
    H = 400
    focal = 0.5 * H / math.tan(0.5 * 0.6911112)
    spec = PixelSamplerSpec.from_K(H, H, [[focal, 0, H / 2], [0, focal, H / 2], [0, 0, 1]],
                                   1024, single_image=True, precrop_iters=500,
                                   precrop_frac=0.5)
    rcfg = RenderConfig(perturb=1.0, N_importance=128, N_samples=64, use_viewdirs=True,
                        white_bkgd=True, near=2.0, far=6.0)
    step = make_train_step(rcfg, cfg, cfg, spec)
    step(state, images, poses, torch.Generator().manual_seed(9), overrides=ov)
    torch.cuda.synchronize()

    def run():
        for i in range(steps):
            step(state, images, poses, torch.Generator().manual_seed(i), overrides=ov)

    _profile(f"{steps} hashgrid training steps ({cfg.layout} L{cfg.L}/F{cfg.F}/"
             f"T2^{cfg.log2_T})", run)


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
    from nerf_shared_tpu_torch.ops.cuda import (
        composite, fused_mlp, fused_mlp_bwd, fused_render, gather)

    return {"fused_mlp_points": fused_mlp.POINT_LAUNCHES, "fused_mlp": fused_mlp.LAUNCHES,
            "fused_render": fused_render.LAUNCHES, "fused_mlp_bwd": fused_mlp_bwd.LAUNCHES,
            "composite": composite.LAUNCHES, "gather": gather.LAUNCHES["gather"],
            "scatter_add": gather.LAUNCHES["scatter_add"]}


def zero_counts():
    from nerf_shared_tpu_torch.ops.cuda import (
        composite, fused_mlp, fused_mlp_bwd, fused_render, gather)

    fused_mlp.POINT_LAUNCHES = fused_mlp.LAUNCHES = fused_render.LAUNCHES = 0
    fused_mlp_bwd.LAUNCHES = composite.LAUNCHES = 0
    gather.LAUNCHES.update(gather=0, scatter_add=0)


def engine_maps(eng, kernels, c2w, guided=None, occ_fine=None):
    """(rgb [H,W,3], acc [H,W], z, live, active) of one pose through
    ``eng``'s path, as render_from_batch_poses dispatches it, with the
    kernels or through the plain versions (``kernels`` False); ``guided``
    and ``occ_fine`` override the config's. z is the fine pass's sample
    depths [H,W,S] on the dense (guided) path and the occupancy engines'
    --occ_fine pass, else None; live [H,W] marks the rays that keep an
    occupied sample (occupancy), else None; active is the share of rays
    that reach the fine pass (gated) or keep an occupied sample
    (occupancy), else None."""
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
                n_fine=o["occ_fine"] if occ_fine is None else occ_fine)
            rgb, acc, live = out["rgb_map"], out["acc_map"], out["n_active"] > 0
            z = out["z_vals"].cpu().numpy() if "z_vals" in out else None
            active = float(live.float().mean())
            live = live.cpu().numpy()
        elif a.render_gate > 0.0:
            _, out = r.render_image_gated(eng.H, eng.W, eng.K, c2w, eng.coarse,
                                          eng.fine, chunk=a.chunk,
                                          threshold=a.render_gate)
            rgb, acc, z, live = out["rgb_map"], out["acc_map"], None, None
            active = out["active_fraction"]
        else:
            rgb, _, acc, extras = r.render(eng.H, eng.W, eng.K, eng.coarse, eng.fine,
                                           chunk=a.chunk, c2w=c2w, retraw=False,
                                           retweights=True)
            z, live, active = extras["z_vals"].cpu().numpy(), None, None
    return rgb.float().cpu().numpy(), acc.float().cpu().numpy(), z, live, active


@contextlib.contextmanager
def plain_gathers():
    """The grid families' table reads through plain indexing instead of P1
    (for holding a grid frame against its plain version; forward only)."""
    from nerf_shared_tpu_torch.models import hashgrid, triplane

    def plain(table, idx):
        return table[idx.reshape(-1).long()].reshape(*idx.shape, table.shape[1])

    saved = hashgrid.table_gather, triplane.table_gather
    hashgrid.table_gather = triplane.table_gather = plain
    try:
        yield
    finally:
        hashgrid.table_gather, triplane.table_gather = saved


def plain_fine_pass(eng, c2w, z, live=None):
    """(rgb [H,W,3], acc [H,W]) of ``eng``'s fine network at the depths z
    [H,W,S] through the plain versions (network and raw2outputs); with
    ``live`` [H,W], the other rays' densities masked as the occupancy
    engines mask rays that keep no occupied sample."""
    import torch

    from nerf_shared_tpu_torch.models.nerf import NeRFConfig
    from nerf_shared_tpu_torch.ops.compositing import raw2outputs
    from nerf_shared_tpu_torch.ops.cuda.fused_mlp import plain_nerf_forward_rays
    from nerf_shared_tpu_torch.render.occupancy import _masked_sigma
    from nerf_shared_tpu_torch.render.renderer import _apply_model

    def grid_forward(params, cfg, ro, rd, zz, vd):
        pts = ro[:, None, :] + rd[:, None, :] * zz[..., None]
        with plain_gathers():
            return _apply_model(params, cfg, pts, vd, eng.renderer.cfg)

    forward = (plain_nerf_forward_rays if isinstance(eng.fine.cfg, NeRFConfig)
               else grid_forward)

    dev = eng.device
    rays, _ = eng.renderer._pack_rays(eng.H, eng.W, eng.K, None,
                                      torch.as_tensor(c2w, device=dev), dev)
    z = torch.as_tensor(z, device=dev).reshape(rays.shape[0], -1)
    if live is not None:
        live = torch.as_tensor(live, device=dev).reshape(-1, 1)
    params, cfg = eng.fine.params(), eng.fine.cfg
    rgb, acc = [], []
    with torch.no_grad():
        for i in range(0, rays.shape[0], eng.args.chunk):
            rb, zz = rays[i:i + eng.args.chunk], z[i:i + eng.args.chunk].contiguous()
            ro, rd, vd = (rb[:, 0:3].contiguous(), rb[:, 3:6].contiguous(),
                          rb[:, -3:].contiguous())
            raw = forward(params, cfg, ro, rd, zz, vd)
            if live is not None:
                raw = _masked_sigma(raw, live[i:i + eng.args.chunk].expand_as(zz))
            out = raw2outputs(raw, zz, rd, white_bkgd=eng.renderer.cfg.white_bkgd)
            rgb.append(out[0])
            acc.append(out[2])
    return (torch.cat(rgb).reshape(eng.H, eng.W, 3).cpu().numpy(),
            torch.cat(acc).reshape(eng.H, eng.W).cpu().numpy())


def psnr(a, b):
    import numpy as np

    mse = float(np.mean((np.asarray(a, np.float64) - b) ** 2))
    return -10.0 * math.log10(mse) if mse > 0 else float("inf")


def held(rgb_a, acc_a, rgb_b, acc_b, rays=None):
    """(max rgb error, rays held, sentinel flips) of frame a against frame b
    over the rays ``rays`` marks ([H,W]; all when None). Rays whose acc
    moved as a flip of the last sample's 1e10 interval moves it
    (|d rgb| <= |d acc|, |d acc| > 1e-3) are set apart and counted."""
    import numpy as np

    d_rgb, d_acc = np.abs(rgb_a - rgb_b).max(-1), np.abs(acc_a - acc_b)
    rays = np.ones(d_rgb.shape, bool) if rays is None else rays
    flip = rays & (d_acc > 1e-3) & (d_rgb <= d_acc + 1e-5)
    keep = rays & ~flip
    return float(d_rgb[keep].max(initial=0.0)), int(keep.sum()), int(flip.sum())


def frame_checks(eng, c2w, kern):
    """The checks of one phase 7 frame: ``kern`` is engine_maps' tuple
    with the kernels. Returns ({label: held(...)}, moved, live, note); the
    first check is the frame's main one.

    The gated engine places no sample from the network's output: its frame
    is held against the plain versions' as it is. The guided path and the
    occupancy engines' --occ_fine pass place fine samples by inverse CDF,
    whose 1e-5 floor on a CDF step is a discontinuity (1e-7 differences of
    the coarse weights move samples by up to ~6e-2 on a 400x400 lego
    frame). Their frame is held through the plain versions at the kernel
    run's own depths (every ray). The occupancy engines' frame is also held
    against the plain run as it is over the rays whose samples did not move
    by more than 1e-5, with the rays that moved at most three quarters of
    the live rays, and their coarse pass alone (--occ_fine 0), whose
    samples come from the grid and never move, as it is. (Guided's 48 fine
    samples crowd where the coarse weights peak, so there a 1e-5 shift can
    be a large share of a sample interval: the unmoved rays read 1.01e-3 on
    an H100; only the moved share is printed.)"""
    import numpy as np

    rgb_k, acc_k, z_k, live_k, _ = kern
    rgb_p, acc_p, z_p, _, _ = engine_maps(eng, False, c2w)
    if z_k is None:
        return {"frame": held(rgb_k, acc_k, rgb_p, acc_p)}, None, None, ""
    checks = {"at the kernel run's depths": held(
        rgb_k, acc_k, *plain_fine_pass(eng, c2w, z_k, live_k))}
    shift = np.abs(z_k - z_p).max(-1)
    still = shift <= 1e-5
    n_moved = int((~still).sum())
    live = still.size if live_k is None else int(live_k.sum())
    moved = None
    if eng.occ_grid is not None:
        moved = n_moved
        checks["as it is, unmoved rays"] = held(rgb_k, acc_k, rgb_p, acc_p, still)
        coarse = [engine_maps(eng, k, c2w, occ_fine=0) for k in (True, False)]
        checks["coarse pass alone"] = held(coarse[0][0], coarse[0][1],
                                           coarse[1][0], coarse[1][1])
    note = (f" ({n_moved} of {live} live rays with samples moved > 1e-5, by up to "
            f"{shift.max():.1e}{'; at most 3/4 allowed' if moved is not None else ''}; "
            f"over all rays as it is {float(np.abs(rgb_k - rgb_p).max()):.2e})")
    return checks, moved, live, note


def time_grid_build(eng):
    """ms of the occupancy engines' 128^3 grid build (probes through B1 and
    through the plain apply_nerf), in turns kernel, plain, plain, kernel,
    host clock to a synchronize: ((median, min, max) kernels, the same
    plain, B1 launches a kernel build, share of cells the two builds
    mark differently)."""
    import dataclasses

    import torch

    from nerf_shared_tpu_torch.apps.train import resolved_occ_alpha_thresh
    from nerf_shared_tpu_torch.ops.cuda import fused_mlp
    from nerf_shared_tpu_torch.render.occupancy import build_occupancy_grid

    grid0 = eng.occ_grid
    params = eng.fine.params()

    def build(kernels):
        rcfg = dataclasses.replace(eng.renderer.cfg, use_pallas=kernels)
        gen = torch.Generator(device=grid0.grid.device).manual_seed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            grid = build_occupancy_grid(
                params, eng.fine.cfg, rcfg, grid0.aabb_min.cpu().numpy(),
                grid0.aabb_max.cpu().numpy(), resolution=grid0.resolution,
                alpha_threshold=resolved_occ_alpha_thresh(eng.args), generator=gen)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, grid.grid

    times = {True: [], False: []}
    before = fused_mlp.POINT_LAUNCHES
    grids = {}
    for kernels in (True, False, False, True):
        ms, grids[kernels] = build(kernels)
        times[kernels].append(ms)
    launches = (fused_mlp.POINT_LAUNCHES - before) // 2
    differ = float((grids[True] != grids[False]).float().mean())
    return (tuple((statistics.median(t), min(t), max(t)) for t in (times[True], times[False]))
            + (launches, differ))


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

        # the same engine through the plain versions on the same grid (see
        # frame_checks)
        c2w = np.asarray(pose, np.float32)
        kern = engine_maps(eng, True, c2w)
        rgb_k, active = kern[0], kern[4]
        checks, moved, n_live, depth_note = frame_checks(eng, c2w, kern)
        same = float(np.abs(rgb_k - frame).max())
        err, _, flips = next(iter(checks.values()))
        if dense is None:
            dense = engine_maps(eng, True, c2w, guided=0)[0]
        occ = eng.occ_grid.occupied_fraction() if eng.occ_grid is not None else None
        size = rgb_k.shape[0] * rgb_k.shape[1]
        log(f"{name}: engine {info['engine']}, {ms:.1f} ms per frame ({first_ms:.1f} ms the "
            f"first, second request's frame {again:.1e} from the first; engine build "
            f"{build_s:.1f} s, launches {build}); request launches B1 {b1}, B3 {b3}, "
            f"B5 {b5}; vs plain versions (tol 1e-3, sentinel flips set apart): "
            + "; ".join(f"{label} max err {e:.2e} over {n}/{size} rays ({f} flips)"
                        for label, (e, n, f) in checks.items())
            + f"{depth_note}; HTTP frame vs direct render {same:.1e}; "
            f"occupied {occ}; active rays {active}; PSNR vs dense {psnr(frame, dense):.2f} dB, "
            f"vs held-out view {view} {psnr(frame, gt):.2f} dB")
        if not (all(e <= 1e-3 and f <= size // 1000 for e, _, f in checks.values())
                and same <= 1e-6 and (moved is None or 4 * moved <= 3 * n_live)):
            bad.append(name)
        if profile:
            _profile(f"{name} frame", lambda: eng.render_poses(pose[None]))
        if name == "occ_froxel":
            tk, tp, n_b1, differ = time_grid_build(eng)
            log(f"grid build {eng.occ_grid.resolution}^3: {spread(tk)} ms through B1 "
                f"({n_b1} launches) vs {spread(tp)} ms through the plain version "
                f"(median [min-max] of 2 builds in turns); {differ:.2e} of the cells "
                "marked differently by the two builds")
            results["grid_build"] = {"ms": tk[0], "ms_min": tk[1], "ms_max": tk[2],
                                     "plain_ms": tp[0], "plain_min": tp[1],
                                     "plain_max": tp[2], "launches": n_b1,
                                     "cells_differ": differ}
        results[name] = {
            "engine": info["engine"], "frame_ms": ms, "first_frame_ms": first_ms,
            "build_s": build_s,
            "build_launches": build, "launches": launches, "max_err": err,
            "sentinel_flips": flips, "checks": {k: v[0] for k, v in checks.items()},
            "moved_rays": moved, "live_rays": n_live, "occupied_fraction": occ,
            "active_fraction": active,
            "psnr_vs_dense": psnr(frame, dense), "psnr_vs_gt": psnr(frame, gt)}
    results["dense_psnr_vs_gt"] = psnr(dense, gt)
    log(f"dense frame of the same checkpoint vs held-out view {view}: "
        f"{results['dense_psnr_vs_gt']:.2f} dB")
    log("phase 7 times: " + ", ".join(f"{name} frame {results[name]['frame_ms']:.1f} ms"
                                      for name, *_ in FAST_ENGINES)
        + f"; 128^3 grid build {results['grid_build']['ms']:.1f} ms")
    if bad:
        raise AssertionError(f"the kernels' frame disagrees with the plain versions: {bad}")
    return results


def gather_inputs(R, T, w, seed, device, same=False, idx=None, offset=0):
    """Seeded table [T, w], int32 indices [R] and updates [R, w] on the
    card. ``same``: every index T // 2 and integer updates in [-8, 8], whose
    fp32 sums (|sum| <= 8 R < 2^24) are exact in any order. ``idx``: these
    indices (int32 on the card) in place of uniform draws, with the table
    and updates drawn on the card. ``offset``: table and updates start
    ``offset`` floats into their buffers (unaligned for the vector paths)."""
    import torch

    if idx is not None:
        gd = torch.Generator(device=device).manual_seed(seed)
        return (torch.randn(T, w, generator=gd, device=device), idx,
                torch.randn(R, w, generator=gd, device=device))
    g = torch.Generator().manual_seed(seed)
    table = torch.randn(T, w, generator=g)
    if same:
        idx = torch.full((R,), T // 2, dtype=torch.int32)
        upd = torch.randint(-8, 9, (R, w), generator=g).float()
    else:
        idx = torch.randint(0, T, (R,), generator=g, dtype=torch.int32)
        upd = torch.randn(R, w, generator=g)

    def place(t):
        buf = torch.zeros(t.numel() + offset, device=device)
        buf[offset:] = t.reshape(-1).to(device)
        return buf[offset:].view(t.shape)

    return place(table), idx.to(device), place(upd)


def check_gather(label, R, T, w, seed, device, same=False, idx=None, offset=0):
    """P1 and P2 against their plain versions on one input: P1 exactly, P2
    within 1e-5 of the largest |entry| (fp32 atomics add in another order),
    exactly with ``same`` (integer updates). Returns (inputs, P1 max err,
    P2 max err over the largest |entry|)."""
    import torch

    from nerf_shared_tpu_torch.ops.cuda import gather

    table, idx, upd = gather_inputs(R, T, w, seed, device, same, idx, offset)
    with torch.no_grad():
        got, want = gather.gather_rows(table, idx), gather.plain_gather_rows(table, idx)
        s_got = gather.scatter_add_rows(idx, upd, T)
        s_want = gather.plain_scatter_add_rows(idx, upd, T)
    torch.cuda.synchronize()
    e1 = float((got - want).abs().max()) if R else 0.0
    scale = max(1.0, float(s_want.abs().max()))
    e2 = float((s_got - s_want).abs().max()) / scale
    tol = 0.0 if same else 1e-5
    log(f"  {label} R={R} T={T} w={w}{f' offset {offset}' if offset else ''}: P1 max err "
        f"{e1:.1e} (exact), P2 max err {e2:.1e} of max|out| {scale:.3g} (tol {tol:g})")
    if got.shape != (R, w) or s_got.shape != (T, w) or e1 != 0.0 or not e2 <= tol:
        raise AssertionError(f"P1 / P2 disagree with their plain versions at {label}")
    return (table, idx, upd), e1, e2


def in_turns(a, b, rounds=5, reps=20):
    """Device ms per call of ``a`` and ``b`` (queued_ms, ``reps`` calls a
    sample) timed in turns a, b, b, a over ``rounds`` rounds: (median, min,
    max) of each one's 2 x rounds samples."""
    sa, sb = [], []
    for _ in range(rounds):
        for fn, out in ((a, sa), (b, sb), (b, sb), (a, sa)):
            out.append(queued_ms(fn, reps=reps, rounds=1))
    return tuple((statistics.median(s), min(s), max(s)) for s in (sa, sb))


def main_path_indices(device):
    """The indices the grid families' encode builds for one training step
    of seeded lego rays (1024 rays), through the port's own index math:
    [(label, idx int32 [R] on the card, T, w)]. Split L8/F8/T2^14 levels 0,
    3, 7 and the vertex L16/F2/T2^19 fused gather on the fine pass (64 +
    128 samples a ray); one triplane G256/C16 plane gather (plane xy,
    corner 00) on 64 + 192 samples a ray."""
    from nerf_shared_tpu_torch.models.hashgrid import HashGridConfig, hashgrid_indices
    from nerf_shared_tpu_torch.models.triplane import TriplaneConfig, triplane_indices

    box = dict(aabb_min=(-4.72,) * 3, aabb_max=(4.72,) * 3)

    def points(S, seed):
        o, d, z, _ = lego_rays(1024, S, seed, device)
        return o[:, None, :] + d[:, None, :] * z[..., None]

    fine = points(192, 20)
    split = HashGridConfig(L=8, F=8, log2_T=14, max_res=512, layout="split", **box)
    levels = hashgrid_indices(split, fine)
    cases = [(f"split L8/F8 level {lv}, fine pass, main-path indices", levels[lv],
              split.level_table_rows[lv], split.row_width) for lv in (0, 3, 7)]
    vertex = HashGridConfig(**box)
    cases.append(("vertex L16/F2/T2^19, fine pass, main-path indices",
                  hashgrid_indices(vertex, fine).reshape(-1), vertex.L * vertex.T, vertex.F))
    tri = TriplaneConfig(**box)
    cases.append(("triplane G256/C16, plane xy corner 00, main-path indices",
                  triplane_indices(tri, points(256, 21))[0, 0].reshape(-1).contiguous(),
                  3 * tri.G * tri.G, tri.C))
    return cases


def time_gather(label, inputs, T, w, errs, main=False):
    """P1 and P2 on one input, each in turns with its library call
    (index_select; zeros + index_add_), plus the plain versions' time and
    the bytes bounds. Returns the two kernels' case records."""
    import torch

    from nerf_shared_tpu_torch.ops.cuda import gather

    table, idx, upd = inputs
    R, device = idx.shape[0], table.device
    with torch.no_grad():
        p1, lib1 = in_turns(lambda: gather.gather_rows(table, idx),
                            lambda: torch.index_select(table, 0, idx))
        p2, lib2 = in_turns(lambda: gather.scatter_add_rows(idx, upd, T),
                            lambda: torch.zeros((T, w), device=device).index_add_(0, idx, upd))
        plain = (queued_ms(lambda: gather.plain_gather_rows(table, idx)),
                 queued_ms(lambda: gather.plain_scatter_add_rows(idx, upd, T)))
    # bytes bounds: P1 reads the distinct rows its indices name, P2 writes
    # the whole [T, w] output
    distinct = int(torch.unique(idx).numel())
    bms = {"p1": 1e3 * gather.bytes_moved(R, distinct, w) / PEAK_BYTES,
           "p2": 1e3 * gather.bytes_moved(R, T, w) / PEAK_BYTES}

    def verdict(k, lib):
        return ("beats" if k[2] < lib[1] else "loses to" if k[1] > lib[2] else "ties")

    log(f"P1 / P2 {label} (R={R} T={T} w={w}, {distinct} distinct rows): "
        f"P1 {spread(p1)} ms vs index_select {spread(lib1)} ({verdict(p1, lib1)} it), "
        f"bound {bms['p1']:.4f}, plain {plain[0]:.4f}; P2 {spread(p2)} ms vs zeros + "
        f"index_add_ {spread(lib2)} ({verdict(p2, lib2)} it), bound {bms['p2']:.4f}, "
        f"plain {plain[1]:.4f}; median [min-max] ms of 10 samples in turns")
    cases = []
    for k, t, lib, pl, e, b in (("gather", p1, lib1, plain[0], errs[0], bms["p1"]),
                                ("scatter_add", p2, lib2, plain[1], errs[1], bms["p2"])):
        cases.append(dict(
            kernel=k, shape=label, R=R, T=T, w=w, distinct_rows=distinct, main=main,
            max_abs_err=e, ms=t[0], ms_min=t[1], ms_max=t[2], plain_ms=pl,
            library_ms=lib[0], library_min=lib[1], library_max=lib[2], bound_ms=b,
            bound_by="bytes", vs_library=verdict(t, lib)))
    return cases


def phase_gather(device):
    """Phase 8: P1 and P2 at the probe's and the grid paths' shapes on
    uniform and main-path indices and at odd shapes, the autograd pair,
    times in turns with the library calls, and the ported probe."""
    import torch

    from nerf_shared_tpu_torch.benchmarks import scatter_probe
    from nerf_shared_tpu_torch.models.hashgrid import HashGridConfig
    from nerf_shared_tpu_torch.ops.cuda import gather

    split = HashGridConfig(L=8, F=8, log2_T=14, max_res=512, layout="split")
    shapes = [("probe", 3_145_728, 65_536, 16)]
    for R, what in ((196_608, "fine"), (65_536, "coarse")):
        for rows in sorted(set(split.level_table_rows)):
            shapes.append((f"split L8/F8 level table ({what} pass)", R, rows,
                           split.row_width))
    shapes += [("vertex L16/F2/T2^19, one gather of a step's 262,144 points",
                262_144 * 16 * 8, 16 << 19, 2),
               ("triplane G256/C16, one of 12 gathers", 262_144, 3 * 256 * 256, 16)]
    timed = {"probe", "split L8/F8 level table (fine pass)",
             "triplane G256/C16, one of 12 gathers",
             "vertex L16/F2/T2^19, one gather of a step's 262,144 points"}
    cases = []
    for i, (label, R, T, w) in enumerate(shapes):
        inputs, e1, e2 = check_gather(label, R, T, w, 40 + i, device)
        if label in timed:
            cases += time_gather(f"{label}, uniform indices", inputs, T, w, (e1, e2))
        del inputs
    # the indices the grid families build on seeded lego rays
    for i, (label, idx, T, w) in enumerate(main_path_indices(device)):
        inputs, e1, e2 = check_gather(label, idx.shape[0], T, w, 50 + i, device, idx=idx)
        cases += time_gather(label, inputs, T, w, (e1, e2), main=label.startswith(
            "split L8/F8 level 3"))
        del inputs, idx
    # odd shapes: R prime, R = 0, T = 1, every width the kernels take, all
    # indices equal, and buffers unaligned for the vector paths
    for i, w in enumerate((1, 2, 3, 4, 8, 16, 32, 64)):
        check_gather("odd", 1237, 977, w, 60 + i, device)
    check_gather("odd", 1_000_003, 4099, 3, 70, device)
    check_gather("empty", 0, 5, 16, 71, device)
    check_gather("empty", 0, 5, 3, 72, device)
    check_gather("one row", 1000, 1, 16, 73, device)
    for i, w in enumerate((2, 4, 16, 64)):
        check_gather("unaligned", 100_003, 4099, w, 76 + i, device, offset=1)
    # every row onto one (the worst contention). Sums of n N(0, 1) rows in
    # two orders differ by ~eps sqrt(n) of the result (2.1e-5 at n =
    # 262,144 on the H100, over the 1e-5 bar), so these take integer
    # updates, whose sums are exact in any order: P2 must match exactly
    check_gather("all indices equal", 262_144, 4096, 64, 74, device, same=True)
    check_gather("all indices equal", 262_144, 4096, 2, 75, device, same=True)
    check_gather("all indices equal", 262_144, 4096, 16, 83, device, same=True)
    check_gather("all indices equal", 262_144, 4096, 1, 84, device, same=True)
    check_gather("all indices equal", 262_144, 4096, 3, 85, device, same=True)

    # the autograd pair against plain autograd
    table, idx, upd = gather_inputs(196_608, 16_384, 64, 80, device)
    t1, t2 = table.clone().requires_grad_(True), table.clone().requires_grad_(True)
    rows = gather.table_gather(t1, idx)
    (rows * upd).sum().backward()
    want = t2[idx.long()]
    (want * upd).sum().backward()
    e_rows = float((rows - want).detach().abs().max())
    e_grad = float((t1.grad - t2.grad).abs().max()) / max(1.0, float(t2.grad.abs().max()))
    log(f"TableGather: rows max err {e_rows:.1e} (exact), table gradient {e_grad:.1e} of "
        "its max (tol 1e-5)")
    if not (e_rows == 0.0 and e_grad <= 1e-5):
        raise AssertionError("TableGather disagrees with plain autograd")

    probe = scatter_probe.run(3_145_728, 65_536, 16, reps=5, device=device, out=log)
    p1, p2 = probe[6], probe[7]
    if not (p1["max_err"] == 0.0 and p2["max_err"] <= 1e-5 * max(1.0, p2["max_abs"])):
        raise AssertionError(f"the probe's kernel rows disagree: {p1} {p2}")
    return cases, probe


GRID_ARGS = ["--model_type", "hashgrid", "--hash_layout", "split", "--hash_levels", "8",
             "--hash_feat", "8", "--hash_log2_size", "14", "--hash_max_res", "512"]


def phase_grid(device, steps=400, more=200, tri_steps=100, profile=False):
    """Phase 9: the split hashgrid through train, resume, render_only and
    the HTTP service, then the triplane with one upsample milestone."""
    import re

    import numpy as np

    from nerf_shared_tpu_torch.apps.serve import serve_parser
    from nerf_shared_tpu_torch.data.datasets import load_datasets
    from nerf_shared_tpu_torch.train.state import lr_at

    scene, logs = os.path.join(WORK, "train_scene"), os.path.join(WORK, "grid_logs")
    if not os.path.isdir(scene):
        write_train_scene(scene)
    lego = os.path.join(REPO, "configs", "lego.txt")
    total = steps + more
    base = ["--config", lego, "--datadir", scene, "--basedir", logs, "--expname",
            "hashgrid_smoke", "--device", device, "--testskip", "1", "--i_print", "50",
            "--i_testset", "0", "--i_video", "0", "--i_img", str(total),
            "--i_weights", str(steps)] + GRID_ARGS
    ds = load_datasets(serve_parser().parse_args(base + ["--port", "0"]))
    H, W = ds.hwf[0], ds.hwf[1]
    blocks = math.ceil(H * W / 32768)
    frame = {"gather": 2 * 8 * blocks, "composite": 2 * blocks}  # per dense frame

    zero_counts()
    t0 = time.perf_counter()
    _, text = run_train_cli(base + ["--N_iters", str(steps)])
    first = launch_counts()
    state, text2 = run_train_cli(base + ["--N_iters", str(total)])
    wall = time.perf_counter() - t0
    launches = launch_counts()
    want = {"gather": 16 * total + frame["gather"], "scatter_add": 16 * total,
            "composite": frame["composite"]}
    others = {k: v for k, v in launches.items() if k not in want}
    if ({k: launches[k] for k in want} != want or any(others.values())
            or first["gather"] != 16 * steps):
        raise AssertionError(f"hashgrid training launches {launches} (first run {first}), "
                             f"expected {want} and no B1-B4")
    if "Reloading from" not in text2 or state.count != total or state.step != total:
        raise AssertionError(f"hashgrid resume: count {state.count}, step {state.step}")
    lrs = {g["label"]: g["lr"] for g in state.optimizer.param_groups}
    if (abs(lrs["net"] - lr_at(5e-4, 500, total - 1)) > 1e-12
            or abs(lrs["grid"] - lr_at(2e-2, 500, total - 1)) > 1e-12):
        raise AssertionError(f"resumed lrs {lrs} are off the schedule")
    expdir = os.path.join(logs, "hashgrid_smoke")
    with np.load(os.path.join(expdir, f"{total:06d}.ckpt.npz")) as z:
        groups = (int(z["opt/n_groups"]), int(z["opt/g0/count"]), int(z["opt/g1/count"]))
        mu = float(np.abs(z["opt/g0/mu/fine/tables/0"]).max())
    if groups != (2, total, total) or not mu > 0 or any(
            f.endswith(".tar") for f in os.listdir(expdir)):
        raise AssertionError(f"hashgrid checkpoint: groups {groups}, grid mu {mu}")
    rps = [float(r.replace(",", "")) for r in re.findall(
        r"\[TRAIN\] Iter: \d+ .*?rays/sec: (\S+)", text + text2)]
    psnrs = [float(p) for p in re.findall(r"\[TRAIN\] Iter: \d+ Loss: \S+\s+PSNR: (\S+)",
                                          text + text2)]
    it, view, vpsnr, vssim = re.findall(
        r"\[VAL\] Iter: (\d+) view (\d+) PSNR: (\S+) SSIM: (\S+)", text2)[-1]
    white_psnr = -10.0 * math.log10(float(np.mean((1.0 - ds.images[int(view)]) ** 2)))
    ms_step = 1e3 * 1024 / statistics.median(rps[1:])
    log(f"hashgrid: {steps} + {more} steps in {wall:.1f} s; median "
        f"{statistics.median(rps[1:]):,.0f} rays/s = {ms_step:.2f} ms per step; train PSNR "
        f"{psnrs[0]:.2f} -> {psnrs[-1]:.2f} dB; held-out view {view} at step {it}: "
        f"{float(vpsnr):.2f} dB (SSIM {vssim}), all-white {white_psnr:.2f} dB; "
        f"launches {launches}")
    if not float(vpsnr) >= white_psnr + 2.0:
        raise AssertionError("hashgrid held-out PSNR is not 2 dB above all-white")

    zero_counts()
    _, text3 = run_train_cli(base + ["--N_iters", str(total), "--render_only",
                                     "--render_test"])
    render_launches = launch_counts()
    n_test = len(ds.i_test)
    if (render_launches["gather"] != n_test * frame["gather"]
            or render_launches["composite"] != n_test * frame["composite"]
            or sum(render_launches.values()) != n_test * sum(frame.values())):
        raise AssertionError(f"hashgrid render_only launches {render_launches}")

    served = serve_grid(base + ["--port", "0"], ds, frame, profile=profile)
    vertex_gb = check_vertex_chunk(device)
    vertex = phase_vertex(device, scene, lego)
    tri = phase_triplane(device, scene, lego, ds, tri_steps, blocks, profile)
    by_path = {"hashgrid_training": launches, "hashgrid_render_only": render_launches,
               "hashgrid_serving": served["launches"],
               "hashgrid_vertex_training": vertex["launches"], **tri["launches"]}
    return {"ms_per_step": ms_step, "rays_per_s": statistics.median(rps[1:]),
            "train_psnr": psnrs, "val": (int(it), int(view), float(vpsnr), float(vssim)),
            "white_psnr": white_psnr, "frame_ms": served["frame_ms"],
            "frame_err": served["err"], "triplane": tri["summary"],
            "vertex_chunk_peak_gb": vertex_gb,
            "vertex_ms_per_step": vertex["ms_per_step"],
            "launches_by_path": by_path}


def phase_vertex(device, scene, lego, steps=30):
    """The hashgrid at its defaults (vertex layout, L16/F2/T2^19) trained
    ``steps`` steps with configs/lego.txt on phase 6's scene: one fused P1
    and one P2 a pass, so exactly 2 + 2 a step and nothing else."""
    import re

    logs = os.path.join(WORK, "vertex_logs")
    argv = ["--config", lego, "--datadir", scene, "--basedir", logs, "--expname",
            "hashgrid_vertex_smoke", "--device", device, "--testskip", "1", "--i_print", "5",
            "--i_testset", "0", "--i_video", "0", "--i_img", "0", "--i_weights", "0",
            "--model_type", "hashgrid", "--N_iters", str(steps)]
    zero_counts()
    state, text = run_train_cli(argv)
    launches = launch_counts()
    want = {"gather": 2 * steps, "scatter_add": 2 * steps}
    if ({k: launches[k] for k in want} != want or sum(launches.values()) != 4 * steps
            or state.count != steps):
        raise AssertionError(f"vertex hashgrid training: launches {launches}, expected "
                             f"{want} and nothing else; Adam count {state.count}")
    rps = [float(r.replace(",", "")) for r in re.findall(
        r"\[TRAIN\] Iter: \d+ .*?rays/sec: (\S+)", text)]
    ms_step = 1e3 * 1024 / statistics.median(rps[1:])
    log(f"hashgrid at its defaults (vertex L16/F2/T2^19): {steps} steps, median "
        f"{statistics.median(rps[1:]):,.0f} rays/s = {ms_step:.2f} ms per step; launches "
        f"{launches}")
    return {"ms_per_step": ms_step, "launches": launches}


def check_vertex_chunk(device, n=32768):
    """One serving block (32768 rays, 64 + 128 samples, perturb 0) through
    a seeded hashgrid at the family's defaults (vertex layout, L16 / F2 /
    T 2^19): its fused gather holds 6,291,456 x 16 x 8 int32 indices (3.2
    GB) and as many [2]-float rows (6.4 GB). Returns the peak device memory
    in GB; fails unless the maps are finite and one P1 and one B5 launch a
    pass."""
    import torch

    from nerf_shared_tpu_torch.models.hashgrid import HashGrid, HashGridConfig
    from nerf_shared_tpu_torch.render.renderer import RenderConfig, render_rays

    cfg = HashGridConfig(aabb_min=(-4.72,) * 3, aabb_max=(4.72,) * 3)
    model = HashGrid(cfg, device=device, generator=torch.Generator().manual_seed(2))
    o, d, _, vd = lego_rays(n, 64, seed=12, device=device)
    rays = torch.cat([o, d, torch.full_like(o[:, :1], 2.0), torch.full_like(o[:, :1], 6.0),
                      vd], -1)
    rcfg = RenderConfig(perturb=0.0, N_importance=128, N_samples=64, white_bkgd=True,
                        near=2.0, far=6.0, use_pallas=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        ret = render_rays(model.params(), model.params(), rays, rcfg, cfg, cfg)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = launch_counts()
    log(f"vertex L16/F2/T2^19 hashgrid, one {n}-ray block (64 + 128 samples): {ms:.1f} ms, "
        f"peak device memory {peak:.2f} GB, launches {launches}")
    if not (bool(torch.isfinite(ret["rgb_map"]).all())
            and (launches["gather"], launches["composite"]) == (2, 2)):
        raise AssertionError("the vertex-layout block failed")
    return peak


def serve_grid(argv, ds, frame, profile=False):
    """Two requests of one held-out pose through the dense engine of a grid
    checkpoint; the frame against the same engine through the plain
    versions. Returns launches (both requests), frame ms and the error."""
    import numpy as np

    view = int(ds.i_test[0])
    pose = ds.poses[view][:3, :4]
    served = Served(argv, ds=ds)
    eng = served.service.engine
    try:
        zero_counts()
        status, _, body = http(served.base + "/render", {"c2w": pose.tolist(), "fmt": "npy"})
        one = launch_counts()
        status2, _, body2 = http(served.base + "/render",
                                 {"c2w": pose.tolist(), "fmt": "npy"})
        launches = launch_counts()
        info = json.loads(http(served.base + "/info")[2])
    finally:
        served.close()
    img, img2 = np.load(io.BytesIO(body)), np.load(io.BytesIO(body2))
    first_ms, ms = (t * 1e3 for t in served.service._latencies[:2])
    want = {k: frame.get(k, 0) for k in one}
    if (status, status2) != (200, 200) or one != want:
        raise AssertionError(f"grid frame: HTTP {status} {status2}, launches {one}, "
                             f"expected {want}")
    if img.shape != (eng.H, eng.W, 3) or not np.isfinite(img).all() or not np.array_equal(
            img, img2) or info["model_type"] != eng.args.model_type:
        raise AssertionError(f"grid frame: {img.shape}, /info {info}")
    c2w = np.asarray(pose, np.float32)
    rgb_k, acc_k, z_k, _, _ = engine_maps(eng, True, c2w)
    with plain_gathers():
        before = launch_counts()["gather"]
        rgb_u = engine_maps(eng, False, c2w)[0]
        rgb_p, acc_p = plain_fine_pass(eng, c2w, z_k)
        if launch_counts()["gather"] != before:
            raise AssertionError("the plain grid frame launched P1")
    err, n_held, flips = held(rgb_k, acc_k, rgb_p, acc_p)
    same = float(np.abs(rgb_k - img).max())
    log(f"{eng.args.model_type} frame over HTTP: {ms:.1f} ms ({first_ms:.1f} ms the first), "
        f"launches {one} a frame; vs plain versions at the kernel run's depths max err "
        f"{err:.2e} over {n_held}/{acc_k.size} rays ({flips} sentinel "
        f"flips set apart; tol 1e-3; unpinned {float(np.abs(rgb_k - rgb_u).max()):.2e}); "
        f"HTTP frame vs direct render {same:.1e}; vs held-out view {view} "
        f"{psnr(img, ds.images[view]):.2f} dB")
    if not (err <= 1e-3 and same <= 1e-6 and flips <= acc_k.size // 1000):
        raise AssertionError("the grid frame disagrees with the plain versions")
    if profile:
        _profile(f"{eng.args.model_type} frame", lambda: eng.render_poses(pose[None]))
    return {"launches": {k: launches[k] for k in launches}, "frame_ms": [first_ms, ms],
            "err": err}


def phase_triplane(device, scene, lego, ds, steps, blocks, profile=False):
    """The triplane at its defaults (G 256, C 16, vertex) for ``steps``
    steps from G 128 with one upsample milestone at steps // 2, then one
    served frame."""
    import re

    logs = os.path.join(WORK, "triplane_logs")
    half = steps // 2
    base = ["--config", lego, "--datadir", scene, "--basedir", logs, "--expname",
            "triplane_smoke", "--device", device, "--testskip", "1", "--i_print", "25",
            "--i_testset", "0", "--i_video", "0", "--i_img", "0", "--i_weights",
            str(steps), "--model_type", "triplane", "--triplane_res", "128",
            "--triplane_upsample", f"{half}:256", "--N_iters", str(steps)]
    zero_counts()
    state, text = run_train_cli(base)
    launches = launch_counts()
    want = {"gather": 24 * steps, "scatter_add": 24 * steps}
    if ({k: launches[k] for k in want} != want or sum(launches.values()) != 48 * steps
            or f"[UPSAMPLE] step {half}: planes -> 256^2" not in text
            or state.coarse.cfg.G != 256 or state.count != steps):
        raise AssertionError(f"triplane training: launches {launches}, G {state.coarse.cfg.G}")
    rps = [float(r.replace(",", "")) for r in re.findall(
        r"\[TRAIN\] Iter: \d+ .*?rays/sec: (\S+)", text)]
    frame = {"gather": 2 * 12 * blocks, "composite": 2 * blocks}
    served = serve_grid(base[:-2] + ["--port", "0"], ds, frame, profile=profile)
    ms_step = 1e3 * 1024 / statistics.median(rps[1:])
    summary = {"rays_per_s": rps, "ms_per_step": ms_step, "frame_ms": served["frame_ms"],
               "frame_err": served["err"]}
    log(f"triplane: {steps} steps, rays/s {rps}, median {ms_step:.2f} ms per step; "
        f"launches {launches}")
    return {"summary": summary, "launches": {"triplane_training": launches,
                                             "triplane_serving": served["launches"]}}


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
    table = {k: sum(ms for name, ms in by_name.items() if prefix in name)
             for k, prefix in (("P1", "p1_gather_rows"), ("P2", "p2_scatter_add_rows"))}
    if any(table.values()):
        log("  " + ", ".join(f"{k} {ms:.2f} ms = {100 * ms / busy:.1f}% of device time"
                             for k, ms in table.items()))


# the tensor-core kernels of each library (B1 and B3, B4)
TC_KERNELS = {"fused_mlp": ("nerf_points_tc_kernel", "nerf_rays_tc_kernel"),
              "fused_render": ("nerf_render_tc_kernel",)}


def check_tensor_cores(parent=False):
    """B1, B3 and B4 run on the tensor cores: each of their kernels
    (TC_KERNELS) is in its library's SASS and holds HGMMA instructions
    (Hopper's warpgroup MMA), and so does every other ``*_tc_kernel``
    there. Raises otherwise. (The wrappers launch only those kernels: their
    C entries are the ``_tc`` ones.) ``parent``: the tree is the parent
    side of an A/B (ab_smoke.sh), which may predate a kernel of TC_KERNELS;
    one it lacks is logged, one it has is held as above."""
    from nerf_shared_tpu_torch.ops.cuda import common

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    for name, wanted in TC_KERNELS.items():
        sass = subprocess.run([tool, "-sass", str(common.build([name])[name])],
                              capture_output=True, text=True, check=True).stdout
        kernels = {}
        current = None
        for line in sass.splitlines():
            if "Function :" in line:
                current = line.split("Function :")[1].strip()
                kernels[current] = 0
            elif current and "HGMMA" in line:
                kernels[current] += 1
        log(f"  SASS {name}: HGMMA instructions by kernel {kernels}")
        for want in wanted:
            if parent and not any(want in k for k in kernels):
                log(f"  SASS {name}: {want} is not in the parent tree")
            elif not any(want in k and n > 0 for k, n in kernels.items()):
                raise AssertionError(f"{name}: {want} is missing or holds no HGMMA")
        if any("_tc_kernel" in k and n == 0 for k, n in kernels.items()):
            raise AssertionError(f"{name}: a tensor-core kernel holds no HGMMA")


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
    only = None
    if "--phases" in sys.argv[1:]:
        only = {int(p) for p in sys.argv[sys.argv.index("--phases") + 1].split(",")}
    # the parent side of an A/B (ab_smoke.sh); only with --phases
    check_tensor_cores(parent=only is not None and "--parent-tree" in sys.argv[1:])
    profile = "--profile" in sys.argv[1:]

    def want(*phases):
        return only is None or any(p in only for p in phases)

    cases = []
    if want(2):
        t0 = time.perf_counter()
        cases += phase_kernels(device) + check_composite(device)
        log(f"phase 2: kernels vs plain versions in {time.perf_counter() - t0:.1f} s")
    if want(3, 4):
        t0 = time.perf_counter()
        served = phase_serving(device)
        log(f"phase 3+4: serving in {time.perf_counter() - t0:.1f} s")
    if want(5):
        t0 = time.perf_counter()
        train_cases, step = phase_train_kernels(device)
        cases += train_cases
        log(f"phase 5: training kernels in {time.perf_counter() - t0:.1f} s")
    if want(6, 7):
        t0 = time.perf_counter()
        trained = phase_training(device)
        log(f"phase 6: training in {time.perf_counter() - t0:.1f} s")
    if want(7):
        t0 = time.perf_counter()
        fast = phase_fast_serving(device, trained["base_argv"], profile=profile)
        log(f"phase 7: fast serving in {time.perf_counter() - t0:.1f} s")
    if want(8):
        t0 = time.perf_counter()
        gather_cases, probe = phase_gather(device)
        cases += gather_cases
        log(f"phase 8: gather kernels and the probe in {time.perf_counter() - t0:.1f} s")
    if want(9):
        t0 = time.perf_counter()
        grid = phase_grid(device, profile=profile)
        log(f"phase 9: grid families in {time.perf_counter() - t0:.1f} s")
    if profile:
        if want(3, 4):
            profile_frame(served["engine"], served["pose"])
        if want(5, 6):
            profile_train_step(device)
        if want(9):
            profile_grid_step(device)
            profile_grid_step(device, vertex=True)
    if only is not None:
        log(f"phases {sorted(only)} done (no result lines with --phases)")
        return 0
    by_path = dict(served["launches"])
    by_path["training"] = trained["launches"]
    by_path["render_only"] = trained["render_launches"]
    for name, *_ in FAST_ENGINES:  # the engine's build (the grid) and its request
        r = fast[name]
        by_path[name] = {k: r["build_launches"][k] + r["launches"][k] for k in r["launches"]}
    by_path.update(grid["launches_by_path"])

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
                      "nerf_shared_tpu/ops/pallas/composite.py:37"),
        "gather": ("nerf_shared_tpu_torch/csrc/gather.cu",
                   "benchmarks/scatter_probe.py:104"),
        "scatter_add": ("nerf_shared_tpu_torch/csrc/gather.cu",
                        "benchmarks/scatter_probe.py:134")}
    kernels = []
    for name, (src, replaces) in sources.items():
        mine = [c for c in cases if c["kernel"] == name]
        # the main path's shape: the largest sample count, or for P1 / P2
        # split L8/F8 level 3 in the fine pass on main-path indices
        main_case = (max(mine, key=lambda c: c["S"]) if "S" in mine[0] else next(
            c for c in mine if c["main"]))
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(p.get(name, 0) for p in by_path.values()),
            "launches_by_path": {k: p.get(name, 0) for k, p in by_path.items()},
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
            "library_ms": main_case.get("library_ms"),
            **({"design": main_case["design"],
                "bound_fp32_cuda_cores_ms": main_case["bound_fp32_cuda_cores_ms"]}
               if "design" in main_case else {}),
            "cases": mine,
        })
    log(json.dumps({"frame_ms": served["frame_ms"], "train_step": step, "fast": fast,
                    "training": {k: trained[k] for k in (
                        "ms_per_step", "rays_per_s", "train_psnr", "val", "white_psnr")},
                    "grid": {k: v for k, v in grid.items() if k != "launches_by_path"},
                    "probe": probe}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
