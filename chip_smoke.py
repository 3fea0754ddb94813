#!/usr/bin/env python3
"""Smoke run of the PyTorch port (nerf_shared_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--profile]

Phases (any failure exits non-zero and prints no result line):

1. build    nvcc builds every kernel of the serving path from csrc/, in
            parallel, into build/nerf_shared_tpu_torch/.
2. kernels  at the lego width (8x256, skip at 4, viewdirs, multires 10/4)
            with seeded weights and rays at the main path's shapes (one ray
            block of --chunk 32768 rays): B3 at S=64 and S=192 and B4 at
            S=192 against their plain PyTorch versions, one gradient through
            each autograd.Function, and median times.
3. serving  a synthetic 800x800 blender scene loaded with configs/lego.txt
            (half_res: 400x400 frames), a .tar of seeded random lego-width
            weights, and the port's HTTP service on port 0: three render
            requests (GET and POST) and /metrics. Checks HTTP 200, decodable
            400x400x3 PNGs, a finite float frame that matches the plain
            renderer on a band of rays, and B3 launched exactly
            2 x ceil(160000 / chunk) times per frame.
4. fused    one request through an engine with --fused_composite True: B4
            launched, pixels match phase 3's frame within 1e-3 on rays clear
            of the 1e10 sentinel.

``--profile`` adds one dense frame under torch.profiler (device time by
kernel, device busy share). Before the last line it prints the kernels JSON line and the card's
``nvidia-smi --query-gpu=name,power.limit`` line; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import io
import json
import math
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
    """The port's HTTP service on port 0, as apps/serve.main builds it."""

    def __init__(self, argv):
        from nerf_shared_tpu_torch.apps.serve import RenderService, make_server, serve_parser

        self.args = serve_parser().parse_args(argv)
        self.service = RenderService(self.args)
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
    from nerf_shared_tpu_torch.ops.cuda import fused_mlp, fused_render
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
        fused_mlp.LAUNCHES = 0
        fused_render.LAUNCHES = 0
        t0 = time.perf_counter()
        replies = [
            http(served.base + "/render?theta=30&phi=-30&radius=4"),
            http(served.base + "/render", {"c2w": pose_a.tolist(), "fmt": "npy"}),
            http(served.base + "/render?theta=120&phi=-20&radius=4.5"),
        ]
        wall = time.perf_counter() - t0
        launches = {"fused_mlp": fused_mlp.LAUNCHES,
                    "fused_render": fused_render.LAUNCHES}
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
    if launches != {"fused_mlp": 3 * per_frame, "fused_render": 0}:
        raise AssertionError(f"expected {3 * per_frame} B3 launches, got {launches}")

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
        fused_mlp.LAUNCHES = 0
        fused_render.LAUNCHES = 0
        status, _, body = http(served.base + "/render",
                               {"c2w": pose_a.tolist(), "fmt": "npy"})
        fused_launches = {"fused_mlp": fused_mlp.LAUNCHES,
                          "fused_render": fused_render.LAUNCHES}
    finally:
        served.close()
    fused_frame = np.load(io.BytesIO(body))
    ferr = float(np.abs(fused_frame - frame)[mask].max())
    log(f"fused-composite frame: {served.service._latencies[0] * 1e3:.0f} ms, "
        f"launches {fused_launches}, max err vs phase 3 {ferr:.2e} over "
        f"{int(mask.sum())}/{mask.size} masked pixels (tol 1e-3)")
    if status != 200 or not np.isfinite(fused_frame).all():
        raise AssertionError("fused-composite request failed")
    if fused_launches != {"fused_mlp": per_frame // 2, "fused_render": per_frame // 2}:
        raise AssertionError(f"fused-composite launches: {fused_launches}")
    if not ferr <= 1e-3:
        raise AssertionError("fused-composite frame disagrees with phase 3")
    return {"launches": {"dense": launches, "fused_composite": fused_launches},
            "frame_ms": {"dense": [x * 1e3 for x in lat],
                         "fused_composite": [x * 1e3 for x in
                                             served.service._latencies]},
            "engine": eng, "pose": pose_a}


def profile_frame(eng, pose):
    """One dense frame under torch.profiler: device time by kernel and the
    device's busy share of the frame's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng.render_poses(pose[None])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.render_poses(pose[None])
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
    log(f"profile: frame {wall_ms:.1f} ms wall, device busy {busy:.1f} ms "
        f"({100 * busy / wall_ms:.1f}%)")
    for name, ms in top:
        log(f"  {ms:9.2f} ms  {100 * ms / busy:5.1f}%  {name[:90]}")


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
    cases = phase_kernels(device)
    log(f"phase 2: kernels vs plain versions in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    served = phase_serving(device)
    log(f"phase 3+4: serving in {time.perf_counter() - t0:.1f} s")
    if "--profile" in sys.argv[1:]:
        profile_frame(served["engine"], served["pose"])
    by_path = served["launches"]

    sources = {"fused_mlp": ("nerf_shared_tpu_torch/csrc/fused_mlp.cu",
                             "nerf_shared_tpu/ops/pallas/fused_mlp.py:280"),
               "fused_render": ("nerf_shared_tpu_torch/csrc/fused_render.cu",
                                "nerf_shared_tpu/ops/pallas/fused_render.py:80")}
    kernels = []
    for name, (src, replaces) in sources.items():
        mine = [c for c in cases if c["kernel"] == name]
        main_case = max(mine, key=lambda c: c["S"])
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(p[name] for p in by_path.values()),
            "launches_by_path": {k: p[name] for k, p in by_path.items()},
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
            "library_ms": None,
            "cases": mine,
        })
    log(json.dumps({"frame_ms": served["frame_ms"]}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
