"""Holds the fp32 kernels B1-B5 of one tree bit for bit against another's
(with ``--dtype bf16``: the bf16 kernels B1-B4).

    mkdir -p build/parent build/change
    git archive <parent commit> | tar -x -C build/parent
    git archive $(git write-tree) | tar -x -C build/change
    python3 nerf_shared_tpu_torch/benchmarks/fp32_digest.py build/parent build/change
    python3 nerf_shared_tpu_torch/benchmarks/fp32_digest.py --dtype bf16 build/parent build/change

runs itself once in each tree, in a fresh process with that tree first on
``sys.path``, so that each builds and launches its own kernels from its
own sources. Each run calls the fp32 entry points (no compute dtype given)
on the same seeded inputs: B1, B2, B3, B4 and B5 at the lego width and
shapes, and B1-B4 at phase 2's other architectures of ``chip_smoke.py``
at odd shapes; and (fp32) one pass of a training step through
``fused_train_op`` under autograd, B1's forward then B2's backward: raw,
every weight gradient and dpts of lego's fine pass (1024 x 192 points) and
of a small net without viewdirs (each also with points that need no
gradient, as in every step but a pose step), and mip-NeRF's coarse pass
(4096 x 128 Gaussians, the IPE instantiations), so that two trees' B2
routes (B1's saved layer inputs, or the tile's own rerun of the forward;
with or without dx) are held bit for bit. It takes the sha256 of every output tensor's bytes, twice,
and fails if the two passes disagree (a kernel that is not deterministic
cannot be held bit for bit). The parent prints one line per output that
differs, then ``fp32 digest: N outputs, M differ`` and the card's name and
power limit; it exits 1 if any differs. ``--dtype bf16`` runs the same
cases through the bf16 entry points (compute dtype bfloat16: B1, B2, B3
and B4; B5 has no dtype) and prints ``bf16 digest: ...``. ``--one TREE``
is the child's mode: one tree's digests as a JSON line. Needs a CUDA card.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import subprocess
import sys

LEGO = dict(D=8, W=256, skips=(4,), use_viewdirs=True, multires=10, multires_views=4)
OTHER = [dict(D=3, W=64, skips=(1,), use_viewdirs=False, output_ch=5),
         dict(D=8, W=256, skips=(4,), multires=15, multires_views=6),
         dict(D=2, W=30, skips=(0,), i_embed=-1),
         dict(D=5, W=128, skips=(1, 3), multires=6, multires_views=2)]


def rays(n, S, seed, device):
    """Seeded rays from a radius-4 orbit through the scene, S sorted depths
    in [2, 6] a ray: (o, d, z, viewdirs)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    theta = torch.rand(n, generator=g) * 2 * math.pi
    o = torch.stack([4 * torch.sin(theta), 1.5 * torch.ones(n), 4 * torch.cos(theta)], -1)
    d = -o + torch.randn(n, 3, generator=g) * 0.8
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    z = torch.sort(2.0 + 4.0 * torch.rand(n, S, generator=g), -1).values
    return tuple(t.to(device=device, dtype=torch.float32).contiguous() for t in (o, d, z, d))


def digests(device, bf16=False):
    """{label: sha256} of every output of the fp32 kernels on this tree
    (``bf16``: of the bf16 kernels B1-B4)."""
    import torch

    from nerf_shared_tpu_torch.models.nerf import NeRF, NeRFConfig
    from nerf_shared_tpu_torch.ops.cuda import composite, fused_mlp, fused_mlp_bwd, fused_render

    out = {}

    def put(label, t):
        if isinstance(t, dict):
            for k in sorted(t):
                put(f"{label} {k}", t[k])
        elif isinstance(t, (tuple, list)):
            for i, x in enumerate(t):
                put(f"{label} [{i}]", x)
        elif t is not None:
            a = t.detach().contiguous().cpu().numpy().tobytes()
            out[label] = hashlib.sha256(a).hexdigest()

    dt = (torch.bfloat16,) if bf16 else ()
    cases = [("lego", LEGO, 0, (1024, 64), (8192, 64), (8192, 192))] + [
        (f"arch{i}", kw, i + 1, (37, 7), (37, 7), (37, 65)) for i, kw in enumerate(OTHER)]
    with torch.no_grad():
        for name, kw, seed, (pr, ps), (r1, s1), (r2, s2) in cases:
            cfg = NeRFConfig(**kw)
            params = {k: v.detach() for k, v in NeRF(
                cfg, device=device, generator=torch.Generator().manual_seed(seed)).params().items()}
            o, d, z, vd = rays(pr, ps, seed, device)
            vd = vd if cfg.use_viewdirs else None
            pts = (o[:, None] + d[:, None] * z[..., None]).contiguous()
            C = fused_mlp.out_channels(cfg)
            g = torch.randn(pr, ps, C, generator=torch.Generator().manual_seed(seed)).to(device)
            put(f"{name} B1 N={pr * ps}", fused_mlp.fused_nerf_forward(params, cfg, pts, vd, *dt))
            put(f"{name} B2 N={pr * ps}",
                fused_mlp_bwd.fused_mlp_backward(params, cfg, pts, vd, g, *dt))
            for n, S in ((r1, s1), (r2, s2)):
                o, d, z, vd = rays(n, S, seed + 100 * S, device)
                vd = vd if cfg.use_viewdirs else None
                put(f"{name} B3 {n}x{S}",
                    fused_mlp.fused_nerf_forward_rays(params, cfg, o, d, z, vd, *dt))
                if cfg.use_viewdirs or cfg.output_ch >= 4:
                    for white in (False, True):
                        put(f"{name} B4 {n}x{S} white={white}", fused_render.fused_render_rays(
                            params, cfg, o, d, z, vd, white, True, *dt))
        if bf16:
            return out
        o, d, z, _ = rays(8192, 192, 7, device)
        raw = torch.randn(8192, 192, 4, generator=torch.Generator().manual_seed(7)).to(device)
        for white in (False, True):
            put(f"B5 8192x192 white={white}", composite.composite_fused(raw, z, d, white))
    for label, cfg, seed, n, S in step_cases():
        params = {k: v.detach() for k, v in NeRF(
            cfg, device=device, generator=torch.Generator().manual_seed(seed)).params().items()}
        o, d, z, vd = rays(n, S, seed, device)
        pts = (o[:, None] + d[:, None] * z[..., None]).contiguous()
        if cfg.ipe:   # Gaussians: the mean, then small variances
            var = 1e-4 * (1 + torch.rand(n, S, 3, generator=torch.Generator().manual_seed(seed)))
            pts = torch.cat([pts, var.to(device)], -1).contiguous()
        vd = vd if cfg.use_viewdirs else None
        # with the points' gradient (a pose step) and without it (every
        # other step: B2's tile then forms no dx)
        for need_x in ((False,) if cfg.ipe else (True, False)):
            leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
            x = pts.clone().requires_grad_(need_x)
            with torch.enable_grad():
                raw = fused_mlp_bwd.fused_train_op(leaves, cfg, x, vd)
                g = torch.randn(raw.shape,
                                generator=torch.Generator().manual_seed(seed)).to(device)
                ins = list(leaves.values()) + ([x] if need_x else [])
                grads = torch.autograd.grad((raw * g).sum(), ins)
            tag = "" if need_x or cfg.ipe else " (points need no gradient)"
            put(f"{label} step raw{tag}", raw)
            put(f"{label} step grads{tag}", dict(zip(list(leaves) + ["dpts"], grads)))
    return out


def step_cases():
    """(label, cfg, seed, rays, samples) of the training-step passes."""
    from nerf_shared_tpu_torch.models.nerf import MipNeRFConfig, NeRFConfig

    return [("lego fine", NeRFConfig(**LEGO), 0, 1024, 192),
            ("arch0", NeRFConfig(**OTHER[0]), 1, 37, 65),
            ("mip coarse", MipNeRFConfig(multires=16), 18, 4096, 128)]


def one(tree, bf16=False):
    """Child: this tree's digests, twice, as one JSON line."""
    sys.path.insert(0, os.path.abspath(tree))
    import nerf_shared_tpu_torch

    where = os.path.dirname(os.path.abspath(nerf_shared_tpu_torch.__file__))
    if not where.startswith(os.path.abspath(tree) + os.sep):
        raise SystemExit(f"imported nerf_shared_tpu_torch from {where}, not from {tree}")
    first, second = digests("cuda", bf16), digests("cuda", bf16)
    print(json.dumps({"digests": first,
                      "unstable": sorted(k for k in first if second.get(k) != first[k])}))


def main(argv):
    dtype = "fp32"
    if argv[:1] == ["--dtype"] and len(argv) > 1 and argv[1] in ("fp32", "bf16"):
        dtype, argv = argv[1], argv[2:]
    if len(argv) == 2 and argv[0] == "--one":
        one(argv[1], dtype == "bf16")
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    runs = {}
    for tree in argv:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--dtype", dtype,
                               "--one", tree], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr)
            print(f"{dtype} digest: the run in {tree} failed (rc {proc.returncode})")
            return 1
        runs[tree] = json.loads(proc.stdout.strip().splitlines()[-1])
    a, b = (runs[t] for t in argv)
    labels = sorted(set(a["digests"]) | set(b["digests"]))
    differ = [k for k in labels if a["digests"].get(k) != b["digests"].get(k)]
    for k in differ:
        print(f"differs: {k}")
    for tree in argv:
        for k in runs[tree]["unstable"]:
            print(f"not deterministic in {tree}: {k}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"{dtype} digest: {len(labels)} outputs, {len(differ)} differ, "
          f"{sum(len(r['unstable']) for r in runs.values())} not deterministic "
          f"({smi.stdout.strip()})")
    return 1 if differ or any(r["unstable"] for r in runs.values()) else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
