"""Probe: how far the tensor-core MLP kernels B1 and B3 and the plain fp32
chain are from a float64 forward of the same network, and how far B2's
weight and bias gradients, its input gradients (dpts, ddirs) and the
plain fp32 backward's are from a float64 backward, on the card.

    python -m nerf_shared_tpu_torch.benchmarks.mlp_accuracy [--rays 1024 --samples 64]

B1 and B3 run the same split-fp32 tile (``csrc/mlp_tile_tc.cuh``) and
differ in where a GEMM's sum over K is kept: B1 adds each 8-row slice's
sum in fp32 on the CUDA cores, B3 keeps the running sum in the tensor
cores' accumulator, which drops low bits at every MMA. The mean error
shows that drift as a bias. Inputs: seeded lego-width weights and points
on seeded rays through the lego volume; B3 reads the rays and depths
that give the same fp32 points. Prints one JSON line per forward path
(rgb and sigma: max, rms and mean of the error), one per backward path
(each parameter's gradient and dpts / ddirs: max, rms and mean of the
error, the mean showing any bias of the tensor cores' sums in B2's tile
and dW products, with the cotangent of the raw outputs seeded) and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess

import torch

from nerf_shared_tpu_torch.models.nerf import NeRF, NeRFConfig, apply_nerf
from nerf_shared_tpu_torch.ops.cuda import fused_mlp, fused_mlp_bwd


def rays(n: int, S: int, seed: int, device):
    """Origins on the radius-4 orbit, unit directions through the scene,
    sorted depths in [2, 6]."""
    g = torch.Generator().manual_seed(seed)
    theta = torch.rand(n, generator=g) * 2 * math.pi
    o = torch.stack([4 * torch.sin(theta), 1.5 * torch.ones(n), 4 * torch.cos(theta)], -1)
    d = -o + torch.randn(n, 3, generator=g) * 0.8
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    z = torch.sort(2 + 4 * torch.rand(n, S, generator=g), -1).values
    return o.to(device), d.to(device), z.to(device)


def errors(got: torch.Tensor, want: torch.Tensor) -> dict:
    e = got.double() - want
    out = {}
    for name, cols in (("rgb", slice(0, 3)), ("sigma", slice(3, 4))):
        x = e[..., cols]
        out[name] = {"max": float(x.abs().max()), "rms": float(x.pow(2).mean().sqrt()),
                     "mean": float(x.mean())}
    return out


def grad_errors(got: dict, want: dict) -> dict:
    """Per parameter: max, rms and mean of got - want, and max |want|."""
    out = {}
    for k, w in want.items():
        e = got[k].double() - w
        out[k] = {"max": float(e.abs().max()), "rms": float(e.pow(2).mean().sqrt()),
                  "mean": float(e.mean()), "scale": float(w.abs().max())}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rays", type=int, default=1024)
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mlp_accuracy: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = NeRFConfig(D=8, W=256, skips=(4,), use_viewdirs=True, multires=10,
                     multires_views=4)
    params = {k: v.detach() for k, v in NeRF(
        cfg, device=dev, generator=torch.Generator().manual_seed(args.seed)).params().items()}
    p64 = {k: v.double() for k, v in params.items()}
    o, d, z = rays(args.rays, args.samples, args.seed, dev)
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).contiguous()
    with torch.no_grad():
        want = apply_nerf(p64, cfg, pts.double(), d.double())
        paths = {
            "plain fp32 (cuBLAS)": apply_nerf(params, cfg, pts, d),
            "B1 nerf_points_tc_kernel (slice sums on the CUDA cores)":
                fused_mlp.launch_points(params, cfg, pts, d),
            "B3 nerf_rays_tc_kernel (running sum on the tensor cores)":
                fused_mlp.fused_nerf_forward_rays(params, cfg, o, d, z, d),
        }
        for name, got in paths.items():
            print(json.dumps({"path": name, "points": pts.shape[0] * pts.shape[1],
                              **errors(got, want)}))
    g = torch.randn(pts.shape[:-1] + (4,), generator=torch.Generator().manual_seed(
        args.seed + 1)).to(dev)
    want, wpts, wdirs = fused_mlp_bwd.plain_mlp_backward(p64, cfg, pts.double(), d.double(),
                                                         g.double())
    backward = {
        "plain fp32 backward (autograd, cuBLAS)":
            fused_mlp_bwd.plain_mlp_backward(params, cfg, pts, d, g),
        "B2 (tile and dW split fp32 on the tensor cores, k8 slice sums in fp32)":
            fused_mlp_bwd.fused_mlp_backward(params, cfg, pts, d, g),
    }
    for name, (got, dpts, ddirs) in backward.items():
        errs = grad_errors(got, want)
        worst = {q: max(v[q] / v["scale"] if q != "mean" else abs(v[q]) / v["scale"]
                        for v in errs.values()) for q in ("max", "rms", "mean")}
        inputs = grad_errors({"dpts": dpts, "ddirs": ddirs}, {"dpts": wpts, "ddirs": wdirs})
        print(json.dumps({"path": name, "points": pts.shape[0] * pts.shape[1],
                          "worst_of_max_grad": worst, "inputs": inputs, "grads": errs}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
