"""Traffic kind ``train_mip``: mip-NeRF's training step in the trainer's
closed loop (``--model_type mipnerf``).

As kind ``train`` (drivers/train.py): set-up builds the step as
``apps/train.py`` builds it (the program's parser, ``factory``'s state,
renderer and coarse-loss weight, ``make_train_step`` with kernels B1 and
B2 on a card, their IPE instantiations) over the benchmark's weights and
seeded images and poses, and drives it through its first ``checked_steps``
steps with the trainer's feed; the window goes on with the same object and
feed, closed by one device sync.

The weights: mip-NeRF's one network, drawn in the reference's layout
(portbench/reference/mipnerf.py) and put into the program through the
reference's own map (``to_program``). The check: after the window the
reference trains the same steps from the same weights on the same draws;
the losses, the first gradient and the change after the checked steps are
compared leaf by leaf, by the program's names.

The window also counts the IPE kernels' launches and encoded points
(``B1 ipe``, ``B2 ipe``, ``ipe points``), which the per-layer metrics of
the cell read; a program without them counts none.

``FAULTS["unattenuated"]``: the program's Gaussians lose their variances
(the published ``disable_integration``), so the IPE loses its attenuation;
a fault for ``correct`` to catch, installed through the drivers' ``setup``
fault hook.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Callable, Dict

import torch

from portbench.core import inputs, program
from portbench.drivers import train as base
from portbench.reference import mipnerf as ref

# the program's IPE counters: key -> (module, attribute)
COUNTERS = {
    "B1 ipe": ("nerf_shared_tpu_torch.ops.cuda.fused_mlp", "POINT_LAUNCHES_IPE"),
    "B2 ipe": ("nerf_shared_tpu_torch.ops.cuda.fused_mlp_bwd", "LAUNCHES_IPE"),
    "ipe points": ("nerf_shared_tpu_torch.ops.cuda.fused_mlp", "IPE_POINTS"),
}


def counters() -> Dict[str, int]:
    """The IPE counters the program has (0 for one it lacks)."""
    return {k: int(getattr(importlib.import_module(m), a, 0)) for k, (m, a) in COUNTERS.items()}


def net_of(cfg: dict) -> dict:
    """The reference's sizes and recipe: depth, width and the initial rate
    from the configuration's flags, the rest from its ``recipe`` (the
    published values, which the program holds as constants)."""
    f = cfg["flags"]
    return {"depth": f["netdepth"], "width": f["netwidth"], "lr_init": f["lrate"],
            **cfg["recipe"]}


def make_weights(seed: int, cfg: dict, net: dict, device) -> Dict[str, torch.Tensor]:
    """The network's leaves in the reference's layout: kernels ~ U(-sqrt(6 /
    fan_in), sqrt(6 / fan_in)), biases ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    one uniform draw on the device; then the density head's bias shifted so
    that softplus(raw + density_bias) averages the configuration's
    ``density_mean`` over 4096 seeded points of its ``density_box`` (taken
    as Gaussians of zero variance)."""
    ref.no_tf32()
    ds = cfg["dataset"]
    shapes = ref.param_shapes(net)
    total = sum(math.prod(s) for s in shapes.values())
    u = torch.rand(total, generator=inputs.device_generator(seed, "weights/mip", device),
                   device=device)
    leaves, at, fan_in = {}, 0, None
    for name, shape in shapes.items():
        kernel = name.endswith(".kernel")
        if kernel:
            fan_in = shape[0]
        n = math.prod(shape)
        bound = math.sqrt((6.0 if kernel else 1.0) / fan_in)
        leaves[name] = ((u[at:at + n] * 2.0 - 1.0) * bound).reshape(shape)
        at += n
    g = inputs.device_generator(seed, "density/mip", device)
    lo, hi = (torch.tensor(v, dtype=torch.float32, device=device) for v in ds["density_box"])
    pts = lo + (hi - lo) * torch.rand((4096, 1, 3), generator=g, device=device)
    dirs = torch.nn.functional.normalize(torch.randn((4096, 3), generator=g, device=device),
                                         dim=-1)
    enc = ref.integrated_pos_enc(pts, torch.zeros_like(pts), net["min_deg_point"],
                                 net["max_deg_point"])
    cond = ref.pos_enc(dirs, 0, net["deg_view"], True)[:, None, :]
    _, raw_density = ref.mlp(leaves, net, enc, cond)
    target = math.log(math.expm1(ds["density_mean"]))   # softplus's inverse
    leaves["density.bias"] += target - (raw_density + net["density_bias"]).mean()
    return leaves


def _unattenuated(driver) -> Callable:
    from nerf_shared_tpu_torch.render import renderer

    orig = renderer.cast_rays

    def no_variance(*a, **kw):
        g = orig(*a, **kw)
        return torch.cat([g[..., :3], torch.zeros_like(g[..., 3:])], dim=-1).contiguous()

    renderer.cast_rays = no_variance

    def undo():
        renderer.cast_rays = orig
    return undo


FAULTS = {"unattenuated": _unattenuated}


class Driver(base.Driver):
    kind = "train_mip"

    def __init__(self, cell, seed: int, device, faults=None):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.cfg = cell.config
        self.scene = inputs.scene_of(self.cfg)
        self.net = net_of(self.cfg)
        self.faults = faults or {}
        self.spans = base.Spans()
        self.host = {}

    # ---------------------------------------------------------- set-up
    def setup(self):
        from nerf_shared_tpu_torch.apps.train import pin_fp32
        from nerf_shared_tpu_torch.config import resolve_fused_backward
        from nerf_shared_tpu_torch.factory import (
            coarse_loss_weight,
            get_renderer,
            get_train_state,
            nerf_configs,
        )
        from nerf_shared_tpu_torch.train.pipeline import PixelSamplerSpec
        from nerf_shared_tpu_torch.train.step import make_train_step

        self.workdir = program.work_dir()
        args = program.parse_args(self.cfg, self.cell.traffic, self.seed, self.device,
                                  self.workdir)
        self.args = args
        pin_fp32()
        dev = self.device
        poses, _, i_train, _ = inputs.make_poses(self.seed, self.cfg)
        self.images = inputs.make_images(self.seed, self.cfg, len(i_train), dev)
        self.poses = torch.as_tensor(poses[i_train], device=dev)
        ccfg, fcfg = nerf_configs(args)
        self.state = get_train_state(args, dev, cfgs=(ccfg, fcfg))
        self.ref_weights = make_weights(self.seed, self.cfg, self.net, dev)
        self.weights = {"coarse": ref.to_program(self.ref_weights, self.net)}
        for b, m in self.state.branches():
            program.load_weights(m, self.weights[b])
        renderer = get_renderer(args, {"near": self.scene["near"], "far": self.scene["far"]},
                                dev)
        spec = PixelSamplerSpec.from_K(
            self.scene["H"], self.scene["W"], self.scene["K"], args.N_rand,
            single_image=args.no_batching, precrop_iters=args.precrop_iters,
            precrop_frac=args.precrop_frac)
        rcfg = dataclasses.replace(renderer.cfg, use_pallas=False, fused_composite=False,
                                   fused_backward=resolve_fused_backward(args, dev), guided=0)
        self.precision = rcfg.precision
        self.step_fn = make_train_step(rcfg, ccfg, fcfg, spec,
                                       coarse_weight=coarse_loss_weight(args))
        self.generator = torch.Generator()
        self.i = 0
        if "setup" in self.faults:
            self.faults["setup"](self)
        self._checked_steps()

    # ---------------------------------------------------------- window
    def window(self, seconds: float, trace: bool) -> dict:
        before = counters()
        out = super().window(seconds, trace)
        after = counters()
        out["launches"].update({k: after[k] - before[k] for k in after})
        return out

    # ----------------------------------------------------------- check
    def reference(self) -> dict:
        """The reference's losses, first-gradient norms and change norms of
        the checked steps, from the benchmark's weights and draws, by the
        program's leaf names."""
        params = {n: t.clone() for n, t in self.ref_weights.items()}
        gens = [torch.Generator().manual_seed(self.step_seed(i))
                for i in range(1, len(self.prog["loss"]) + 1)]
        out = ref.train_steps(params, self.net, self.scene, self.images, self.poses, gens)

        def key(name):
            return base._key("coarse", ref.program_name(name))

        return {"loss": out["loss"],
                "grad": {key(n): float(torch.linalg.vector_norm(g))
                         for n, g in out["grad"].items()},
                "change": {key(n): float(torch.linalg.vector_norm(params[n] - w))
                           for n, w in self.ref_weights.items()}}
