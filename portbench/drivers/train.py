"""Traffic kind ``train``: the trainer's closed step loop.

Set-up builds the training step as ``apps/train.py`` ``_train`` builds it
(the program's parser, ``factory.get_train_state``, ``get_renderer``, the
step's render config with ``fused_backward`` as ``resolve_fused_backward``
resolves it: kernels B1 and B2 on a card) over the benchmark's weights and
seeded images and poses, then drives that same object through its first
``checked_steps`` steps with the trainer's own feed (a CPU generator
reseeded each step from the run's seed and the step). The window goes on
with the same object and feed: steps enqueued back to back, the host's
run-ahead intact, closed by one device sync.

The check: once the window has closed and the program's state is freed,
the reference trains the same steps from the same weights on the same
draws, and the program's losses, its first gradient (Adam's first moment
after one step, over 1 - beta1) and its parameters' change after the
checked steps are compared leaf by leaf.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict

import torch

from portbench.core import inputs, program
from portbench.core.trace import DeviceTrace, Spans
from portbench.reference import compare
from portbench.reference import nerf as ref

BETA1 = 0.9


class Driver:
    kind = "train"

    def __init__(self, cell, seed: int, device, faults=None):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.cfg = cell.config
        self.scene = inputs.scene_of(self.cfg)
        self.net = inputs.net_of(self.cfg)
        self.faults = faults or {}
        self.spans = Spans()
        self.host = {}

    # ---------------------------------------------------------- set-up
    def setup(self):
        from nerf_shared_tpu_torch.apps.train import pin_fp32
        from nerf_shared_tpu_torch.config import resolve_fused_backward
        from nerf_shared_tpu_torch.factory import get_renderer, get_train_state, nerf_configs
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
        self.weights = inputs.make_weights(self.seed, self.cfg, dev)
        for b, m in self.state.branches():
            program.load_weights(m, self.weights[b])
        renderer = get_renderer(args, {"near": self.scene["near"], "far": self.scene["far"]},
                                dev)
        spec = PixelSamplerSpec.from_K(
            self.scene["H"], self.scene["W"], self.scene["K"], args.N_rand,
            single_image=args.no_batching, precrop_iters=args.precrop_iters,
            precrop_frac=args.precrop_frac, exact_epochs=bool(args.exact_epochs))
        rcfg = dataclasses.replace(renderer.cfg, use_pallas=False, fused_composite=False,
                                   fused_backward=resolve_fused_backward(args, dev), guided=0)
        self.precision = rcfg.precision
        self.step_fn = make_train_step(
            rcfg, ccfg, fcfg, spec, acc_reg=args.acc_loss_weight, tv_reg=args.tv_loss_weight,
            prop_reg=args.proposal_loss_weight, dist_reg=args.distortion_loss_weight)
        self.generator = torch.Generator()
        self.i = 0
        if "setup" in self.faults:
            self.faults["setup"](self)
        self._checked_steps()

    def _step(self):
        """One step with the trainer's feed (apps/train.py reseeds its
        generator from (seed << 32) + i before step i)."""
        self.i += 1
        self.generator.manual_seed(self.step_seed(self.i))
        return self.step_fn(self.state, self.images, self.poses, self.generator)

    def step_seed(self, i: int) -> int:
        return (int(self.args.jax_seed) << 32) + i

    def _checked_steps(self):
        named = self.state.named_parameters()
        self.prog = {"loss": [], "grad": {}, "change": {}}
        for k in range(self.cell.traffic["checked_steps"]):
            aux = self._step()
            self.prog["loss"].append(float(aux["loss"]))
            if k == 0:
                st = self.state.optimizer.state
                self.prog["grad"] = {
                    _key(b, n): float(torch.linalg.vector_norm(st[p]["exp_avg"])) / (1 - BETA1)
                    if p in st and "exp_avg" in st[p] else 0.0
                    for (b, n), p in named.items()}
        self.prog["change"] = {
            _key(b, n): float(torch.linalg.vector_norm(p.detach() - self.weights[b][n]))
            for (b, n), p in named.items()}

    # ---------------------------------------------------------- window
    def window(self, seconds: float, trace: bool) -> dict:
        dev = self.device
        tracer = DeviceTrace(dev) if trace else None
        before = program.counters()
        losses, steps = [], 0
        if tracer is not None:
            t0 = tracer.open()
        else:
            _sync(dev)
            t0 = time.perf_counter_ns()
        deadline = t0 + int(seconds * 1e9)
        while time.perf_counter_ns() < deadline:
            s = time.perf_counter_ns()
            aux = self._step()
            self.spans.add("train_step", s, time.perf_counter_ns())
            losses.append(aux["loss"])
            steps += 1
        _sync(dev)
        t_end = time.perf_counter_ns()
        win = tracer.close(t_end) if tracer is not None else None
        after = program.counters()
        failed = int((~torch.isfinite(torch.stack(losses))).sum()) if losses else 0
        window_s = (t_end - t0) / 1e9
        self.host["step_ms"] = [(e - s) / 1e6 for s, e in self.spans.named("train_step")]
        return {"t0": t0, "attempted": steps, "failed": failed, "units": steps, "window_s": window_s,
                "trace": win, "launches": {k: after[k] - before[k] for k in after},
                "metrics": {"train_rays_per_s": steps * self.scene["N_rand"] / window_s}}

    def span_labels(self) -> Dict[str, str]:
        return {"train_step": "host in train_step (draw, rays, launches, autograd, Adam)"}

    # ----------------------------------------------------------- check
    def release(self):
        """Free the program's state before the reference runs."""
        self.state = self.step_fn = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self) -> dict:
        """The reference's losses, first-gradient norms and change norms of
        the checked steps, from the benchmark's weights and draws."""
        params = {b: {n: t.clone() for n, t in leaves.items()}
                  for b, leaves in self.weights.items()}
        gens = [torch.Generator().manual_seed(self.step_seed(i))
                for i in range(1, len(self.prog["loss"]) + 1)]
        out = ref.train_steps(params, self.net, self.scene, self.images, self.poses, gens,
                              float(self.args.lrate), int(self.args.lrate_decay))
        return {"loss": out["loss"],
                "grad": {_key(*k): float(torch.linalg.vector_norm(g))
                         for k, g in out["grad"].items()},
                "change": {_key(b, n): float(torch.linalg.vector_norm(
                    params[b][n] - self.weights[b][n])) for b in params for n in params[b]}}

    def check(self) -> Dict[str, float]:
        ref.no_tf32()
        out = self.reference()
        grad, change = out["grad"], out["change"]
        g_gap, g_leaf = compare.norm_gap(self.prog["grad"], grad)
        moving = compare.moving_leaves(grad)
        c_gap, c_leaf = compare.norm_gap(self.prog["change"], change, keep=moving)
        self.detail = {"loss_prog": self.prog["loss"], "loss_ref": out["loss"],
                       "loss_gap_all_steps": compare.loss_gap(self.prog["loss"], out["loss"]),
                       "grad_worst_leaf": g_leaf, "change_gap_worst_leaf": [c_gap, c_leaf],
                       "leaves_compared_for_change": len(moving)}
        return {"loss1_gap": compare.loss_gap(self.prog["loss"][:1], out["loss"][:1]),
                "grad_gap": g_gap,
                "change_gap": compare.median_gap(self.prog["change"], change, keep=moving)}

    def close(self):
        import shutil

        if hasattr(self, "workdir"):
            shutil.rmtree(self.workdir, ignore_errors=True)


def _key(branch: str, name: str) -> str:
    return f"{branch}/{name}"


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
