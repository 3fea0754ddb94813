"""Entry point of the port: checkpoint -> render engine, and ``render_only``.

Counterpart of ``run``, ``EvalEngine``, ``build_eval_engine`` and
``render_only`` in ``nerf_shared_tpu/apps/train.py`` (reference
main.py:17-147). This slice of the port serves and renders trained fields
with the dense hierarchical renderer; training is a later slice.

The entry points run on ``--device`` (default ``cuda``) and raise when it
is ``cuda`` and no CUDA device is present. fp32 matmuls and convolutions
are pinned to full fp32 (no TF32): the encoder's sinusoid arguments reach
2^9·|x|.

    python -m nerf_shared_tpu_torch.apps.train --config configs/lego.txt \
        --render_only --render_test
"""

from __future__ import annotations

import os

import torch

from nerf_shared_tpu_torch.config import config_parser
from nerf_shared_tpu_torch.data.datasets import load_datasets
from nerf_shared_tpu_torch.factory import create_nerf_models, get_renderer, nerf_configs
from nerf_shared_tpu_torch.utils import checkpoints as ckpt_utils

# flags whose eval paths this slice of the port does not carry: each raises
# instead of being ignored (name -> (is-set test, what it would need))
_NOT_PORTED = {
    "ema_decay": (lambda v: float(v) > 0.0, "EMA eval state (ROADMAP A11)"),
    "barf_anneal": (lambda v: int(v) > 0, "BARF eval annealing (ROADMAP A11)"),
    "occ_grid": (lambda v: int(v) > 0, "occupancy / froxel renders (ROADMAP A13)"),
    "render_gate": (lambda v: float(v) > 0.0, "gated renders (ROADMAP A13)"),
    "render_guided": (lambda v: int(v) > 0, "guided renders (ROADMAP A13)"),
    "proposal": (bool, "the proposal sampler (ROADMAP A11)"),
    "model_type": (lambda v: v != "nerf", "grid model families (ROADMAP A15)"),
    "precision": (lambda v: v != "fp32", "bf16 operands in the CUDA kernels"),
    "mesh_shape": (lambda v: bool(v), "multi-GPU renders (ROADMAP A16)"),
}


def resolve_device(name: str) -> torch.device:
    """The run's torch device; ``cuda`` without a CUDA device raises (the
    port never carries on on the CPU unless asked to)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA device is available (pass --device cpu "
            "to run the plain PyTorch versions on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {name}: only cuda and cpu are supported")
    return dev


def pin_fp32():
    """No TF32 anywhere on the fp32 path."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def check_ported(args):
    for flag, (is_set, what) in _NOT_PORTED.items():
        value = getattr(args, flag, None)
        if value is not None and is_set(value):
            raise NotImplementedError(
                f"--{flag} {value}: {what} is not ported to "
                "nerf_shared_tpu_torch yet")


def run(args) -> None:
    if args.render_only:
        render_only(args)
        return
    if not args.training:
        print("--training not set; nothing to do (see --render_only)")
        return
    train(args)


def train(args):
    raise NotImplementedError("training is a later slice of the port")


class EvalEngine:
    """Everything needed to render novel views from a checkpoint: dataset
    geometry, the restored models and the renderer. Built once and reused
    across poses by render_only and by apps/serve.py."""

    def __init__(self, ds, H, W, K, renderer, ccfg, fcfg, coarse, fine, start,
                 args, device):
        self.ds = ds
        self.H, self.W, self.K = H, W, K
        self.renderer = renderer
        self.ccfg, self.fcfg = ccfg, fcfg
        self.coarse, self.fine = coarse, fine
        self.start = start
        self.args = args
        self.device = device

    def render_poses(self, poses, save_directory=None, generator=None):
        """Render a [N, 3+, 4] pose batch; returns float rgbs [N, H, W, 3]."""
        return self.renderer.render_from_batch_poses(
            self.H, self.W, self.K, self.args.chunk, poses, self.coarse,
            self.fine, retraw=False, save_directory=save_directory,
            generator=generator,
            save_depth=getattr(self.args, "render_depth", False))

    @property
    def engine_name(self):
        return "dense"


def build_eval_engine(args, ds=None) -> EvalEngine:
    """Load the newest checkpoint (or seeded init weights when there is
    none) and assemble the dense render engine on ``--device``."""
    check_ported(args)
    device = resolve_device(args.device)
    pin_fp32()
    if ds is None:
        ds = load_datasets(args)
    H, W, _ = ds.hwf
    K = ds.K
    if args.render_factor > 0:
        H, W = H // args.render_factor, W // args.render_factor
        K = ds.K.copy()
        K[:2] = K[:2] / args.render_factor

    ccfg, fcfg = nerf_configs(args)
    coarse, fine = create_nerf_models(args, device)
    coarse_sd, fine_sd, start = ckpt_utils.load_checkpoint(args)
    if coarse_sd is not None:
        coarse.load_state_dict(coarse_sd, strict=True)
        if fine is not None and fine_sd:
            fine.load_state_dict(fine_sd, strict=True)
    coarse.eval()
    if fine is not None:
        fine.eval()
    renderer = get_renderer(args, ds.bds_dict, device)
    return EvalEngine(ds, H, W, K, renderer, ccfg, fcfg, coarse, fine, start,
                      args, device)


def render_only(args, return_rgbs: bool = False, ds=None):
    """Reload the newest weights and render render_poses (or the test set
    with --render_test) to PNGs. Returns the output directory, and with
    ``return_rgbs`` also the float renders."""
    eng = build_eval_engine(args, ds=ds)
    suffix = "test" if args.render_test else "path"
    outdir = os.path.join(args.basedir, args.expname,
                          f"renderonly_{suffix}_{eng.start:06d}")
    poses = eng.ds.render_poses
    poses = poses[:, :3, :4] if poses.ndim == 3 else poses
    rgbs = eng.render_poses(poses, save_directory=outdir)
    print(f"Done rendering {rgbs.shape[0]} views to {outdir}")
    if return_rgbs:
        return outdir, rgbs
    return outdir


def main(argv=None):
    run(config_parser().parse_args(argv))


if __name__ == "__main__":
    main()
