"""CLI of the relative-pose-estimation demo.

Counterpart of ``nerf_shared_tpu/apps/pose_cli.py`` (reference
examples/relative_pose_estimation_demo/demo_est_rel_pose.py): load a
dataset and a trained checkpoint (a ``.tar`` or ``.ckpt.npz`` written by
either package), perturb the first test view's ground-truth pose by
delta_{psi,phi,theta,t}, then recover it by photometric optimisation
(apps/pose_estimation.py). The core parser is extended with the demo's
flags, as in the JAX package.

    python -m nerf_shared_tpu_torch.apps.pose_cli --config configs/lego.txt \\
        --delta_theta 4 --delta_t 0.1

It runs on ``--device`` (default ``cuda``, raising without a card). On the
card the MLP family's pose step goes through kernels B1 / B2 (and B5)
unless ``--fused_backward false`` asks for the renderer's own route (B3
forward with a plain remat backward, then B5); the JAX pose CLI has one
route and ignores that flag. The optimisation is one small problem, which
the JAX pose CLI runs on one device: under torchrun with ``--mesh_shape N``
rank 0 runs it and the other ranks return at once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nerf_shared_tpu_torch.config import ConfigArgumentParser, config_parser


def extend_parser_for_pose(parser: ConfigArgumentParser) -> ConfigArgumentParser:
    """Add the pose-demo flags (reference demo_est_rel_pose.py:239-267)."""
    parser.add_argument("--output_dir", type=str, default="./output/")
    parser.add_argument("--dil_iter", type=int, default=3,
                        help="dilation iterations for the interest-region mask")
    parser.add_argument("--kernel_size", type=int, default=5,
                        help="dilation kernel size")
    parser.add_argument("--batch_size", type=int, default=512,
                        help="rays per pose-optimization step")
    parser.add_argument("--lrate_relative_pose_estimation", type=float,
                        default=0.01)
    parser.add_argument("--sampling_strategy", type=str,
                        default="interest_region",
                        choices=["random", "interest_point", "interest_region"])
    parser.add_argument("--pose_n_steps", type=int, default=300,
                        help="pose optimization iterations")
    # initial pose perturbation
    parser.add_argument("--delta_psi", type=float, default=0.0)
    parser.add_argument("--delta_phi", type=float, default=0.0)
    parser.add_argument("--delta_theta", type=float, default=0.0)
    parser.add_argument("--delta_t", type=float, default=0.0)
    # observation noise
    parser.add_argument("--noise", type=str, default="None",
                        choices=["None", "gauss", "salt", "pepper", "sp",
                                 "poisson"])
    parser.add_argument("--sigma", type=float, default=0.01)
    parser.add_argument("--amount", type=float, default=0.05)
    parser.add_argument("--delta_brightness", type=float, default=0.0)
    return parser


def perturbation_matrix(delta_psi, delta_phi, delta_theta, delta_t) -> np.ndarray:
    """trans_t(dt) @ rot_phi(dphi) @ rot_theta(dth) @ rot_psi(dpsi)
    (reference demo_est_rel_pose.py:166-188, 385); angles in degrees."""
    def rot_psi(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]])

    def rot_theta(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]])

    def rot_phi(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]])

    trans = np.eye(4)
    trans[2, 3] = delta_t
    d = np.pi / 180.0
    return (trans @ rot_phi(delta_phi * d) @ rot_theta(delta_theta * d)
            @ rot_psi(delta_psi * d))


def apply_image_noise(img_u8: np.ndarray, kind: str, sigma: float = 0.01,
                      amount: float = 0.05, delta_brightness: float = 0.0,
                      seed: int = 0) -> np.ndarray:
    """Observation corruption for robustness experiments (the reference
    parses these flags but never applies them, demo_est_rel_pose.py:259-267):
    a brightness shift, then gauss / salt / pepper / sp / poisson noise from
    numpy's default_rng(seed)."""
    rng = np.random.default_rng(seed)
    img = img_u8.astype(np.float32) / 255.0
    if delta_brightness:
        img = np.clip(img + delta_brightness, 0, 1)
    if kind == "gauss":
        img = np.clip(img + rng.normal(0, sigma, img.shape), 0, 1)
    elif kind in ("salt", "pepper", "sp"):
        m = rng.random(img.shape[:2])
        if kind in ("salt", "sp"):
            img[m < amount * (0.5 if kind == "sp" else 1.0)] = 1.0
        if kind in ("pepper", "sp"):
            img[m > 1 - amount * (0.5 if kind == "sp" else 1.0)] = 0.0
    elif kind == "poisson":
        img = np.clip(rng.poisson(img * 255.0) / 255.0, 0, 1)
    return (img * 255).astype(np.uint8)


def main(argv=None):
    from nerf_shared_tpu_torch.apps.pose_estimation import (
        PoseOptConfig,
        estimate_relative_pose,
    )
    from nerf_shared_tpu_torch.apps.train import (
        _resolve_triplane_aabb,
        _sync_triplane_res,
        join_world,
        pin_fp32,
        resolve_device,
    )
    from nerf_shared_tpu_torch.parallel import distributed
    from nerf_shared_tpu_torch.config import resolve_fused_backward
    from nerf_shared_tpu_torch.data.datasets import load_datasets
    from nerf_shared_tpu_torch.factory import create_nerf_models, get_renderer, nerf_configs
    from nerf_shared_tpu_torch.utils import checkpoints as ckpt_utils

    args = extend_parser_for_pose(config_parser()).parse_args(argv)
    device = resolve_device(args.device)
    pin_fp32()
    world = join_world(args, device)
    distributed.shutdown(world)
    if not world.is_main:
        return None, None
    if world.launched:
        device = torch.device(world.device)
    ds = load_datasets(args)
    H, W, _ = ds.hwf
    # grid-family checkpoints are decoded against the box every entry point
    # derives the same way (apps/train.py)
    _resolve_triplane_aabb(args, ds, H, W)
    ccfg, fcfg = _sync_triplane_res(args, *nerf_configs(args))
    coarse, fine = create_nerf_models(args, device, cfgs=(ccfg, fcfg))
    coarse_sd, fine_sd, start = ckpt_utils.load_checkpoint(args)
    if coarse_sd is not None:
        coarse.load_state_dict(coarse_sd, strict=True)
        if fine is not None and fine_sd:
            fine.load_state_dict(fine_sd, strict=True)
    if start == 0:
        print("warning: no checkpoint found; optimizing against a random NeRF")
    rcfg = get_renderer(args, ds.bds_dict, device).cfg
    if resolve_fused_backward(args, device):
        rcfg = dataclasses.replace(rcfg, fused_backward=True)
        print("pose step: kernels B1 (forward) + B2 (backward), B5 composite "
              "(auto; --fused_backward false for the renderer's B3 route)")

    idx = int(ds.i_test[0])
    obs_img = ds.images[idx]
    sensor_image = apply_image_noise(
        (obs_img * 255).astype(np.uint8), args.noise, args.sigma,
        args.amount, args.delta_brightness)
    gt_pose = np.eye(4, dtype=np.float32)
    gt_pose[:3, :4] = ds.poses[idx][:3, :4]
    start_pose = perturbation_matrix(
        args.delta_psi, args.delta_phi, args.delta_theta, args.delta_t) @ gt_pose

    pcfg = PoseOptConfig.from_K(
        H, W, ds.K, batch_size=args.batch_size,
        lrate=args.lrate_relative_pose_estimation, n_steps=args.pose_n_steps)
    mparams = {"coarse": coarse.params()}
    if fine is not None:
        mparams["fine"] = fine.params()
    pose, history = estimate_relative_pose(
        mparams, ccfg, fcfg, rcfg, sensor_image, start_pose, ds.K, pcfg,
        obs_img_pose=gt_pose, sampling_strategy=args.sampling_strategy,
        dil_iter=args.dil_iter, kernel_size=args.kernel_size,
        seed=int(args.jax_seed))
    print("final pose:\n", pose)
    return pose, history


if __name__ == "__main__":
    main()
