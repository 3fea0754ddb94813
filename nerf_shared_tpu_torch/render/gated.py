"""Coarse-gated fast rendering: skip the fine pass for empty rays.

Counterpart of ``nerf_shared_tpu/render/gated.py``. Most rays of an
object-centric frame never hit anything: their coarse opacity is ~0 and
their fine pass is N_importance network evaluations of empty space. The
render splits ``render_rays`` into two stages around a compaction:

  1. the coarse stage over all rays (unchanged math);
  2. rays with coarse acc >= ``threshold`` are compacted on the device,
     fine-resampled and rendered in power-of-two blocks, and scattered back;
  3. skipped rays keep their coarse result (for acc < threshold, the
     background to within the threshold).

An opt-in approximation, exact at threshold 0. The stages evaluate the
network on sample points (``_apply_model``: kernel B1 under ``use_pallas``)
and composite through ``_composite`` (kernel B5). The host fetches one
number, the active count, which sizes the fine stage; the ordering, gathers
and scatters stay on the device. The win needs a model that learned
transparency in empty space; a model that explains a white background with
white density keeps every ray active.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from nerf_shared_tpu_torch.ops.sampling import sample_along_rays, sample_pdf
from nerf_shared_tpu_torch.render.renderer import (
    RenderConfig,
    _apply_model,
    _composite,
    _model_parts,
    split_rays,
)


def _cat(outs):
    return {k: torch.cat([o[k] for o in outs], dim=0) for k in outs[0]}


def coarse_stage(params_coarse, ccfg, rays, rcfg: RenderConfig, block: int,
                 generator: Optional[torch.Generator] = None):
    """Coarse sampling + network + composite for all rays, in blocks of
    ``block``; returns per-ray coarse maps plus the weights / z_vals the
    fine stage needs."""
    outs = []
    for i in range(0, rays.shape[0], block):
        rb = rays[i:i + block]
        rays_o, rays_d, viewdirs = split_rays(rb)
        z_vals = sample_along_rays(
            rb[:, 6:7], rb[:, 7:8], rcfg.N_samples, lindisp=rcfg.lindisp,
            perturb=rcfg.perturb, generator=generator).contiguous()
        pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
        raw = _apply_model(params_coarse, ccfg, pts, viewdirs, rcfg)
        rgb, disp, acc, weights, _ = _composite(raw, z_vals, rays_d, rcfg,
                                                generator=generator)
        outs.append({"rgb0": rgb, "disp0": disp, "acc0": acc,
                     "weights": weights, "z_vals": z_vals})
    return _cat(outs)


def fine_stage(params_fine, fcfg, rays, weights, z_vals, rcfg: RenderConfig,
               block: int, generator: Optional[torch.Generator] = None):
    """Hierarchical resample + fine network + composite on the compacted
    rays, in blocks of ``block``."""
    outs = []
    for i in range(0, rays.shape[0], block):
        rb, w, z = rays[i:i + block], weights[i:i + block], z_vals[i:i + block]
        rays_o, rays_d, viewdirs = split_rays(rb)
        z_mid = 0.5 * (z[..., 1:] + z[..., :-1])
        z_samples = sample_pdf(z_mid, w[..., 1:-1], rcfg.N_importance,
                               det=(rcfg.perturb == 0.0),
                               generator=generator).detach()
        z_all = torch.sort(torch.cat([z, z_samples], -1), -1).values.contiguous()
        pts = rays_o[..., None, :] + rays_d[..., None, :] * z_all[..., :, None]
        raw = _apply_model(params_fine, fcfg, pts, viewdirs, rcfg)
        rgb, disp, acc, _, _ = _composite(raw, z_all, rays_d, rcfg,
                                          generator=generator)
        outs.append({"rgb_map": rgb, "disp_map": disp, "acc_map": acc,
                     "z_std": torch.std(z_samples, dim=-1, correction=0)})
    return _cat(outs)


def pow2_blocks(n_active: int, n: int, chunk: int, order: torch.Tensor):
    """(block, idx): the compacted stage's block size, the next power of two
    of ``n_active`` capped at ``chunk`` (so varying active counts give a
    handful of shapes and predictable launch counts), and the ray indices it
    renders: ``order``'s first n_active padded to whole blocks by
    repeating its last entry."""
    block = min(chunk, 1 << max(0, (n_active - 1).bit_length()))
    n_pad = -(-n_active // block) * block
    if n_pad <= n:
        return block, order[:n_pad]
    return block, torch.cat([order, order[-1:].expand(n_pad - n)])


def render_flat_rays_gated(
    rays_flat: torch.Tensor,
    coarse_model,
    fine_model,
    rcfg: RenderConfig,
    ccfg,
    fcfg,
    chunk: int = 1024 * 32,
    generator: Optional[torch.Generator] = None,
    threshold: float = 1e-3,
) -> Dict[str, torch.Tensor]:
    """Gated render of a flat ray batch; the keys of render_rays (no
    retraw / retweights) plus ``active_fraction`` (a float).
    threshold 0 renders every ray finely."""
    pc, _ = _model_parts(coarse_model)
    pf, fcfg_m = _model_parts(fine_model)
    fcfg = fcfg if fcfg is not None else (fcfg_m if fcfg_m is not None else ccfg)
    pf = pc if pf is None else pf

    n = rays_flat.shape[0]
    cres = coarse_stage(pc, ccfg, rays_flat, rcfg, min(chunk, n), generator)
    if rcfg.N_importance <= 0:
        return {"rgb_map": cres["rgb0"], "disp_map": cres["disp0"],
                "acc_map": cres["acc0"]}

    mask = cres["acc0"] >= threshold
    order = torch.argsort((~mask).to(torch.int8), stable=True)  # active first
    n_active = int(mask.sum())  # the one host fetch
    out = {
        "rgb_map": cres["rgb0"], "disp_map": cres["disp0"],
        "acc_map": cres["acc0"], "rgb0": cres["rgb0"],
        "disp0": cres["disp0"], "acc0": cres["acc0"],
        "z_std": torch.zeros_like(cres["acc0"]),
        "active_fraction": n_active / max(n, 1),
    }
    if n_active == 0:
        return out

    block, idx = pow2_blocks(n_active, n, chunk, order)
    fres = fine_stage(pf, fcfg, rays_flat[idx], cres["weights"][idx],
                      cres["z_vals"][idx], rcfg, block, generator)
    scatter = order[:n_active]
    for k in ("rgb_map", "disp_map", "acc_map", "z_std"):
        out[k] = out[k].index_put((scatter,), fres[k][:n_active])
    return out
