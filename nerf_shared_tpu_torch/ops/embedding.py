"""Sinusoidal positional encoding γ(x).

Counterpart of ``nerf_shared_tpu/ops/embedding.py`` (reference
nerf_shared/nerf.py:11-58): identity passthrough + [sin, cos] at
frequencies 2^k, k = 0..multires-1, laid out as
[x, sin(x·f0), cos(x·f0), sin(x·f1), ...]; ``i_embed == -1`` is the
identity embedding.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EmbedderConfig:
    multires: int = 10          # number of frequency octaves (N_freqs)
    i_embed: int = 0            # 0: positional encoding, -1: identity
    input_dims: int = 3
    include_input: bool = True
    log_sampling: bool = True

    @property
    def out_dim(self) -> int:
        if self.i_embed == -1:
            return self.input_dims
        d = self.input_dims
        out = d if self.include_input else 0
        return out + d * 2 * self.multires

    def freq_bands(self) -> np.ndarray:
        """Frequencies 2^k (log-sampled) or linear (reference nerf.py:27-30)."""
        if self.multires <= 0:
            return np.zeros((0,), dtype=np.float32)
        max_freq = self.multires - 1
        if self.log_sampling:
            return (2.0 ** np.linspace(0.0, max_freq, self.multires)).astype(
                np.float32)
        return np.linspace(2.0 ** 0.0, 2.0 ** max_freq, self.multires).astype(
            np.float32)


def embedder_out_dim(multires: int, i_embed: int = 0, input_dims: int = 3) -> int:
    return EmbedderConfig(
        multires=multires, i_embed=i_embed, input_dims=input_dims).out_dim


def embed(x: torch.Tensor, cfg: EmbedderConfig) -> torch.Tensor:
    """γ(x): [..., d] -> [..., out_dim] in the reference's layout."""
    if cfg.i_embed == -1:
        return x
    freqs = torch.as_tensor(cfg.freq_bands(), device=x.device, dtype=x.dtype)
    scaled = x[..., None, :] * freqs[:, None]               # [..., F, d]
    sc = torch.stack([torch.sin(scaled), torch.cos(scaled)], dim=-2)
    flat = sc.reshape(*x.shape[:-1], 2 * freqs.shape[0] * x.shape[-1])
    if cfg.include_input:
        return torch.cat([x, flat], dim=-1)
    return flat
