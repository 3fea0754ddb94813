"""Stateless index permutation for without-replacement pixel draws.

Counterpart of ``nerf_shared_tpu/ops/permute.py``: a 4-round unbalanced
Feistel network over the index bits, with cycle-walking for domains that
are not a power of two. ``permute_index(key, i, n)`` is an exact bijection
on [0, n), computed per index with no stored permutation. The single-image
sampler takes the first N_rand entries of a fresh permutation each step (an
ordered N-subset without replacement); the batching sampler's exact-epoch
mode walks one permutation per epoch.

The JAX version works in uint32. Here every value is a uint32 held in an
int64 tensor and masked with 0xFFFFFFFF after each operation; products of
two 32-bit words are split in 16-bit halves so no intermediate leaves the
int64 range. Given the same key words the result is the JAX permutation bit
for bit (tests/test_torch_train.py).
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def _mul32(v: torch.Tensor, c: int) -> torch.Tensor:
    """(v * c) mod 2^32 for uint32 values v and a uint32 constant c."""
    return (v * (c & 0xFFFF) + (((v * (c >> 16)) & 0xFFFF) << 16)) & M32


def _mix(v: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """murmur-style integer hash."""
    v = _mul32(v ^ k, 0x85EBCA6B)
    v = _mul32(v ^ (v >> 13), 0xC2B2AE35)
    return v ^ (v >> 16)


def round_keys(key: torch.Tensor, rounds: int) -> torch.Tensor:
    """Per-round keys from the key's uint32 words (all of them folded)."""
    flat = key.reshape(-1).long() & M32
    base = flat[0]
    for w in range(1, flat.shape[0]):
        base = _mix(base, flat[w])
    idx = torch.arange(rounds, dtype=torch.int64, device=key.device)
    return ((base + (idx + 1) * 0x9E3779B9) & M32) | 1


def _feistel(x: torch.Tensor, lo_bits: int, hi_bits: int,
             keys: torch.Tensor) -> torch.Tensor:
    """Unbalanced Feistel permutation over [0, 2^(lo_bits + hi_bits))."""
    lo_mask, hi_mask = (1 << lo_bits) - 1, (1 << hi_bits) - 1
    hi, lo = (x >> lo_bits) & hi_mask, x & lo_mask
    for r in range(0, keys.shape[0], 2):
        hi = (hi ^ _mix(lo, keys[r])) & hi_mask
        lo = (lo ^ _mix(hi, keys[r + 1])) & lo_mask
    return ((hi << lo_bits) | lo) & ((1 << (lo_bits + hi_bits)) - 1)


def permute_index(key: torch.Tensor, i: torch.Tensor, n: int,
                  rounds: int = 4) -> torch.Tensor:
    """Bijective map of indices ``i`` (ints in [0, n)) to a pseudorandom
    permutation of [0, n) keyed by ``key`` (uint32 words as integers).

    Cycle-walking: permute within the covering power of two (< 2n) and
    re-apply to any value that lands outside [0, n) until none does; the
    check runs on the host, so callers keep ``i`` on the CPU."""
    if n < 1:
        raise ValueError(f"permute_index: n must be >= 1, got {n}")
    if rounds % 2:
        raise ValueError("permute_index: rounds must be even")
    if n == 1:
        return torch.zeros_like(i, dtype=torch.int64)
    bits = (n - 1).bit_length()
    lo_bits = bits // 2
    keys = round_keys(key.to(i.device), rounds)
    x = _feistel(i.long() & M32, lo_bits, bits - lo_bits, keys)
    while True:
        out = x >= n
        if not bool(out.any()):
            return x
        x = torch.where(out, _feistel(x, lo_bits, bits - lo_bits, keys), x)
