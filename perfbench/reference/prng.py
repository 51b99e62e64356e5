"""The murmur3 counter PRNG of the fused MAPPO collection, in plain torch.

Every draw is a pure function of (seed, step, row, env, salt): uint32
arithmetic, held here in int64 tensors.  The uniforms are the program's bit
for bit; the normals are worked out from them in the caller's dtype.
"""

from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32, the product split into 16-bit halves."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + ((hi * (c & 0xFFFF)) << 16)) & M32


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """The murmur3 finalizer."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def uniform01(seed: int, step: int, envs: torch.Tensor, rows: int, salt: int) -> torch.Tensor:
    """Uniforms in (0, 1], float32 [rows, B], keyed by (seed, step, row,
    env index, salt)."""
    row = torch.arange(rows, dtype=torch.int64, device=envs.device)[:, None]
    key = ((seed & M32) * 2654435761 & M32) ^ ((step & M32) * 0x9E3779B9 & M32)
    ctr = mul32((row + salt * 131) & M32, 0x27D4EB2F) ^ key
    bits = hash_u32((ctr + envs.to(torch.int64)[None, :]) & M32)
    return 1.0 - (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def normal(seed: int, step: int, envs: torch.Tensor, rows: int, salt: int, dtype) -> torch.Tensor:
    """Standard normals [rows, B] in ``dtype``: Box-Muller over the
    uniforms of ``salt`` and ``salt + 7``."""
    u1 = uniform01(seed, step, envs, rows, salt).to(dtype)
    u2 = uniform01(seed, step, envs, rows, salt + 7).to(dtype)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
