"""A torch twin of the reference's per-row sampling noise.

The reference draws row b's noise at position p as
``jax.random.gumbel(jax.random.fold_in(jax.random.PRNGKey(seed_b), p),
(n,), float32)``.  With ``jax_threefry_partitionable`` on (the default
since jax 0.5) that is, bit for bit:

  * ``PRNGKey(seed)``: the key (0, seed as uint32);
  * ``fold_in(key, p)``: threefry2x32(key, (0, p)), both output words;
  * the bits of element i: the two output words of
    threefry2x32(key', (0, i)), xor-ed (``_threefry_random_bits_
    partitionable`` with a 64-bit iota split into hi and lo words);
  * uniform on [tiny, 1): the top 23 bits as the mantissa of a float in
    [1, 2), minus 1, scaled by (1 - tiny) and shifted by tiny, clamped
    below at tiny;
  * gumbel: ``-log(-log(u))``.

The hash runs in int64 holding uint32 values, masked to 32 bits after
every step: torch has no uint32 arithmetic on every backend.  Everything
is vectorised over rows and stays on the seeds' device; the bits equal
jax's exactly and the noise agrees to the last ulp of ``log``.
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
TINY = float(np.finfo(np.float32).tiny)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """An integer tensor's low 32 bits as int64 in [0, 2**32)."""
    return x.to(torch.int64) & M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counts (x1, x2) under the
    key (k1, k2); all int64 tensors of uint32 values, broadcast."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = (((x2 << r) | (x2 >> (32 - r))) & M32) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x1, x2


def fold_in(seeds: torch.Tensor, data: torch.Tensor):
    """``fold_in(PRNGKey(seed), data)`` per row: (B,) ints -> the key
    words (k1, k2), each (B,) int64."""
    zero = torch.zeros_like(seeds, dtype=torch.int64)
    return threefry2x32(zero, _u32(seeds), zero, _u32(data))


def random_bits(k1: torch.Tensor, k2: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits per element: (B,) keys -> (B, n) int64."""
    count = torch.arange(n, dtype=torch.int64, device=k1.device)
    b1, b2 = threefry2x32(k1[:, None], k2[:, None],
                          torch.zeros_like(count), count)
    return b1 ^ b2


def uniform(bits: torch.Tensor, minval: float, maxval: float):
    """Bits -> float32 uniform on [minval, maxval), as jax maps them."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp(floats * span + lo, min=lo)


def gumbel(seeds: torch.Tensor, pos: torch.Tensor, n: int) -> torch.Tensor:
    """(B,) seeds x (B,) positions -> (B, n) float32 Gumbel noise, the
    reference's ``gumbel(fold_in(PRNGKey(seed), pos), (n,), float32)``."""
    k1, k2 = fold_in(seeds, pos)
    u = uniform(random_bits(k1, k2, n), TINY, 1.0)
    return -torch.log(-torch.log(u))
