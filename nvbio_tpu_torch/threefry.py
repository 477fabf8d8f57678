"""Threefry-2x32 counter-based random bits, bit-equal to ``jax.random``.

The JAX package's randomized hit selection draws with three calls of
``jax.random`` under its default ``threefry_partitionable`` mode:
``PRNGKey(seed)``, ``fold_in(key, data)`` and ``uniform(key, shape)``
(``jax/_src/prng.py``: ``threefry_seed``, ``threefry_fold_in``,
``_threefry_random_bits_partitionable``; ``jax/_src/random.py``:
``_uniform``). This module computes the same bits with torch:

- a key is a pair of 32-bit words; ``prng_key(s)`` is (0, s mod 2^32),
  as JAX makes it from a Python int without 64-bit mode;
- ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``;
- ``uniform(key, shape)`` hashes each element's row-major flat index,
  split into a high and a low 32-bit counter, keeps ``x0 ^ x1`` of the
  hash, and maps the top 23 bits into [1, 2) before subtracting 1.

torch has no uint32 arithmetic on the CPU and ``>>`` on int32 is
arithmetic, so every word is an int64 tensor masked to 32 bits. Keys are
Python ints; the counters and results live on the caller's device and give
the same bits there as on the CPU.
"""

from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` (JAX's default 32-bit mode: the seed's
    low 32 bits, high word 0)."""
    return 0, seed & _M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(key: tuple[int, int], x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counter pairs (x0, x1), int64
    tensors holding uint32 values; returns the two hashed words."""
    k0, k1 = key[0] & _M32, key[1] & _M32
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, data)`` for a 32-bit ``data``."""
    a, b = threefry2x32(key, torch.zeros(1, dtype=torch.int64),
                        torch.full((1,), data & _M32, dtype=torch.int64))
    return int(a), int(b)


def uniform(key: tuple[int, int], shape, device) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32, [0, 1), on
    ``device``: 32 bits per element (the hash of its flat index, high
    word ^ low), the top 23 as the mantissa of a float in [1, 2)."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    a, b = threefry2x32(key, idx >> 32, idx & _M32)
    bits = (((a ^ b) >> 9) | 0x3F800000).reshape(shape)
    return bits.to(torch.int32).view(torch.float32) - 1.0
