"""Bloom filters (plain + byte-per-bit), batched build/query.

Port of ``nvbio_tpu.bloom`` (``nvbio/basic/bloom_filter.h:56-254``: K-hash
filters with double hashing). ``BloomFilter`` is the packed-bit filter,
built on the host (numpy, copied) and queried with numpy arrays or torch
tensors; ``ByteBloomFilter`` is the byte-per-bit filter for insertion on
the device (an index fill of a uint8 tensor), packed 8:1 by ``pack()``.

Hashing: the JAX package's 32-bit mixers. Torch has no uint32 arithmetic,
so on tensors the words are int64 holding the uint32 value, masked to 32
bits after every multiply and add: a product of two 32-bit values may
wrap past int64 into a negative value, but its low 32 bits are the uint32
product, and a right shift then only ever sees the masked, non-negative
value.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

M32 = 0xFFFFFFFF


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a constant c < 2^32
    (the int64 product wraps in two's complement; its low 32 bits do
    not change)."""
    return (x * c) & M32


def _mix32(x, c1, c2):
    if isinstance(x, torch.Tensor):
        x = x.to(torch.int64) & M32
        x = mul32(x ^ (x >> 16), c1)
        x = mul32(x ^ (x >> 13), c2)
        return x ^ (x >> 16)
    x = np.asarray(x).astype(np.uint32)
    x = (x ^ (x >> 16)) * np.uint32(c1)
    x = (x ^ (x >> 13)) * np.uint32(c2)
    return x ^ (x >> 16)


def hash1(x):
    """The first 32-bit mixer: uint32 for numpy input, int64 holding the
    uint32 value for a tensor."""
    return _mix32(x, 0x85EBCA6B, 0xC2B2AE35)


def hash2(x):
    """The second mixer, forced odd (a full cycle for double hashing)."""
    return _mix32(x, 0x27D4EB2F, 0x165667B1) | 1


def bit_positions(keys, k: int, n_bits: int):
    """(..., k) filter positions (h1 + i*h2) mod 2^32 mod n_bits: uint32
    for numpy keys, int64 for a tensor."""
    h1 = hash1(keys)
    h2 = hash2(keys)
    if isinstance(h1, torch.Tensor):
        i = torch.arange(k, dtype=torch.int64, device=h1.device)
        return ((h1[..., None] + i * h2[..., None]) & M32) % n_bits
    i = np.arange(k, dtype=np.uint32)
    return (h1[..., None] + i * h2[..., None]) % np.uint32(n_bits)


@dataclasses.dataclass
class BloomFilter:
    """Packed-bit Bloom filter: build on host, query anywhere (batched)."""

    words: Any   # uint32[n_words] bitmap (numpy), or int64 words on a device
    n_bits: int
    k: int = 4   # number of hash probes

    @classmethod
    def empty(cls, n_bits: int, k: int = 4) -> "BloomFilter":
        n_bits = max(64, int(n_bits))
        return cls(np.zeros((n_bits + 31) // 32, dtype=np.uint32), n_bits, k)

    def _bit_positions(self, keys):
        return bit_positions(keys, self.k, self.n_bits)

    def insert(self, keys: np.ndarray) -> None:
        """Host-side batched insert."""
        pos = self._bit_positions(np.asarray(keys, dtype=np.uint32)).ravel()
        np.bitwise_or.at(
            self.words, pos // 32, np.uint32(1) << (pos % 32).astype(np.uint32)
        )

    def contains(self, keys):
        """Batched membership test (numpy keys, or a tensor of keys)."""
        if isinstance(keys, torch.Tensor):
            words = self.to(keys.device).words
            pos = self._bit_positions(keys)
            w = words[pos // 32]
            return (((w >> (pos % 32)) & 1) == 1).all(dim=-1)
        pos = self._bit_positions(keys.astype(np.uint32))
        w = np.take(self.words, (pos // 32).astype(np.int32))
        bits = (w >> (pos % 32)) & 1
        return np.all(bits == 1, axis=-1)

    def to(self, device) -> "BloomFilter":
        """The filter with its words as an int64 tensor on ``device``."""
        w = self.words
        if not isinstance(w, torch.Tensor):
            w = torch.from_numpy(np.asarray(w, np.uint32).astype(np.int64))
        return BloomFilter(w.to(device), self.n_bits, self.k)

    def merge(self, other: "BloomFilter") -> "BloomFilter":
        """OR-merge two filters (the reference merges per-GPU filters)."""
        return BloomFilter(self.words | other.words, self.n_bits, self.k)


@dataclasses.dataclass
class ByteBloomFilter:
    """Byte-per-bit filter for insertion on the device."""

    bytes_: torch.Tensor  # uint8[n_bits]
    n_bits: int
    k: int = 4

    @classmethod
    def empty(cls, n_bits: int, k: int = 4, device=None):
        """An empty filter on ``device`` (cuda unless the caller asks for
        the CPU)."""
        from nvbio_tpu_torch.device import resolve_device

        n_bits = max(64, int(n_bits))
        return cls(torch.zeros(n_bits, dtype=torch.uint8,
                               device=resolve_device(device)), n_bits, k)

    def _pos(self, keys):
        return bit_positions(keys, self.k, self.n_bits)

    def insert(self, keys) -> "ByteBloomFilter":
        """Batched insert into a copy (returns the updated filter)."""
        return ByteBloomFilter(self.bytes_.clone(), self.n_bits,
                               self.k).insert_(keys)

    def insert_(self, keys) -> "ByteBloomFilter":
        """Batched insert in place: one index fill."""
        self.bytes_.index_fill_(0, self._pos(keys).reshape(-1), 1)
        return self

    def contains(self, keys):
        return (self.bytes_[self._pos(keys)] == 1).all(dim=-1)

    def pack(self) -> BloomFilter:
        """Convert to the 8:1 packed-bit filter (host)."""
        by = self.bytes_.cpu().numpy().astype(np.uint32)
        pad = (-len(by)) % 32
        by = np.pad(by, (0, pad))
        words = np.bitwise_or.reduce(
            by.reshape(-1, 32) << np.arange(32, dtype=np.uint32), axis=1
        ).astype(np.uint32)
        return BloomFilter(words, self.n_bits, self.k)
