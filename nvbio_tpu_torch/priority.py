"""Batched bounded priority queues (dense, fixed-capacity).

Port of ``nvbio_tpu.priority`` (the reference's in-kernel priority
containers, ``nvbio/basic/priority_queue.h``, ``priority_deque.h``, and
nvBowtie's per-read seed-hit deques): each lane keeps its items sorted
best-first in a fixed-width slot array, so ``push``/``pop_best``/``best``/
``worst`` are dense ops over the whole batch.

Keys sort DESCENDING (slot 0 = best); use negated keys for a min-queue.
Works on numpy arrays (host) or torch tensors (their device). The merge is
a stable descending argsort, so existing items win ties and equal-key
pushed items keep their column order, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

NEG_INF = -(2**30)


def _argsort_desc(keys):
    if isinstance(keys, np.ndarray):
        return np.argsort(-keys, axis=1, kind="stable")
    return torch.argsort(-keys, dim=1, stable=True)


def _take(a, idx):
    if isinstance(a, np.ndarray):
        return np.take_along_axis(a, idx, axis=1)
    return torch.gather(a, 1, idx.to(torch.int64))


def _cat(parts):
    if isinstance(parts[0], np.ndarray):
        return np.concatenate(parts, axis=1)
    return torch.cat(parts, dim=1)


@dataclasses.dataclass
class BatchPriorityQueue:
    """(B, K) keys + values, kept sorted descending by key per row."""

    keys: Any      # int32[B, K], NEG_INF marks empty slots
    values: Any    # int32[B, K]
    capacity: int

    @classmethod
    def make(cls, batch: int, capacity: int, xp=np,
             device=None) -> "BatchPriorityQueue":
        """An empty queue: numpy arrays (``xp=np``) or tensors
        (``xp=torch``) on ``device`` (cuda unless the caller asks for the
        CPU)."""
        if xp is np:
            return cls(np.full((batch, capacity), NEG_INF, np.int32),
                       np.zeros((batch, capacity), np.int32), capacity)
        from nvbio_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        return cls(
            torch.full((batch, capacity), NEG_INF, dtype=torch.int32,
                       device=dev),
            torch.zeros((batch, capacity), dtype=torch.int32, device=dev),
            capacity)

    def _as(self, x, like):
        if isinstance(like, np.ndarray):
            return np.asarray(x, like.dtype)
        return torch.as_tensor(x, device=like.device).to(like.dtype)

    def push(self, key, value, mask=None) -> "BatchPriorityQueue":
        """Insert per-lane items; when full, the worst items fall out.

        ``key``/``value`` are (B,) for one item a lane or (B, M) for an
        M-wide push (one merge + one stable sort). ``mask`` disables
        insertion per element."""
        key = self._as(key, self.keys)
        value = self._as(value, self.values)
        if key.ndim == 1:
            key = key[:, None]
            value = value[:, None]
        if mask is not None:
            if isinstance(self.keys, np.ndarray):
                mask = np.asarray(mask)
                key = np.where(mask if mask.ndim == 2 else mask[:, None],
                               key, NEG_INF).astype(key.dtype)
            else:
                mask = torch.as_tensor(mask, device=key.device)
                if mask.ndim == 1:
                    mask = mask[:, None]
                key = torch.where(mask, key, NEG_INF).to(key.dtype)
        ext_k = _cat([self.keys, key])
        ext_v = _cat([self.values, value])
        order = _argsort_desc(ext_k)[:, :self.capacity]
        return BatchPriorityQueue(_take(ext_k, order), _take(ext_v, order),
                                  self.capacity)

    def pop_best(self):
        """((key, value) of slot 0, queue without it)."""
        k0, v0 = self.keys[:, 0], self.values[:, 0]
        if isinstance(self.keys, np.ndarray):
            pad_k = np.full((self.keys.shape[0], 1), NEG_INF, self.keys.dtype)
            pad_v = np.zeros((self.values.shape[0], 1), self.values.dtype)
        else:
            pad_k = torch.full_like(self.keys[:, :1], NEG_INF)
            pad_v = torch.zeros_like(self.values[:, :1])
        q = BatchPriorityQueue(_cat([self.keys[:, 1:], pad_k]),
                               _cat([self.values[:, 1:], pad_v]),
                               self.capacity)
        return (k0, v0), q

    def best(self):
        return self.keys[:, 0], self.values[:, 0]

    def worst(self):
        """Worst *occupied* slot per lane (interval-heap 'bottom')."""
        n = self.size()
        if isinstance(self.keys, np.ndarray):
            idx = np.maximum(n - 1, 0)[:, None]
        else:
            idx = (n - 1).clamp(min=0)[:, None]
        return _take(self.keys, idx)[:, 0], _take(self.values, idx)[:, 0]

    def size(self):
        occupied = self.keys > NEG_INF
        if isinstance(occupied, np.ndarray):
            return occupied.sum(axis=1)
        return occupied.sum(dim=1)
