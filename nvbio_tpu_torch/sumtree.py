"""Weighted sampling over per-read hit priorities (the SumTree), torch.

Port of ``nvbio_tpu.sumtree`` (the reference's ``SumTree``,
``nvbio/basic/sum_tree.h:42-104``): a batched CDF and a count of the CDF
entries at or below each target. The CDF is a float32 prefix sum over the
(small) weight axis taken column by column, left to right: that is the
order the JAX package's ``cumsum`` sums in on the CPU, and a fixed order
gives the same bits on every device (``torch.cumsum`` on CUDA promises
none).
"""

from __future__ import annotations

import torch

from nvbio_tpu_torch import threefry


def _cdf(w: torch.Tensor) -> torch.Tensor:
    """Left-to-right float32 prefix sums of (B, S) ``w`` along S."""
    cols = [w[:, 0]]
    for j in range(1, w.shape[1]):
        cols.append(cols[-1] + w[:, j])
    return torch.stack(cols, dim=1)


def sample(weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """An index per row drawn proportionally to ``weights`` (B, S) by the
    uniforms ``u`` (B,), int64 (B,). A row of zero weight gives the last
    index, as the JAX package's does (every CDF entry is <= a target of
    0)."""
    return sample_columns(weights, u[:, None])[:, 0]


def sample_many(weights: torch.Tensor, key: tuple[int, int],
                n: int) -> torch.Tensor:
    """``n`` indices per row, with replacement: (B, n) int64, the uniforms
    of ``jax.random.uniform(key, (B, n))``."""
    u = threefry.uniform(key, (weights.shape[0], n), weights.device)
    return sample_columns(weights, u)


def sample_columns(weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``sample`` of each column of the uniforms ``u`` (B, n) against the
    same (B, S) weights: (B, n) int64 (the JAX package's ``vmap`` of
    ``sample`` over draws)."""
    w = weights.to(torch.float32).clamp(min=0.0)
    cdf = _cdf(w)
    target = u.to(torch.float32) * cdf[:, -1:]                 # (B, n)
    idx = (cdf[:, None, :] <= target[:, :, None]).sum(dim=2)
    return idx.clamp(0, weights.shape[1] - 1)


def add(weights: torch.Tensor, idx: torch.Tensor, delta) -> torch.Tensor:
    """Adjust one leaf per row (the reference's ``SumTree::add``); returns
    a new tensor."""
    out = weights.clone()
    rows = torch.arange(weights.shape[0], device=weights.device)
    out[rows, idx] += delta
    return out
