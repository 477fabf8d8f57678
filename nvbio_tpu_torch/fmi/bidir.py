"""Bidirectional FM-index extension (2BWT).

Port of ``nvbio_tpu.fmi.bidir`` (the reference's
``nvbio/fmindex/bidir.h:50-93``): a pattern P is tracked as a pair of
synchronized SA intervals, [lo, hi) over the forward index and [rlo, rhi)
over the reversed-text index, so it can be extended by one symbol on
either end without restarting the search.

Batched: the intervals are int64 tensors of any matching shape on the
indexes' device; ``c`` (a symbol or a tensor) broadcasts against them.
"""

from __future__ import annotations

import torch

from nvbio_tpu_torch.fmi.search import extend_backward_all


def _extend(fmi_from, lo, hi, rlo, c):
    """Shared core: extend on fmi_from's side, re-anchor the twin interval."""
    lo, hi, rlo = (torch.as_tensor(x, device=fmi_from.device).to(torch.int64)
                   for x in (lo, hi, rlo))
    lo4, hi4 = extend_backward_all(fmi_from, lo, hi)      # (..., 4)
    sizes = (hi4 - lo4).clamp(min=0)
    c = torch.as_tensor(c, device=lo.device).to(torch.int64).expand(lo.shape)
    new_lo = torch.gather(lo4, -1, c[..., None])[..., 0]
    new_hi = torch.gather(hi4, -1, c[..., None])[..., 0]
    # twin offset: occurrences in [lo, hi) extending with a symbol < c, plus
    # the sentinel row (which sorts before every symbol) if it is in range
    sym = torch.arange(4, dtype=torch.int64, device=lo.device)
    less = torch.where(sym < c[..., None], sizes, 0).sum(dim=-1)
    sentinel = ((lo <= fmi_from.primary) & (fmi_from.primary < hi)).to(
        torch.int64)
    new_rlo = rlo + less + sentinel
    new_rhi = new_rlo + (new_hi - new_lo)
    return new_lo, new_hi, new_rlo, new_rhi


def extend_backward(fmi_fwd, fmi_rev, lo, hi, rlo, rhi, c):
    """P -> cP: returns the new (lo, hi, rlo, rhi) interval pair."""
    del rhi  # implied by interval-size equality
    return _extend(fmi_fwd, lo, hi, rlo, c)


def extend_forward(fmi_fwd, fmi_rev, lo, hi, rlo, rhi, c):
    """P -> Pc: symmetric — extend on the reversed index, re-anchor fwd."""
    rlo2, rhi2, lo2, hi2 = _extend(fmi_rev, rlo, rhi, lo, c)
    return lo2, hi2, rlo2, rhi2


def init_interval(fmi_fwd, shape=()):
    """The empty-pattern interval pair covering the whole index, on the
    index's device."""
    z = torch.zeros(shape, dtype=torch.int64, device=fmi_fwd.device)
    full = torch.full(shape, fmi_fwd.n + 1, dtype=torch.int64,
                      device=fmi_fwd.device)  # n+1 rows incl. sentinel
    return z, full, z, full
