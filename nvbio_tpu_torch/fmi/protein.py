"""Protein/IUPAC FM index: a wavelet-tree BWT for alphabets beyond 2 bits.

Port of ``nvbio_tpu.fmi.protein``: the 4-symbol rank rows (``fmi/rank.py``)
give way to per-level wavelet rank (``wavelet.rank``): O(bits) gathers and
popcounts an occurrence query, batched. Supports PROTEIN (24 symbols, 5
bits) and DNA_IUPAC (16 symbols, 4 bits).

The build is host work (suffix array, BWT, wavelet tree) and returns host
tensors; ``.to(device)`` moves the index, and the search runs as tensor
ops on the index's device. Intervals are int64. Where the text length is
a multiple of 32 the counts are right, and the JAX package's are not
(``wavelet.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nvbio_tpu_torch.wavelet import WaveletTree, build_wavelet_tree
from nvbio_tpu_torch.wavelet import rank as wt_rank


@dataclasses.dataclass
class ProteinFMIndex:
    wt: WaveletTree        # wavelet tree of the sentinel-removed BWT
    count: torch.Tensor    # int64[n_symbols + 1]: C[c] = 1 + #symbols < c
    primary: int           # sentinel row in the virtual full BWT
    n: int
    n_symbols: int

    def to(self, device) -> "ProteinFMIndex":
        return ProteinFMIndex(self.wt.to(device), self.count.to(device),
                              self.primary, self.n, self.n_symbols)

    @property
    def device(self) -> torch.device:
        return self.count.device


def build_protein_fmindex(codes: np.ndarray,
                          n_symbols: int = 24) -> ProteinFMIndex:
    """Host build: suffix array -> BWT -> wavelet tree + C counts."""
    from nvbio_tpu_torch.fmi.index import bwt_from_sa
    from nvbio_tpu_torch.index.sa import suffix_array

    codes = np.asarray(codes, np.uint8)
    bits = max(1, int(np.ceil(np.log2(max(n_symbols, 2)))))
    sa = suffix_array(codes)
    bwt, primary = bwt_from_sa(codes, sa)
    wt = build_wavelet_tree(bwt, bits)
    counts = np.bincount(codes, minlength=n_symbols)
    count = np.zeros(n_symbols + 1, np.int64)
    count[1:] = np.cumsum(counts)
    count += 1  # the virtual sentinel sorts first
    count[0] = 1
    return ProteinFMIndex(wt=wt, count=torch.from_numpy(count),
                          primary=int(primary), n=len(codes),
                          n_symbols=n_symbols)


def _occ(pfmi: ProteinFMIndex, c, i):
    adj = i - (i > pfmi.primary).to(i.dtype)
    return wt_rank(pfmi.wt, c, adj)


def protein_backward_search_core(pfmi: ProteinFMIndex, queries, qlens):
    """Exact-match SA intervals [lo, hi) for protein queries (B, L)
    left-aligned, as int64 tensors on the index's device."""
    dev = pfmi.device
    queries = torch.as_tensor(queries, device=dev).to(torch.int64)
    qlens = torch.as_tensor(qlens, device=dev).to(torch.int64)
    B, L = queries.shape
    lo = torch.zeros((B,), dtype=torch.int64, device=dev)
    hi = torch.full((B,), pfmi.n + 1, dtype=torch.int64, device=dev)
    nc = pfmi.count.shape[0]
    for s in range(L):
        j = (qlens - 1 - s).clamp(0, L - 1)
        c = torch.gather(queries, 1, j[:, None])[:, 0]
        cnt = pfmi.count[c.clamp(0, nc - 1)]
        r = _occ(pfmi, c, torch.stack([lo, hi]))
        active = (s < qlens) & (hi > lo)
        lo = torch.where(active, cnt + r[0], lo)
        hi = torch.where(active, cnt + r[1], hi)
    return lo, hi


def protein_backward_search(pfmi, queries, qlens):
    return protein_backward_search_core(pfmi, queries, qlens)


def protein_count(pfmi, queries, qlens):
    """Occurrence counts of protein queries in the indexed text."""
    lo, hi = protein_backward_search(pfmi, queries, qlens)
    return (hi - lo).clamp(min=0)
