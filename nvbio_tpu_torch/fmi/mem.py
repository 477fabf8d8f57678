"""SMEM (supermaximal exact match) search, batched.

Port of ``nvbio_tpu.fmi.mem`` (the reference's MEM search,
``nvbio/fmindex/mem.h:81-492``): every read start position is extended at
once over a dense (B, L) plane of FM intervals of the *reversed* genome's
index (prepending symbols to the reversed pattern extends the match
rightward in the forward genome). The JAX ``lax.scan`` over the L symbol
offsets becomes a Python loop of L steps over the (B·L) plane; no step
reads a value back to the host.

Maximality uses the monotonicity of right-extension ends e(p): a suffix of
a match is a match, so e(p) is nondecreasing, and [p, e(p)) is an SMEM iff
e(p) > e(p-1). Intervals and positions are int64 (the JAX package's are
int32; the values are equal).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nvbio_tpu_torch.fmi.search import locate_core, step_backward


class SmemHits(NamedTuple):
    """Top-S SMEMs per read with up to H located genome positions each."""

    qbeg: torch.Tensor       # (B, S) read start
    qend: torch.Tensor       # (B, S) read end (exclusive)
    valid: torch.Tensor      # (B, S) bool
    tpos: torch.Tensor       # (B, S, H) int64 genome start positions
    hit_valid: torch.Tensor  # (B, S, H) bool
    n_occ: torch.Tensor      # (B, S) total occurrence count
    overflow: torch.Tensor   # (B,) SMEMs found beyond the S slots


def smem_extend_lengths(fmi_rev, reads, lens, min_intv: int = 1):
    """Right-extension data for every read position: (ext_len (B, L) =
    e(p) - p, lo (B, L), hi (B, L)), the last interval with >= ``min_intv``
    occurrences over the reversed index for the maximal match starting at
    each position (``min_intv`` > 1: the reference's
    ``find_threshold_kmems``, ``fmindex/mem.h:129-176``).

    A lane whose extension fails is frozen by negating ``hi`` (hi <= lo
    then fails the alive test for good) and restored by ``abs`` at the
    end, as the JAX package does; frozen lanes gather at (0, 0)."""
    reads = reads.to(torch.int64)
    B, L = reads.shape
    dev = reads.device
    lens = lens.to(torch.int64).to(dev)
    lo = torch.zeros((B, L), dtype=torch.int64, device=dev)
    hi = torch.full((B, L), fmi_rev.n + 1, dtype=torch.int64, device=dev)
    cnt = torch.zeros((B, L), dtype=torch.int64, device=dev)
    parange = torch.arange(L, dtype=torch.int64, device=dev)[None, :]
    for s in range(L):
        # start p consumes read[p + s]
        sym_idx = parange + s
        c = torch.gather(reads, 1, sym_idx.clamp(0, L - 1).expand(B, L))
        in_range = sym_idx < lens[:, None]
        alive = hi > lo
        nlo, nhi = step_backward(fmi_rev, c.reshape(-1),
                                 torch.where(alive, lo, 0).reshape(-1),
                                 torch.where(alive, hi, 0).reshape(-1))
        nlo = nlo.reshape(B, L)
        nhi = nhi.reshape(B, L)
        ok = in_range & alive & (nhi - nlo >= min_intv)
        lo = torch.where(ok, nlo, lo)
        hi = torch.where(ok, nhi, torch.where(alive, -hi, hi))
        cnt = cnt + ok.to(torch.int64)
    return cnt, lo, hi.abs()


def _select_and_locate(fmi_rev, ext, lo, hi, lens, min_len: int, S: int,
                       H: int) -> SmemHits:
    """The top-S maximal matches of at least ``min_len`` by length (ties by
    start, a stable descending sort with key -1 for non-matches, as
    ``jnp.argsort(-key, stable=True)``), each located at up to H rows of
    its interval; ``tpos = n - pos_rev - matchlen`` over the reversed
    genome's index."""
    B, L = ext.shape
    dev = ext.device
    lens = lens.to(torch.int64).to(dev)
    p = torch.arange(L, dtype=torch.int64, device=dev)[None, :]
    e = p + ext
    e_prev = torch.cat([torch.full((B, 1), -1, dtype=torch.int64,
                                   device=dev), e[:, :-1]], dim=1)
    is_mem = (e > e_prev) & (ext >= min_len) & (p < lens[:, None])

    overflow = (is_mem.to(torch.int64).sum(dim=1) - S).clamp(min=0)
    key = torch.where(is_mem, ext, -1)
    sel = torch.argsort(-key, dim=1, stable=True)[:, :S]
    S = sel.shape[1]   # as the JAX slice: fewer slots than S when L < S
    qbeg = torch.gather(p.expand(B, L), 1, sel)
    qend = torch.gather(e, 1, sel)
    slo = torch.gather(lo, 1, sel)
    shi = torch.gather(hi, 1, sel)
    svalid = torch.gather(is_mem, 1, sel)
    n_occ = torch.where(svalid, shi - slo, 0)

    k = torch.arange(H, dtype=torch.int64, device=dev)
    rows = (slo[:, :, None] + k[None, None, :]).clamp(0, fmi_rev.n)
    hvalid = svalid[:, :, None] & (k[None, None, :] < n_occ[:, :, None])
    pos_rev, _ = locate_core(fmi_rev, rows.reshape(-1))
    pos_rev = pos_rev.reshape(B, S, H)
    matchlen = (qend - qbeg)[:, :, None]
    tpos = torch.where(hvalid, fmi_rev.n - pos_rev - matchlen, 0)
    return SmemHits(qbeg, qend, svalid, tpos, hvalid, n_occ, overflow)


def find_threshold_kmems_batch(fmi_rev, reads, lens, min_len: int = 19,
                               min_intv: int = 2, max_mems: int = 16,
                               hits_per_mem: int = 4) -> SmemHits:
    """Threshold k-MEMs: maximal matches kept only while their occurrence
    count stays >= ``min_intv`` (``fmindex/mem.h:129-176``). Same result
    contract as ``find_smems_batch``."""
    ext, lo, hi = smem_extend_lengths(fmi_rev, reads, lens,
                                      min_intv=min_intv)
    return _select_and_locate(fmi_rev, ext, lo, hi, lens, min_len,
                              max_mems, hits_per_mem)


def find_smems_batch(fmi_rev, reads, lens, min_len: int = 19,
                     max_smems: int = 16,
                     hits_per_smem: int = 4) -> SmemHits:
    """SMEMs >= ``min_len`` for each read, up to H located hits each.

    ``fmi_rev`` is the FM index of the REVERSED genome; the returned
    ``tpos`` are starts in the FORWARD genome."""
    ext, lo, hi = smem_extend_lengths(fmi_rev, reads, lens)
    return _select_and_locate(fmi_rev, ext, lo, hi, lens, min_len,
                              max_smems, hits_per_smem)
