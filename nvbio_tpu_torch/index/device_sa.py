"""Suffix sorting and FM-index construction on the card: prefix doubling
over ``torch.sort``.

Port of ``nvbio_tpu.index.device_sa`` (the reference's device suffix
sorters, ``nvbio/sufsort/sufsort.h:86-302``), in torch idiom:

- the text crosses the host link as 2-bit words (n/4 bytes) and is
  unpacked on the device into the 1-based plane ``c1p`` (symbols 1..4, then
  zeros: the sentinel and the slack of the bootstrap keys);
- round 0 sorts every suffix by its first 26 symbols at once: the two
  base-5 13-symbol keys of the JAX package fit one int64 key
  (k1 * 5^13 + k2 < 5^26 < 2^63), so one stable ``torch.sort`` with the
  positions as payload replaces its 2-key ``lax.sort``;
- ranks are group starts (each group's first sorted row, spread over the
  group by a ``cumsum`` of the group-start mask: the JAX package's
  ``cummax`` is a slow generic scan in torch on CUDA), so a tied group
  splits without renumbering any other;
- doubling rounds run over the tied rows alone, compacted exactly
  (``nonzero``) and compacted again after every round: each round sorts
  (group rank, rank of the suffix k further on, -1 past the end so short
  suffixes sort first) and scatters the new group starts, until every rank
  is unique (or k reaches 2m, the JAX loop's guard).

The JAX package's capacity ladder, ``top_k`` compaction, host tie path and
full-plane fallback serve static shapes on a TPU; torch's shapes are
dynamic, so none is needed. The suffix array is unique, so every route
gives the same output.

``build_fmindex_device`` then derives every table of ``fmi.index.FMIndex``
from the SA on the same device (the BWT plane with the primary row dropped,
the sampled-SA planes, the 2-bit packing, the 64-symbol checkpoints, the
rank and SSA rows); only the compact tables leave it, when the caller
saves. Positions are int64 tensors; texts stay below 2^31 symbols (int32
tables), as in the JAX package.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from nvbio_tpu_torch import packed
from nvbio_tpu_torch.device import resolve_device

_B5 = 13                    # symbols per base-5 key of the JAX package
_PAD = 1 + 2 * _B5 + 1      # zeros after the text: sentinel + key slack


class _Clock:
    """Seconds of each stage into ``stats`` (a dict), the device
    synchronized at each stage's end; no-op when ``stats`` is None."""

    def __init__(self, stats: dict | None, dev: torch.device):
        self.stats, self.dev = stats, dev
        self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        if self.stats is None:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        now = time.perf_counter()
        self.stats[name] = now - self.t
        self.t = now


def prefer_device_sa(n: int, device) -> bool:
    """True for a cuda device and texts of 2^22 symbols or more, where the
    card's sort clearly beats one host core's SA-IS (the JAX package's rule
    for an accelerator, ``device_sa.py:175-184``)."""
    return torch.device(device).type == "cuda" and n >= (1 << 22)


def text_plane(codes: np.ndarray, device) -> torch.Tensor:
    """The 1-based padded text plane (uint8 on ``device``): symbols + 1,
    then ``_PAD`` zeros. The text crosses the link as 2-bit words."""
    codes = np.asarray(codes, np.uint8)
    words = packed.words_to_tensor(packed.pack(codes, 2), device)
    shifts = 2 * torch.arange(16, dtype=torch.int32, device=words.device)
    syms = ((words[:, None] >> shifts) & 3).reshape(-1)[:len(codes)]
    return plane_of(syms.to(torch.uint8))


def plane_of(text: torch.Tensor) -> torch.Tensor:
    """The text plane of a uint8 tensor of 2-bit codes, on its device."""
    return torch.cat([text + 1, torch.zeros(_PAD, dtype=torch.uint8,
                                            device=text.device)])


def _group_starts(sorted_keys: torch.Tensor, rows: torch.Tensor):
    """(group-start row of each sorted entry, tied mask) for sorted keys:
    a group is a run of equal keys, its start the ``rows`` value of its
    first entry; tied = member of a group of two or more."""
    return _run_starts(_runs(sorted_keys), rows)


def _runs(*sorted_keys: torch.Tensor) -> torch.Tensor:
    """True at the first entry of each run of equal key tuples."""
    new = torch.zeros_like(sorted_keys[0], dtype=torch.bool)
    new[:1] = True
    for k in sorted_keys:
        new[1:] |= k[1:] != k[:-1]
    return new


def _run_starts(new: torch.Tensor, rows: torch.Tensor):
    """``_group_starts`` of runs marked by ``new`` (True at each run's
    first entry)."""
    first = rows[torch.nonzero(new).squeeze(1)]
    start = first[torch.cumsum(new, dim=0) - 1]
    run_end = torch.ones_like(new)
    run_end[:-1] = new[1:]
    return start, ~(new & run_end)


def _bootstrap(c1p: torch.Tensor, m: int):
    """Round 0: every suffix sorted by its first 26 symbols. Returns (sa,
    group-start rank in sorted order, tied mask in sorted order)."""
    key = torch.zeros(m, dtype=torch.int64, device=c1p.device)
    for j in range(2 * _B5):
        key.mul_(5).add_(c1p[j:j + m])
    sk, sa = torch.sort(key, stable=True)
    del key
    rows = torch.arange(m, dtype=torch.int64, device=c1p.device)
    rank_sorted, tied = _group_starts(sk, rows)
    return sa, rank_sorted, tied


def _resolve_ties(sa, rank_sorted, tied, m: int):
    """Doubling rounds over the tied rows until every rank is unique.
    Updates ``sa`` in place; returns (tied rows after round 0, rounds)."""
    rows = torch.nonzero(tied).squeeze(1)         # ascending sorted rows
    n_tied = rows.numel()
    rounds = 0
    if n_tied == 0:
        return n_tied, rounds
    rank = torch.empty(m, dtype=torch.int64, device=sa.device)
    rank[sa] = rank_sorted
    pos, grank = sa[rows], rank_sorted[rows]
    k = 2 * _B5
    while rows.numel() and k < 2 * m:
        nxt = pos + k
        second = torch.where(nxt < m, rank[nxt.clamp(max=m - 1)], -1)
        ks, order = torch.sort(grank * (m + 1) + (second + 1), stable=True)
        pos = pos[order]
        # slot t of a group's run is still global sorted row rows[t]
        g, still = _group_starts(ks, rows)
        rank[pos] = g
        sa[rows] = pos
        rows, pos, grank = rows[still], pos[still], g[still]
        k *= 2
        rounds += 1
    return n_tied, rounds


def _suffix_array(c1p: torch.Tensor, m: int, stats: dict | None = None,
                  clock: _Clock | None = None) -> torch.Tensor:
    """SA (int64 on ``c1p``'s device) of the m = n + 1 suffixes of T$."""
    sa, rank_sorted, tied = _bootstrap(c1p, m)
    if clock is not None:
        clock("bootstrap_s")
    n_tied, rounds = _resolve_ties(sa, rank_sorted, tied, m)
    if stats is not None:
        stats.update(tied_rows=n_tied, rounds=rounds)
    if clock is not None:
        clock("tie_s")
    return sa


def suffix_array_device(codes: np.ndarray, device=None) -> np.ndarray:
    """SA of text + sentinel (n+1 entries, sa[0] == n, int64), sorted on
    ``device`` (cuda unless the caller asks for the CPU). Equal to
    ``index.sa.suffix_array``."""
    dev = resolve_device(device)
    return _suffix_array(text_plane(codes, dev), len(codes) + 1).cpu().numpy()


def _bwt_plane(c1p: torch.Tensor, sa: torch.Tensor, n: int):
    """(BWT symbols uint8[n] with the primary row dropped, primary row)."""
    primary = int(torch.nonzero(sa == 0)[0, 0])
    bwt_full = c1p[(sa - 1).clamp(min=0)] - 1
    return torch.cat([bwt_full[:primary], bwt_full[primary + 1:n + 1]]), \
        primary


def bwt_device(codes: np.ndarray, device=None):
    """(bwt uint8[n] with the sentinel row removed, primary row), as
    ``fmi.index.bwt_from_sa``; SA and BWT computed on ``device``, only the
    BWT fetched."""
    dev = resolve_device(device)
    c1p = text_plane(codes, dev)
    bwt, primary = _bwt_plane(c1p, _suffix_array(c1p, len(codes) + 1),
                              len(codes))
    return bwt.cpu().numpy(), primary


def _int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as int32 tensors holding the uint32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _ssa_planes(sa: torch.Tensor, interval: int):
    """(marks int32 bits, exclusive popcount prefix, sampled values) of the
    sampled SA: rows with SA % interval == 0, bit i of word w = row 32w+i."""
    m = sa.shape[0]
    marked = (sa % interval) == 0
    vals = sa[marked].to(torch.int32)
    n_words = (m + 31) // 32
    bits = torch.zeros(n_words * 32, dtype=torch.int64, device=sa.device)
    bits[:m] = marked
    bits = bits.view(n_words, 32)
    weights = torch.arange(32, dtype=torch.int64, device=sa.device)
    marks = _int32_bits((bits << weights).sum(dim=1))
    popc = bits.sum(dim=1)
    cum = torch.zeros(n_words, dtype=torch.int64, device=sa.device)
    cum[1:] = torch.cumsum(popc[:-1], dim=0)
    return marks, cum.to(torch.int32), vals


def _pack_occ(bwt: torch.Tensor, n: int):
    """(packed BWT words int32 bits, LSB-first 16 a word; checkpoints
    int32[ceil(n/64) + 1, 4]; count int64[5]). Padding counts as symbol 0
    in the checkpoints (the inflated final one is kept for parity with the
    host builder)."""
    from nvbio_tpu_torch.fmi.rank import K

    dev = bwt.device
    nw = (n + 15) // 16
    padded = torch.zeros(nw * 16, dtype=torch.int64, device=dev)
    padded[:n] = bwt
    shifts = 2 * torch.arange(16, dtype=torch.int64, device=dev)
    words = _int32_bits((padded.view(nw, 16) << shifts).sum(dim=1))
    nb = (n + K - 1) // K
    pb = torch.zeros(nb * K, dtype=torch.uint8, device=dev)
    pb[:n] = bwt
    pb = pb.view(nb, K)
    # (4, nb): each symbol's block counts summed along the innermost dim
    # (a scan over the outer dim of (nb, 4) is a slow kernel in torch)
    per_block = torch.stack([(pb == c).sum(dim=1) for c in range(4)])
    occ = torch.zeros((nb + 1, 4), dtype=torch.int64, device=dev)
    occ[1:] = torch.cumsum(per_block, dim=1).t()
    counts = torch.stack([(bwt == c).sum() for c in range(4)])
    count = torch.ones(5, dtype=torch.int64, device=dev)
    count[1:] += torch.cumsum(counts, dim=0)
    return words, occ.to(torch.int32), count


def fm_tables(c1p: torch.Tensor, sa: torch.Tensor, n: int,
              sa_interval: int, clock: _Clock | None = None):
    """The complete ``FMIndex`` of the text of ``c1p`` from its SA, every
    table built on their device."""
    from nvbio_tpu_torch.fmi.index import FMIndex
    from nvbio_tpu_torch.fmi.rank import rank_rows_tensor, ssa_rows_tensor

    bwt, primary = _bwt_plane(c1p, sa, n)
    marks, cum, vals = _ssa_planes(sa, sa_interval)
    words, occ, count = _pack_occ(bwt, n)
    del bwt
    if clock is not None:
        clock("planes_s")
    index = FMIndex(
        bwt_words=words, occ=occ, count=count, primary=primary, n=n,
        sa_interval=sa_interval, ssa_marks=marks, ssa_cum=cum,
        ssa_vals=vals, rank_rows=rank_rows_tensor(words, n, occ),
        ssa_rows=ssa_rows_tensor(marks, cum))
    if clock is not None:
        clock("rows_s")
    return index


def build_fmindex_device(codes: np.ndarray, sa_interval: int = 8,
                         device=None, stats: dict | None = None):
    """A complete FM index of 2-bit ``codes`` built on ``device`` (cuda
    unless the caller asks for the CPU): the same tables as
    ``fmi.index.build_fmindex``, as tensors on that device. With a
    ``stats`` dict, each stage's seconds (``upload_s``, ``bootstrap_s``,
    ``tie_s``, ``planes_s``, ``rows_s``; the device synchronized at each
    stage's end), the rows still tied after the bootstrap (``tied_rows``)
    and the doubling ``rounds`` are written into it."""
    dev = resolve_device(device)
    codes = np.asarray(codes, dtype=np.uint8)
    n = len(codes)
    if n >= 2**31 - 1:
        raise ValueError("text too long for int32 FM-index")
    clock = _Clock(stats, dev)
    c1p = text_plane(codes, dev)
    clock("upload_s")
    sa = _suffix_array(c1p, n + 1, stats, clock)
    return fm_tables(c1p, sa, n, sa_interval, clock)
