"""FM-index container, host construction, artifacts and the k-mer table.

Port of ``nvbio_tpu.fmi.index``: the packed BWT with occurrence
checkpoints, the C counts, the primary row (the removed-sentinel trick) and
a mark-bitvector sampled suffix array (at most ``sa_interval`` LF steps per
locate). The port adds the two gather layouts its search reads
(``fmi.rank``): the interleaved rank rows and the SSA rows.

SA-row conventions (as the JAX package's): rows index the suffixes of T$
(n+1 rows, row 0 = "$"), ``primary`` is the row whose suffix is the whole
text (SA[primary] = 0); the stored BWT has the sentinel removed (length n).
Tables are int32 tensors (uint32 bits for the packed words and marks).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nvbio_tpu_torch.fmi.rank import (
    build_occ_table,
    build_rank_rows,
    build_ssa_rows,
)
from nvbio_tpu_torch.fmi.search import step_backward


def _t(a, dtype=np.int32) -> torch.Tensor:
    """A host tensor of its own (a copy) from a numpy array; uint32 words
    keep their bits as int32."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, dtype=dtype))


@dataclasses.dataclass
class FMIndex:
    bwt_words: torch.Tensor   # int32 bits of uint32[ceil(n/16)]: the BWT
    occ: torch.Tensor         # int32[n_blocks+1, 4]: checkpoints every 64
    count: torch.Tensor       # int64[5]: C[c] = 1 + #symbols < c
    primary: int              # row of the sentinel in the full BWT
    n: int                    # text length
    sa_interval: int          # SA[i] stored where SA[i] % sa_interval == 0
    ssa_marks: torch.Tensor   # int32 bits of uint32[ceil((n+1)/32)]
    ssa_cum: torch.Tensor     # int32[n_words]: exclusive popcount of marks
    ssa_vals: torch.Tensor    # int32[n_samples]: sampled SA values
    rank_rows: torch.Tensor   # int32[n//64 + 2, 8]: fmi.rank's rows
    ssa_rows: torch.Tensor    # int32[n_words, 2]: (marks word, cum)
    # optional k-mer interval table (``attach_ftab``): SA intervals of all
    # 4^k patterns, so a backward search starts k symbols in
    ftab_k: int = 0
    ftab_lo: torch.Tensor | None = None   # int32[4^k]
    ftab_hi: torch.Tensor | None = None   # int32[4^k]

    @property
    def device(self) -> torch.device:
        return self.rank_rows.device

    def nbytes(self) -> int:
        """Bytes of every table held."""
        return sum(t.numel() * t.element_size()
                   for t in dataclasses.astuple(self)
                   if isinstance(t, torch.Tensor))

    def to(self, device) -> "FMIndex":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    def without_ftab(self) -> "FMIndex":
        return dataclasses.replace(self, ftab_k=0, ftab_lo=None,
                                   ftab_hi=None)

    @classmethod
    def from_arrays(cls, bwt_words, occ, count, primary: int, n: int,
                    sa_interval: int, ssa_marks, ssa_cum, ssa_vals,
                    ftab_k: int = 0, ftab_lo=None, ftab_hi=None) -> "FMIndex":
        """Host tensors from the JAX package's numpy fields, with the rank
        and SSA rows built."""
        bwt_words = np.asarray(bwt_words, np.uint32)
        occ = np.asarray(occ, np.int32)
        return cls(
            bwt_words=_t(bwt_words), occ=_t(occ),
            count=_t(count, np.int64), primary=int(primary), n=int(n),
            sa_interval=int(sa_interval), ssa_marks=_t(ssa_marks),
            ssa_cum=_t(ssa_cum), ssa_vals=_t(ssa_vals),
            rank_rows=torch.from_numpy(
                build_rank_rows(bwt_words, int(n), occ)),
            ssa_rows=torch.from_numpy(
                build_ssa_rows(ssa_marks, ssa_cum)),
            ftab_k=int(ftab_k) if ftab_lo is not None else 0,
            ftab_lo=None if ftab_lo is None else _t(ftab_lo),
            ftab_hi=None if ftab_hi is None else _t(ftab_hi))

    def arrays(self) -> dict:
        """The compact tables of the JAX package's ``.fmi.npz``, key for
        key, fetched to the host as numpy arrays (the rank and SSA rows
        stay where they are)."""
        def u32(t):
            return t.cpu().numpy().view(np.uint32)

        return dict(
            bwt_words=u32(self.bwt_words),
            occ=self.occ.cpu().numpy(),
            count=self.count.cpu().numpy().astype(np.int32),
            primary=self.primary,
            n=self.n,
            sa_interval=self.sa_interval,
            ssa_marks=u32(self.ssa_marks),
            ssa_cum=self.ssa_cum.cpu().numpy(),
            ssa_vals=self.ssa_vals.cpu().numpy(),
        )

    def save(self, path: str) -> None:
        """The JAX package's ``.fmi.npz``, key for key."""
        np.savez_compressed(path, **self.arrays())

    @classmethod
    def load(cls, path: str) -> "FMIndex":
        """Read a ``.fmi.npz`` (either package's), as host tensors."""
        z = np.load(path)
        return cls.from_arrays(
            z["bwt_words"], z["occ"], z["count"], int(z["primary"]),
            int(z["n"]), int(z["sa_interval"]), z["ssa_marks"],
            z["ssa_cum"], z["ssa_vals"])


def attach_ftab(fmi: FMIndex, k: int = 11) -> FMIndex:
    """Fill the k-mer interval table on the index's device: all 4^k
    patterns backward-searched at once (each lane's key is its own query,
    symbol j in bits [2j, 2j+2), consumed low to high as backward search
    consumes a pattern right to left, so the leftmost symbol sits in the
    high bits). Empty intervals become (0, 0). Memory: 2 * 4^k int32
    (k = 11: 33.5 MB)."""
    fmi = fmi.without_ftab()
    keys = torch.arange(4 ** k, dtype=torch.int64, device=fmi.device)
    lo = torch.zeros_like(keys)
    hi = torch.full_like(keys, fmi.n + 1)
    for j in range(k):
        nlo, nhi = step_backward(fmi, (keys >> (2 * j)) & 3, lo, hi)
        live = hi > lo
        lo = torch.where(live, nlo, lo)
        hi = torch.where(live, nhi, hi)
    ok = hi > lo
    return dataclasses.replace(
        fmi, ftab_k=k, ftab_lo=torch.where(ok, lo, 0).to(torch.int32),
        ftab_hi=torch.where(ok, hi, 0).to(torch.int32))


def bwt_from_sa(text_codes: np.ndarray, sa: np.ndarray):
    """(bwt_codes with $ removed, primary row) from the SA of T$
    (``sa`` has n+1 entries, sa[0] == n; BWT[r] = T[sa[r] - 1])."""
    n = len(text_codes)
    assert len(sa) == n + 1
    primary = int(np.nonzero(sa == 0)[0][0])
    bwt_full = text_codes[np.clip(sa - 1, 0, n - 1)]
    return np.delete(bwt_full, primary).astype(np.uint8), primary


def build_fmindex(text_codes: np.ndarray, sa: np.ndarray | None = None,
                  sa_interval: int = 8, method: str = "auto",
                  device=None) -> FMIndex:
    """A complete FM-index of 2-bit text codes, built on the host (host
    tensors; ``.to(device)`` moves it). ``sa`` is built with
    ``index.sa.suffix_array(method=...)`` when not given; ``method="device"``
    builds the whole index on ``device`` instead
    (``index.device_sa.build_fmindex_device``, cuda unless the caller asks
    for the CPU) and returns it there."""
    from nvbio_tpu_torch import packed
    from nvbio_tpu_torch.index.sa import suffix_array

    if sa is None and method == "device":
        from nvbio_tpu_torch.index.device_sa import build_fmindex_device

        return build_fmindex_device(text_codes, sa_interval, device)
    text_codes = np.asarray(text_codes, dtype=np.uint8)
    n = len(text_codes)
    if n >= 2**31 - 1:
        raise ValueError("text too long for int32 FM-index (shard it)")
    if sa is None:
        sa = suffix_array(text_codes, method=method)
    sa = np.asarray(sa, np.int64)
    bwt, primary = bwt_from_sa(text_codes, sa)
    bwt_words = packed.pack(bwt, 2)
    occ = build_occ_table(bwt_words, n)

    count = np.zeros(5, dtype=np.int64)
    count[1:] = np.cumsum(np.bincount(text_codes, minlength=4)[:4])
    count += 1  # the $ row

    # sampled SA: mark rows whose SA value % sa_interval == 0
    n_words = (n + 1 + 31) // 32
    marked = np.zeros(n_words * 32, dtype=bool)
    marked[:n + 1] = sa % sa_interval == 0
    rows = np.nonzero(marked)[0]
    # bit i of word w marks row 32w + i (little-endian bytes of the word)
    marks = np.packbits(marked, bitorder="little").view("<u4").astype(
        np.uint32)
    popc = marked.reshape(n_words, 32).sum(axis=1, dtype=np.int64)
    cum = np.zeros(n_words, dtype=np.int64)
    np.cumsum(popc[:-1], out=cum[1:])
    return FMIndex.from_arrays(bwt_words, occ, count, primary, n,
                               sa_interval, marks, cum.astype(np.int32),
                               sa[rows].astype(np.int32))


def fmindex_from_bwt(bwt_codes: np.ndarray, primary: int,
                     sa_interval: int = 8, device=None):
    """A complete FM index rebuilt from a BWT alone (the nvSSA job,
    ``nvSSA/nvSSA.cpp:42-119``; ``nvbio_tpu.fmi.index.fmindex_from_bwt``)
    as torch ops on ``device`` (cuda unless the caller asks for the CPU):
    LF over the full BWT (the sentinel at row ``primary`` maps to row 0),
    the SA by Wyllie list ranking over LF (SA[i] = hops from row i to the
    primary row: ceil(log2(n+1)) rounds of r += r[nxt], nxt = nxt[nxt]),
    the text from the F column, then every table on that device."""
    from nvbio_tpu_torch.device import resolve_device
    from nvbio_tpu_torch.index.device_sa import fm_tables, plane_of

    dev = resolve_device(device)
    bwt = torch.from_numpy(np.asarray(bwt_codes, np.uint8).copy()).to(dev)
    n = bwt.shape[0]
    n_rows = n + 1
    counts = torch.stack([(bwt == c).sum() for c in range(4)])
    count = torch.ones(5, dtype=torch.int64, device=dev)
    count[1:] += torch.cumsum(counts, dim=0)
    full = torch.cat([bwt[:primary].to(torch.int8),
                      torch.full((1,), -1, dtype=torch.int8, device=dev),
                      bwt[primary:].to(torch.int8)])
    lf = torch.zeros(n_rows, dtype=torch.int64, device=dev)
    for c in range(4):
        hit = full == c
        before = torch.cumsum(hit, dim=0) - hit.to(torch.int64)
        lf[hit] = count[c] + before[hit]
    lf[primary] = 0
    nxt = lf
    nxt[primary] = primary
    r = torch.ones(n_rows, dtype=torch.int64, device=dev)
    r[primary] = 0
    for _ in range(max(1, int(np.ceil(np.log2(n_rows))))):
        r = r + r[nxt]
        nxt = nxt[nxt]
    sa = r
    rows = torch.arange(1, n_rows, dtype=torch.int64, device=dev)
    text = torch.empty(n, dtype=torch.uint8, device=dev)
    text[sa[1:]] = torch.searchsorted(count[1:], rows, right=True).to(
        torch.uint8)
    return fm_tables(plane_of(text), sa, n, sa_interval)
