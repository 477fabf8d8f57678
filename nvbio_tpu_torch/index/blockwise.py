"""Blockwise single-string BWT past int32 positions, on the card.

Port of ``nvbio_tpu.index.blockwise`` (the reference's blockwise suffix
sorting, ``nvbio/sufsort/sufsort.h:45-60``, ``blockwise_sufsort.h``): the
BWT of a text of up to 2^32 - 16 symbols (a whole human genome, past the
int32 FM index of ``index.device_sa``) is built as a sequence of suffix
blocks sized for the card that arrive in global suffix order, so the
output is their concatenation and no merge is needed.

The decomposition is the JAX package's:

1. **Upload**: the text crosses the link once, chunk by chunk as uint8
   codes, and is packed on the card into 2-bit words; a plane of int64
   "pair words" (word i and word i+1) gives any 13-symbol window from one
   gather.
2. **Counting**: every suffix's first 13 symbols as one base-5 key ``k1``
   (0 past the end); the histogram of ``k1 >> 18`` over a strided sample
   (the JAX package's sample, keyed on the card rather than by numpy on
   the host: 5.8 s of host gathers at 100 Mbp) and ``_pick_thresholds``
   (numpy) choose SUPERBLOCK key ranges, so equal-``k1`` suffixes never
   straddle two.
3. **Extraction**: each chunk's suffixes are sorted ONCE by the packed key
   ``k1 << 32 | pos`` (5^13 * 2^32 < 2^63; 8 bytes a suffix stay on the
   card: 20 GB at 2.5 Gbp), and one ``searchsorted`` per chunk finds every
   threshold; a superblock concatenates its key range of every chunk and
   sorts it. (The JAX builder extracts and sorts every chunk again for each
   superblock; the output does not depend on it.)
4. **Blocks**: contiguous slices of the sorted superblock, cut at
   ``k1``-group boundaries; each is sorted by its first 26 symbols as one
   int64 base-5 key (``k1 * 5^13`` + the next 13 symbols' key).
5. **Ties**: at most ``host_tie_cap`` tied rows go to the host comparator
   (``_host_tie_order``); otherwise deepening by 26 symbols a round, over
   the whole block (two stable sorts: by the 26-symbol key, then by group)
   while more than ``tie_cap`` rows are tied, then over the tied rows alone
   (compacted with ``nonzero`` each round); after ``max_deepen`` rounds the
   host comparator orders what is left.
6. **Emission**: each block's BWT symbols ``text[pos - 1]`` are read from
   the packed text on the card and fetched as uint8 (the primary row,
   ``pos == 0``, carries 0), straight into their place in the output
   (the primary row left out), or to ``emit``.

Positions are int64 throughout (the JAX package's uint32 positions and
their 0xFFFFFFFF sentinel have no counterpart: the planes hold exactly the
filled rows). Group starts come from ``nonzero`` + ``cumsum``
(``device_sa._run_starts``), never ``cummax``.

Defaults are sized for an 80 GB card: ``chunk`` 2^28 positions (a 2 GB key
sort), ``sb_cap`` 2^29 suffixes (4.3 GB of keys), ``blk`` 2^27 suffixes (~10
GB of block planes at the peak), ``tie_cap`` 2^22; at 2.5 Gbp the sorted
chunk keys (20 GB) dominate. Every plane is sized from ``min(knob, what the
text needs)``. The output does not depend on the knobs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from nvbio_tpu_torch.device import resolve_device
from nvbio_tpu_torch.index.device_sa import (
    _group_starts,
    _int32_bits,
    _run_starts,
    _runs,
)

_B5 = 13                      # symbols per base-5 key
_KMAX = 2**31 - 1             # last superblock threshold
_HIST_SHIFT = 18              # superblock threshold granularity (k1 >> 18)
_HIST_BINS = (5**_B5 >> _HIST_SHIFT) + 2
_MASK32 = 0xFFFFFFFF


def _pick_thresholds(hist: np.ndarray, sb_cap: int):
    """Superblock key thresholds from the (sampled, scaled) histogram:
    greedy fill to ~86% of capacity (sampling slack)."""
    target = int(sb_cap * 0.86)
    bounds = [0]
    acc = 0
    for b, cnt in enumerate(hist):
        if acc + cnt > target and acc > 0:
            bounds.append(b << _HIST_SHIFT)
            acc = 0
        acc += int(cnt)
    bounds.append(_KMAX)
    return bounds


def _host_tie_order(codes: np.ndarray, pos: np.ndarray, grank: np.ndarray,
                    start: int = 2 * _B5, chunk: int = 4096) -> np.ndarray:
    """Order tied suffix positions by direct comparison on the host (a copy
    of ``nvbio_tpu.index.device_sa._host_tie_order`` that reads the 2-bit
    ``codes`` and adds 1 window by window instead of holding a 1-based copy
    of the text).

    ``pos``/``grank``: the tied rows' suffix positions and group ids (equal
    grank = one tied group, first ``start`` symbols known equal). Returns
    ``pos`` reordered so each group is in true suffix order (groups stay in
    place)."""
    n = len(codes)
    out = pos.copy()
    for g in np.unique(grank):
        sel = np.nonzero(grank == g)[0]
        p = pos[sel]
        key_list = [[] for _ in range(len(p))]
        off = start
        # one window of symbols a round until the group's suffixes differ;
        # the zero padding makes a shorter suffix sort first
        while True:
            for t in range(len(p)):
                s = min(int(p[t]) + off, n)
                key_list[t].append((codes[s:s + chunk] + 1).tobytes())
            joined = [b"".join(k).ljust(off - start + chunk, b"\0")
                      for k in key_list]
            if len(set(joined)) == len(p) or off > n:
                srt = sorted(range(len(p)),
                             key=lambda t: (joined[t], -int(p[t])))
                out[sel] = p[srt]
                break
            off += chunk
    return out


class _Text:
    """The text on the card as int64 pair words: ``pw[i]`` holds symbols
    16i .. 16i+31 (2 bits each, LSB first), zeros past the end."""

    def __init__(self, codes: np.ndarray, dev: torch.device, chunk: int):
        n = len(codes)
        self.n = n
        nw = (n + 15) // 16
        words = torch.zeros(nw + 1, dtype=torch.int32, device=dev)
        shifts = 2 * torch.arange(16, dtype=torch.int64, device=dev)
        for a in range(0, n, chunk):       # chunk is a multiple of 16
            seg = torch.from_numpy(codes[a:a + chunk]).to(dev)
            pad = torch.zeros((len(seg) + 15) // 16 * 16, dtype=torch.int64,
                              device=dev)
            pad[:len(seg)] = seg
            w = (pad.view(-1, 16) << shifts).sum(dim=1)
            words[a // 16:a // 16 + len(w)] = _int32_bits(w)
        self.pw = (words[:-1].to(torch.int64) & _MASK32) \
            + words[1:].to(torch.int64) * (1 << 32)
        # T4[b]: base-5 value of the 4 symbols of byte b, symbols + 1, the
        # first (lowest bits) most significant; POW5[k] = 5^k
        b = torch.arange(256, dtype=torch.int64)
        t4 = torch.zeros(256, dtype=torch.int64)
        for i in range(4):
            t4 = t4 * 5 + ((b >> (2 * i)) & 3) + 1
        self.t4 = t4.to(dev)
        self.pow5 = torch.tensor([5**k for k in range(_B5 + 1)],
                                 dtype=torch.int64, device=dev)

    def window(self, p: torch.Tensor) -> torch.Tensor:
        """2-bit symbols of positions p, p+1, ... (at least 17) in the low
        bits of int64 values."""
        wi = (p >> 4).clamp(max=self.pw.shape[0] - 1)
        return self.pw[wi] >> (2 * (p & 15))

    def key13(self, p: torch.Tensor) -> torch.Tensor:
        """Base-5 key of the 13 symbols at positions p (int64) onwards,
        symbols + 1, 0 past the end."""
        x = self.window(p)
        t4 = self.t4
        key = (t4[x & 255] * 5**9 + t4[(x >> 8) & 255] * 5**5
               + t4[(x >> 16) & 255] * 5 + ((x >> 24) & 3) + 1)
        # symbols past the end read 0: keep the first lim digits
        lim = (self.n - p).clamp(0, _B5)
        scale = self.pow5[_B5 - lim]
        return key // scale * scale

    def key26(self, p: torch.Tensor) -> torch.Tensor:
        return self.key13(p) * 5**_B5 + self.key13(p + _B5)

    def symbol(self, p: torch.Tensor) -> torch.Tensor:
        """Symbol (0..3) at positions p < n."""
        return self.window(p) & 3


def _sorted_by(keys, payload_key):
    """Stable order by ``keys``, then stable by ``payload_key``: the
    permutation sorting (payload_key, keys) lexicographically."""
    _, o1 = torch.sort(keys, stable=True)
    _, o2 = torch.sort(payload_key[o1], stable=True)
    return o1[o2]


def blockwise_bwt(codes, *, chunk: int = 1 << 28, sb_cap: int = 1 << 29,
                  blk: int = 1 << 27, tie_cap: int = 1 << 22,
                  max_deepen: int = 200, host_tie_cap: int = 4096,
                  log=None, emit=None, device=None):
    """Single-string BWT of ``codes`` (uint8 0..3, any length < 2^32 - 16)
    built blockwise on ``device`` (cuda unless the caller asks for the
    CPU).

    Returns ``(bwt, primary, stats)`` where ``bwt`` is the n-symbol plane
    with the primary row removed (``fmi.index.bwt_from_sa`` contract) —
    unless ``emit`` is given, in which case each block's symbols (primary
    row INCLUDED, as row ``stats['primary']`` of the global n+1-row
    stream) are passed to ``emit(np.uint8 array)`` in order and ``bwt``
    is None. ``stats`` carries the decomposition (``superblocks``,
    ``blocks``, ``sb_sizes``, ``primary``), the tie work (``deepen_rounds``,
    ``host_tie_small``, ``host_tie_fallbacks``) and each phase's seconds.
    """
    dev = resolve_device(device)
    t_all = time.perf_counter()
    stats = {"host_tie_small": 0, "host_tie_fallbacks": 0}

    def _log(msg):
        if log:
            log(msg)

    def _sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    codes = np.ascontiguousarray(codes, np.uint8)
    n = len(codes)
    if not 0 < n < 2**32 - 16:
        raise ValueError("blockwise_bwt takes texts of 1 to 2^32 - 17 "
                         "symbols")
    total = n + 1                      # suffixes incl. the empty one
    chunk = max(16, min(chunk, ((total + 15) // 16) * 16))
    if chunk % 16:
        chunk += 16 - chunk % 16

    # ---- upload: the text crosses once, packed on the card -----------------
    t0 = time.perf_counter()
    text = _Text(codes, dev, chunk)
    _sync()
    stats["upload_s"] = time.perf_counter() - t0
    stats["upload_mb"] = n / 2**20       # uint8 codes; packed on the card

    # ---- sampled counting: superblock thresholds ---------------------------
    t0 = time.perf_counter()
    stride = max(1, total >> 24)
    sample = torch.arange(0, total, stride, dtype=torch.int64, device=dev)
    hist = torch.bincount(text.key13(sample) >> _HIST_SHIFT,
                          minlength=_HIST_BINS).cpu().numpy() * stride
    del sample
    sb_cap = min(sb_cap, total + 16)   # right-size for small texts
    bounds = _pick_thresholds(hist, sb_cap)
    stats["counting_s"] = time.perf_counter() - t0
    stats["superblocks"] = len(bounds) - 1
    _log(f"counting done (sampled): {len(bounds) - 1} superblocks")

    # ---- extraction: each chunk sorted once by k1 << 32 | pos --------------
    t0 = time.perf_counter()
    thresholds = torch.tensor(bounds, dtype=torch.int64, device=dev) << 32
    chunks, chunk_bounds = [], []
    for s in range(0, total, chunk):
        pos = torch.arange(s, min(s + chunk, total), dtype=torch.int64,
                           device=dev)
        keys = torch.sort((text.key13(pos) << 32) | pos).values
        del pos
        chunks.append(keys)
        chunk_bounds.append(torch.searchsorted(keys, thresholds).cpu())
    t_extract = time.perf_counter() - t0

    slack = min(1 << 20, blk)          # block-cut pull-back allowance
    t_sbsort = t_block = t_deepen = t_emit = 0.0
    deepen_rounds = n_blocks = 0
    sb_sizes = []
    rows_emitted, primary_row = 0, -1
    # without emit, each block lands in place in the output, the primary
    # row left out
    bwt = None if emit is not None else np.empty(n, np.uint8)

    for si in range(len(bounds) - 1):
        t0 = time.perf_counter()
        parts = [c[int(b[si]):int(b[si + 1])]
                 for c, b in zip(chunks, chunk_bounds)]
        sb_count = sum(len(p) for p in parts)
        if sb_count > sb_cap:
            raise ValueError(f"superblock {si} overflow (> {sb_cap}); "
                             "raise sb_cap or lower the histogram target")
        sb_sizes.append(sb_count)
        if sb_count == 0:
            continue
        sbk = torch.cat(parts)
        del parts
        _sync()
        t_extract += time.perf_counter() - t0
        t0 = time.perf_counter()
        sbk = torch.sort(sbk).values
        _sync()
        t_sbsort += time.perf_counter() - t0

        # block cuts at k1-group boundaries (progressively widened fetch
        # windows; the pull-back is bounded by the slack)
        cuts = [0]
        while cuts[-1] + blk < sb_count:
            cut0 = cuts[-1] + blk
            lo_lim = max(cuts[-1] + 1, cut0 - slack)
            win = 1 << 12
            while True:
                lo_w = max(cut0 - win, lo_lim)
                k1_win = (sbk[lo_w - 1:cut0 + 1] >> 32).cpu().numpy()
                bnd = np.nonzero(k1_win[1:] != k1_win[:-1])[0]
                if len(bnd):
                    cuts.append(lo_w + int(bnd[-1]))
                    break
                if lo_w == lo_lim:
                    raise ValueError(
                        "single k1 group exceeds the block-cut slack "
                        "(pathological repeat); raise blk")
                win *= 16
        cuts.append(sb_count)

        for bi in range(len(cuts) - 1):
            start, end = cuts[bi], cuts[bi + 1]
            count = end - start
            n_blocks += 1
            t0 = time.perf_counter()
            bk = sbk[start:end]
            pos = bk & _MASK32
            k26 = (bk >> 32) * 5**_B5 + text.key13(pos + _B5)
            k26, order = torch.sort(k26, stable=True)
            pos = pos[order]
            del order
            rows = torch.arange(count, dtype=torch.int64, device=dev)
            grank, tied = _group_starts(k26, rows)
            del k26
            nt = int(tied.sum())
            t_block += time.perf_counter() - t0

            # ---- tie deepening -------------------------------------------
            t0 = time.perf_counter()
            d = 2 * _B5
            rounds = 0
            trows = grp = None
            if 0 < nt <= host_tie_cap:
                # a few collisions: order them by direct host comparison
                trows = torch.nonzero(tied).squeeze(1)
                new_pos = _host_tie_order(codes, pos[trows].cpu().numpy(),
                                          grank[trows].cpu().numpy(),
                                          start=d)
                pos[trows] = torch.from_numpy(new_pos).to(dev)
                stats["host_tie_small"] += nt
                nt = 0
                trows = None
            while nt > tie_cap and rounds < max_deepen:
                # full plane: 26 more symbols, sorted within the groups
                kd = text.key26(pos + d)
                o = _sorted_by(kd, grank)
                pos, grank, kd = pos[o], grank[o], kd[o]
                grank, tied = _run_starts(_runs(grank, kd), rows)
                del o, kd
                nt = int(tied.sum())
                d += 2 * _B5
                rounds += 1
            if 0 < nt <= tie_cap:
                trows = torch.nonzero(tied).squeeze(1)
                grp = grank[trows]
                while nt > 0 and rounds < max_deepen:
                    pt = pos[trows]
                    kd = text.key26(pt + d)
                    o = _sorted_by(kd, grp)
                    pt, kd, gs = pt[o], kd[o], grp[o]
                    # slot t of the sorted list is still block row trows[t]
                    g_new, still = _run_starts(_runs(gs, kd), trows)
                    pos[trows] = pt
                    trows, grp = trows[still], g_new[still]
                    nt = trows.numel()
                    d += 2 * _B5
                    rounds += 1
            if nt > 0:
                # pathological LCP (round cap hit): the host comparator
                # orders the remaining tied groups
                if trows is None:
                    trows = torch.nonzero(tied).squeeze(1)
                    grp = grank[trows]
                new_pos = _host_tie_order(codes, pos[trows].cpu().numpy(),
                                          grp.cpu().numpy(), start=d)
                pos[trows] = torch.from_numpy(new_pos).to(dev)
                stats["host_tie_fallbacks"] += nt
            del grank, tied, trows, grp
            deepen_rounds += rounds
            _sync()
            t_deepen += time.perf_counter() - t0

            # ---- emission -------------------------------------------------
            t0 = time.perf_counter()
            is_primary = pos == 0
            sym = torch.where(is_primary, 0,
                              text.symbol((pos - 1).clamp(min=0)))
            prim = torch.nonzero(is_primary).squeeze(1).cpu()
            sym = sym.to(torch.uint8)
            del pos, is_primary
            at = rows_emitted - (primary_row >= 0)   # output row of row 0
            if len(prim):
                primary_row = rows_emitted + int(prim[0])
            rows_emitted += count
            if emit is not None:
                emit(sym.cpu().numpy())
            else:
                if len(prim):
                    k = int(prim[0])
                    sym = torch.cat([sym[:k], sym[k + 1:]])
                torch.from_numpy(bwt[at:at + len(sym)]).copy_(sym)
            del sym
            t_emit += time.perf_counter() - t0
        del sbk
    del chunks
    if rows_emitted != total or primary_row < 0:
        raise RuntimeError(f"blockwise BWT emitted {rows_emitted} rows of "
                           f"{total} (primary {primary_row})")
    stats.update(
        extract_s=t_extract, sb_sort_s=t_sbsort, block_sort_s=t_block,
        deepen_s=t_deepen, deepen_rounds=deepen_rounds, emit_fetch_s=t_emit,
        sb_sizes=sb_sizes, blocks=n_blocks, primary=primary_row)
    stats["total_s"] = time.perf_counter() - t_all
    stats["msuffixes_per_s"] = total / stats["total_s"] / 1e6
    return bwt, primary_row, stats
