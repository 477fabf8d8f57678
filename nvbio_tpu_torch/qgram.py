"""Q-gram indexes: host builds + torch device lookups.

Port of the parts of ``nvbio_tpu.qgram`` the mapper and the ``index`` app
use. The direct-address ``QGramIndex``: bucket offsets of size 4^q + 1 and
a position table sorted by (q-gram, position), so a seed lookup is two
gathers; built on the host by the native counting sort
(``nvbio_tpu_torch.native``), or by the blocked numpy builder
``build_qgram_index_large`` (multi-Gbp texts in bounded memory). The
two-level ``QGroupIndex`` (the reference's ``qgram/qgroup.h:81-200``): a
presence bitvector over the 4^q keys, its popcount prefix, slot starts and
positions, all uint32 bits in int32 tensors (4 bytes an entry up to 2^32
symbols); built on the host by numpy, as in the JAX package, or from the
packed genome on its device in bounded memory
(``build_qgroup_index_device``). Both move to the device with ``.to``,
and ``save``/``load`` read and write the JAX package's ``.qgram.npz`` and
``.qgroup.npz``. ``qgram_count`` is the
batch hit count of a ``QGramIndex``. The string-set index
``QGramSetIndex`` (``nvbio_tpu.qgram`` :517-639, the reference's
``QGramSetIndexDevice``) holds the q-grams of a set of strings as a sorted
unique-key list, slots and (string, pos) coordinates: built on the host,
queried by a LUT plus ``max_probe`` fixed halvings as tensor ops.

The ``QGramIndex``'s tables are int32 tensors for texts below 2^31 symbols
(int64 above); every gathered position is widened to int64 before any
arithmetic (a ``QGroupIndex`` entry by ``& 0xFFFFFFFF``), so no
clip-at-zero helpers are needed. ``mid_pos`` (the middle entry of each
bucket, for the one-gather 1-mismatch lookup) marks empty buckets with -1
in the port; the JAX package marks them with the index dtype's max, and
``QGramIndex.from_arrays`` translates one sentinel into the other.
"""

from __future__ import annotations

import dataclasses
import subprocess

import numpy as np
import torch


@dataclasses.dataclass
class QGramIndex:
    q: int
    offsets: torch.Tensor    # int32/int64[4^q + 1] bucket start offsets
    positions: torch.Tensor  # int32/int64[#qgrams] positions sorted by key
    n: int                   # text length
    mid_pos: torch.Tensor | None = None  # [4^q] middle entry, -1 = empty

    def to(self, device) -> "QGramIndex":
        return QGramIndex(
            self.q, self.offsets.to(device), self.positions.to(device),
            self.n, None if self.mid_pos is None else self.mid_pos.to(device))

    @classmethod
    def from_arrays(cls, q: int, n: int, offsets, positions,
                    mid_pos=None) -> "QGramIndex":
        """From numpy tables as the JAX package holds them: int32 below 2^31
        symbols, uint32 above; ``mid_pos`` empty = the dtype's max."""
        def tensor(a):
            a = np.asarray(a)
            if a.dtype == np.uint32:
                a = a.astype(np.int64)
            elif a.dtype not in (np.int32, np.int64):
                raise TypeError(f"unsupported table dtype {a.dtype}")
            return torch.from_numpy(np.ascontiguousarray(a))

        mid = None if mid_pos is None else tensor(_port_midpos(mid_pos))
        return cls(int(q), tensor(offsets), tensor(positions), int(n), mid)

    @classmethod
    def load(cls, path: str) -> "QGramIndex":
        """Read the ``.qgram.npz`` the JAX package's ``index`` app writes."""
        z = np.load(path)
        return cls.from_arrays(
            int(z["q"]), int(z["n"]), z["offsets"], z["positions"],
            z["mid_pos"] if "mid_pos" in z.files else None)

    def save(self, path: str) -> None:
        """Write the JAX package's ``.qgram.npz``, key for key: tables in
        ``position_dtype(n)``, empty ``mid_pos`` buckets as its max."""
        dt = position_dtype(self.n)
        extra = {}
        if self.mid_pos is not None:
            mp = self.mid_pos.cpu().numpy()
            extra["mid_pos"] = np.where(mp < 0, np.iinfo(dt).max,
                                        mp).astype(dt)
        np.savez_compressed(
            path, q=self.q, offsets=self.offsets.cpu().numpy().astype(dt),
            positions=self.positions.cpu().numpy().astype(dt), n=self.n,
            **extra)


def position_dtype(n: int):
    """int32 below 2^31 symbols, uint32 up to 2^32 (the JAX package's)."""
    if n >= 2**32:
        raise ValueError("texts >= 2^32 symbols must be sharded (see "
                         "nvbio_tpu_torch.parallel.sharded_index)")
    return np.uint32 if n >= 2**31 else np.int32


def _port_midpos(mid_pos) -> np.ndarray:
    """A ``mid_pos`` table as the JAX package holds it (an empty bucket is
    the dtype's max) with the port's -1 for an empty bucket."""
    mp = np.asarray(mid_pos)
    sent = np.iinfo(mp.dtype).max
    # widen before mapping the sentinel: -1 does not fit a uint32
    dt = np.int64 if mp.dtype == np.uint32 else mp.dtype
    return np.where(mp == sent, -1, mp.astype(dt)).astype(dt)


def _midpos_array(offsets: np.ndarray, positions: np.ndarray) -> np.ndarray:
    """The middle entry of each bucket of a host (offsets, positions) table
    in their dtype, the dtype's max where a bucket is empty (the native
    builder's rule, as the JAX package holds it)."""
    dt = offsets.dtype
    cnt = offsets[1:].astype(np.int64) - offsets[:-1]
    mid = np.full(len(cnt), np.iinfo(dt).max, dt)
    full = np.flatnonzero(cnt > 0)
    mid[full] = positions[offsets[full].astype(np.int64) + cnt[full] // 2]
    return mid


def attach_midpos(idx: QGramIndex) -> QGramIndex:
    """``idx`` with ``mid_pos`` filled from its (offsets, positions) table:
    the middle entry of each bucket, -1 where it is empty, built on the
    host and placed on the tables' device."""
    dt = position_dtype(idx.n)
    offsets = idx.offsets.cpu().numpy().astype(dt, copy=False)
    positions = idx.positions.cpu().numpy().astype(dt, copy=False)
    mid = _port_midpos(_midpos_array(offsets, positions))
    return dataclasses.replace(
        idx, mid_pos=torch.from_numpy(mid).to(idx.offsets.device))


def build_qgram_index(codes: np.ndarray, q: int = 12,
                      n_flags: np.ndarray | None = None) -> QGramIndex:
    """Host construction (native counting sort; where the toolchain does
    not build, the numpy ``build_qgram_index_large``, as the JAX package
    falls back), host tensors, ``mid_pos`` attached.

    ``n_flags`` marks ambiguous genome bases: q-grams overlapping one are
    excluded, as in ``nvbio_tpu.qgram.build_qgram_index``."""
    from nvbio_tpu_torch import native

    if q < 1 or q > 15:
        raise ValueError("q must be in [1, 15] for int32 keys")
    try:
        offs, pos = native.qgram_build(
            codes, q,
            None if n_flags is None else np.asarray(n_flags, np.uint8))
    except (OSError, subprocess.CalledProcessError):
        return build_qgram_index_large(codes, q, n_flags=n_flags)
    dt = position_dtype(len(codes))
    if dt != np.uint32:
        offs, pos = offs.astype(dt), pos.astype(dt)
    return QGramIndex.from_arrays(q, len(codes), offs, pos,
                                  _midpos_array(offs, pos))


def _window_has_n(n_flags: np.ndarray, q: int) -> np.ndarray:
    """bad[i] = any(n_flags[i : i + q]) for i in [0, len - q + 1)."""
    npos = len(n_flags) - q + 1
    cs = np.zeros(len(n_flags) + 1, np.int64)
    np.cumsum(n_flags.astype(np.int64), out=cs[1:])
    return (cs[q:q + npos] - cs[:npos]) > 0


def build_qgram_index_large(codes: np.ndarray, q: int = 12,
                            chunk: int = 1 << 27,
                            n_flags: np.ndarray | None = None,
                            verbose: bool = False) -> QGramIndex:
    """Blocked counting-sort builder for multi-Gbp texts (numpy), as
    ``nvbio_tpu.qgram.build_qgram_index_large``: (1) per-chunk bucket
    histograms -> global bucket bases, (2) per-chunk stable argsort and a
    vectorized scatter into the final position table. Peak extra memory is
    O(chunk + 4^q) instead of O(n) int64 sort state. Tables in
    ``position_dtype(n)`` (uint32 from 2^31 symbols), host tensors,
    ``mid_pos`` attached."""
    n = len(codes)
    npos = max(n - q + 1, 0)
    dt = position_dtype(n)
    n_buckets = 1 << (2 * q)
    n_chunks = (npos + chunk - 1) // chunk
    if n_flags is not None:
        n_flags = np.asarray(n_flags, bool)[:n]

    def chunk_keys(c):
        s, e = c * chunk, min((c + 1) * chunk, npos)
        k = qgram_keys(codes[s:e + q - 1], q)
        if n_flags is not None:
            keep = ~_window_has_n(n_flags[s:e + q - 1], q)
            return k[keep], np.flatnonzero(keep) + s
        return k, None

    # pass 1: global bucket histogram (keys recomputed per chunk: cheaper
    # than holding 8n bytes of int64 keys)
    totals = np.zeros(n_buckets, np.int64)
    for c in range(n_chunks):
        totals += np.bincount(chunk_keys(c)[0], minlength=n_buckets)
        if verbose:
            print(f"  qgram pass1 chunk {c + 1}/{n_chunks}", flush=True)
    bucket_starts = np.zeros(n_buckets + 1, np.int64)
    np.cumsum(totals, out=bucket_starts[1:])

    # pass 2: per chunk, stable argsort and a scatter at each bucket's
    # running cursor (chunks go in position order, so a bucket's positions
    # land sorted)
    positions = np.empty(int(bucket_starts[-1]), dt)
    cur = bucket_starts[:-1].copy()
    for c in range(n_chunks):
        k64, pos_of = chunk_keys(c)
        k = k64.astype(np.uint32)
        order = np.argsort(k, kind="stable")
        sk = k[order]
        # within-bucket rank of each sorted element
        run_start = np.zeros(len(sk), np.int64)
        new_run = np.flatnonzero(sk[1:] != sk[:-1]) + 1
        run_start[new_run] = new_run
        np.maximum.accumulate(run_start, out=run_start)
        within = np.arange(len(sk), dtype=np.int64) - run_start
        src = (order + c * chunk) if pos_of is None else pos_of[order]
        positions[cur[sk] + within] = src.astype(dt)
        cur += np.bincount(k, minlength=n_buckets)
        if verbose:
            print(f"  qgram pass2 chunk {c + 1}/{n_chunks}", flush=True)
    offsets = bucket_starts.astype(dt)
    return QGramIndex.from_arrays(q, n, offsets, positions,
                                  _midpos_array(offsets, positions))


def seed_keys_from_batch(seeds: torch.Tensor, q: int) -> torch.Tensor:
    """Pack the first q symbols of dense seeds (..., s >= q) into int32 keys
    (big-endian: first symbol in the high bits)."""
    shifts = 2 * (q - 1 - torch.arange(q, dtype=torch.int32,
                                       device=seeds.device))
    return torch.sum(seeds[..., :q].to(torch.int32) << shifts, dim=-1,
                     dtype=torch.int32)


def qgram_range(index: QGramIndex, keys: torch.Tensor):
    """Bucket ranges [lo, hi) (int64) for q-gram keys."""
    k = keys.to(torch.int64).clamp(0, (1 << (2 * index.q)) - 1)
    lo = index.offsets[k].to(torch.int64)
    hi = index.offsets[k + 1].to(torch.int64)
    return lo, hi


def qgram_locate(index: QGramIndex, lo: torch.Tensor, slot: torch.Tensor):
    """Text positions for hit slots within bucket ranges: positions[lo+slot]."""
    idx = (lo + slot).clamp(max=index.positions.shape[0] - 1)
    return index.positions[idx].to(torch.int64)


def midpos_lookup(index: QGramIndex, keys: torch.Tensor):
    """(middle bucket position int64, bucket nonempty) for q-gram keys —
    one gather per key (the 1-mismatch seeding lookup)."""
    k = keys.to(torch.int64).clamp(0, (1 << (2 * index.q)) - 1)
    mid = index.mid_pos[k].to(torch.int64)
    return mid, mid >= 0


def stratified_offsets(range_size: torch.Tensor, H: int, NS: int):
    """Jittered stratified slot offsets into position-sorted buckets.

    range_size: (..., NS) bucket sizes (int64); returns (..., NS, H):
    H slots strided across the range, phase-jittered per seed index —
    floor(m * r / D) with m = k * NS + s and D = H * NS, computed as
    m * (r // D) + (m * (r % D)) // D exactly as the JAX package does."""
    dev = range_size.device
    k = torch.arange(H, dtype=torch.int64, device=dev)
    D = H * NS
    m_sl = k[None, :] * NS + torch.arange(NS, dtype=torch.int64,
                                          device=dev)[:, None]  # (NS, H)
    r3 = range_size[..., None]
    return torch.where(r3 > H, m_sl * (r3 // D) + (m_sl * (r3 % D)) // D,
                       k.expand_as(m_sl))


def stratified_locate_rows(index: QGramIndex, lo: torch.Tensor,
                           rsz: torch.Tensor, H: int, NS: int):
    """Positions of the stratified H slots of each seed's bucket.

    Same slots as ``nvbio_tpu.qgram.stratified_locate_rows``: buckets of at
    most 128 entries take ``stratified_offsets`` directly; wider buckets
    sample a 128-entry window placed at depth ``(excess // NS) * s`` for
    seed index s. The TPU gathers two 128-entry tile rows and picks the
    slots in-register; on the GPU one gather of ``positions[base + off]``
    reads the same entries. (Slots of empty or invalid seeds differ from
    the TPU's tile-edge values; the pipeline masks them.)

    lo/rsz: (B, NS) int64 bucket starts and sizes; returns (B, NS, H) int64.
    """
    rsz_c = rsz.clamp(max=128)
    off = stratified_offsets(rsz_c, H, NS)                  # (B, NS, H)
    excess = rsz - rsz_c
    s_idx = torch.arange(NS, dtype=torch.int64, device=lo.device)
    base = lo + (excess // NS) * s_idx[None, :]             # (B, NS)
    return qgram_locate(index, base[..., None], off)


def qgram_keys(codes: np.ndarray, q: int) -> np.ndarray:
    """Rolling q-gram keys of a code array: key[i] = codes[i:i+q] base 4,
    first symbol in the high bits (int64, host)."""
    codes = np.asarray(codes, dtype=np.int64)
    n = len(codes) - q + 1
    if n <= 0:
        return np.zeros(0, dtype=np.int64)
    keys = np.zeros(n, dtype=np.int64)
    for j in range(q):
        keys = (keys << 2) | codes[j:j + n]
    return keys


def _i32(a: np.ndarray) -> torch.Tensor:
    """A host int32 tensor of ``a``'s bits (uint32 words keep their bits)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32, copy=False))


@dataclasses.dataclass
class QGroupIndex:
    """Q-Group index: two-level compacted q-gram dictionary (PEANUT's, the
    reference's ``QGroupIndexDevice``). Every table holds uint32 bits in an
    int32 tensor, as nvbio's do, so texts up to 2^32 - 1 symbols keep 4
    bytes an entry; readers widen with ``& 0xFFFFFFFF`` (``_u32``). Below
    2^31 the bits are the JAX package's int32 tables."""

    q: int
    I: torch.Tensor    # uint32 bits [ceil(4^q / 32)]: key present
    S: torch.Tensor    # uint32 bits [len(I) + 1]: exclusive popcount prefix
    SS: torch.Tensor   # uint32 bits [n_unique + 1]: slot start of each q-gram
    P: torch.Tensor    # uint32 bits [n - q + 1]: positions by (q-gram, pos)
    n: int             # text length

    def to(self, device) -> "QGroupIndex":
        return QGroupIndex(self.q, self.I.to(device), self.S.to(device),
                           self.SS.to(device), self.P.to(device), self.n)

    def save(self, path: str) -> None:
        """Write the JAX package's ``.qgroup.npz``, key for key: ``S``,
        ``SS`` and ``P`` in ``position_dtype(n)`` (int32 below 2^31
        symbols, uint32 up to 2^32), ``I`` in uint32."""
        dt = position_dtype(self.n)

        def host(t):
            return t.cpu().numpy().view(dt)

        np.savez_compressed(
            path, q=self.q, I=self.I.cpu().numpy().view(np.uint32),
            S=host(self.S), SS=host(self.SS), P=host(self.P), n=self.n)

    @classmethod
    def load(cls, path: str) -> "QGroupIndex":
        """Read a ``.qgroup.npz`` (either package's), as host tensors."""
        z = np.load(path)
        return cls(int(z["q"]), _i32(z["I"]), _i32(z["S"]), _i32(z["SS"]),
                   _i32(z["P"]), int(z["n"]))


def _u32(t: torch.Tensor) -> torch.Tensor:
    """int64 values of a tensor of uint32 bits."""
    return t.to(torch.int64) & 0xFFFFFFFF


def _bits32(x: torch.Tensor) -> torch.Tensor:
    """int32 tensor of the uint32 bits of int64 values in [0, 2^32)."""
    return (x - ((x & 0x80000000) << 1)).to(torch.int32)


def _popcount_u32(x: np.ndarray) -> np.ndarray:
    """Bits set in each word of a uint32 array (SWAR, wrapping uint32)."""
    x = x - ((x >> 1) & np.uint32(0x55555555))
    x = (x & np.uint32(0x33333333)) + ((x >> 2) & np.uint32(0x33333333))
    x = (x + (x >> 4)) & np.uint32(0x0F0F0F0F)
    return (x * np.uint32(0x01010101)) >> 24


def build_qgroup_index(codes: np.ndarray, q: int = 16,
                       n_flags: np.ndarray | None = None) -> QGroupIndex:
    """Host construction (sort, unique, popcount prefixes), as
    ``nvbio_tpu.qgram.build_qgroup_index``; q up to 16 (32-bit keys).
    One int64 argsort of every key: 24 bytes a base of host arrays.
    ``n_flags`` marks ambiguous bases: q-grams over one are left out, as
    ``build_qgram_index`` leaves them out (the JAX package's Q-Group
    builder keeps them)."""
    if q < 1 or q > 16:
        raise ValueError("q must be in [1, 16] (32-bit keys)")
    position_dtype(len(codes))   # raises from 2^32 symbols
    keys = qgram_keys(codes, q)
    order = np.argsort(keys, kind="stable")
    if n_flags is not None and len(keys):
        order = order[~_window_has_n(np.asarray(n_flags, bool), q)[order]]
    sk = keys[order]
    uniq = np.ones(len(sk), bool)
    uniq[1:] = sk[1:] != sk[:-1]
    SS = np.append(np.flatnonzero(uniq), len(sk)).astype(np.uint32)
    n_words = ((1 << (2 * q)) + 31) // 32
    I = np.zeros(n_words, np.uint32)
    uk = sk[uniq]
    np.bitwise_or.at(I, uk >> 5, np.uint32(1) << (uk & 31).astype(np.uint32))
    S = np.zeros(n_words + 1, np.int64)
    np.cumsum(_popcount_u32(I), out=S[1:])
    return QGroupIndex(q, _i32(I), _i32(S.astype(np.uint32)), _i32(SS),
                       _i32(order.astype(np.uint32)), len(codes))


def packed_qgram_keys(words: torch.Tensor, pos: torch.Tensor,
                      q: int) -> torch.Tensor:
    """int64 keys (first symbol in the high bits, as ``qgram_keys``) of the
    q-grams (q <= 16) at int64 positions ``pos`` of a 2-bit packed text
    (``packed``'s layout, int32 words of uint32 bits): the two words that
    hold a q-gram, shifted so that its first symbol is in the low bits,
    then the 2-bit fields reversed."""
    wi = pos >> 4
    lo = _u32(words[wi])
    hi = _u32(words[(wi + 1).clamp(max=words.shape[0] - 1)])
    s = (pos & 15) << 1
    x = ((lo >> s) | (hi << (32 - s))) & 0xFFFFFFFF
    x = ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    x = (x >> 16) | ((x & 0xFFFF) << 16)
    return x >> (2 * (16 - q))


def packed_has_n(n_mask: torch.Tensor, pos: torch.Tensor,
                 q: int) -> torch.Tensor:
    """Whether the q-gram (q <= 16) at each int64 position ``pos`` holds an
    ambiguous base of ``n_mask`` (``io.Reference.n_mask_words``' layout, a
    bit a position, as int32 words of uint32 bits)."""
    wi = pos >> 5
    lo = _u32(n_mask[wi])
    hi = _u32(n_mask[(wi + 1).clamp(max=n_mask.shape[0] - 1)])
    s = pos & 31
    return (((lo >> s) | (hi << (32 - s))) & ((1 << q) - 1)) != 0


# symbols of a key that name its bucket in ``build_qgroup_index_device``:
# 4^10 buckets, so one bucket holds ~3000 positions of a 3 Gbp text
_BUCKET_SYMBOLS = 10


def build_qgroup_index_device(words: torch.Tensor, n: int, q: int = 16,
                              n_mask: torch.Tensor | None = None,
                              chunk: int = 1 << 25,
                              rows: int = 1 << 25) -> QGroupIndex:
    """``build_qgroup_index``'s tables, bit for bit, built from the packed
    text ``words`` (of ``n`` symbols) on the words' device with torch ops
    (sorts, scans, scatters); on CPU tensors the same ops run on the host.
    ``n_mask`` (on the same device) marks ambiguous bases: q-grams over one
    are left out (``packed_has_n``), as ``build_qgroup_index`` leaves out
    those of its ``n_flags``.

    Memory is bounded whatever the text's length: beside the finished
    tables (4 bytes an entry), ``words`` and ``n_mask``, one step's scratch
    at a time, tens of bytes a row of ``chunk`` positions or of a partition
    below ``2 * rows`` rows (at 2^25, 2.75 GB over the tables' 21.06 GB for
    3.1e9 symbols on an H100). Each step keys its positions again from
    ``words`` (``packed_qgram_keys``). A key's bucket is its first ``p =
    min(q, 10)`` symbols:

    1. count the positions of each bucket, ``chunk`` positions at a time; a
       bucket of more than ``rows`` positions is split into its keys, which
       a second pass counts;
    2. group consecutive buckets (or keys of a split bucket) into
       partitions: one ends after the group that crosses a multiple of
       ``rows``, and a group of more than ``rows`` positions (one key) is a
       partition of its own; distribute each chunk's positions, in order,
       to the end of their partition's range of ``P``: a stable sort by
       partition and a scatter;
    3. sort each partition's range of ``P`` in place, stably, by key (a
       partition of one key is in order already); set the bits of its keys
       in ``I`` (distinct keys' bits, so adding them sets them) and count
       them by word in ``S``;
    4. ``S``, the prefix sum of those counts (the popcount prefix of
       ``I``), 2^24 words at a time;
    5. ``SS``, once ``S`` gives its length: the first row of each run of
       equal keys in each partition."""
    if q < 1 or q > 16:
        raise ValueError("q must be in [1, 16] (32-bit keys)")
    position_dtype(n)   # raises from 2^32 symbols
    dev = words.device
    npos = max(n - q + 1, 0)
    n_words = ((1 << (2 * q)) + 31) // 32
    p = min(q, _BUCKET_SYMBOLS)
    shift = 2 * (q - p)
    spans = [(s, min(s + chunk, npos)) for s in range(0, npos, chunk)]

    def keys_at(pos):
        return packed_qgram_keys(words, pos, q)

    def span_pos_keys(s, e):
        pos = torch.arange(s, e, dtype=torch.int64, device=dev)
        if n_mask is not None:
            pos = pos[~packed_has_n(n_mask, pos, q)]
        return pos, keys_at(pos)

    def run_starts(keys):
        new = torch.ones(keys.shape, dtype=torch.bool, device=dev)
        new[1:] = keys[1:] != keys[:-1]
        return new

    def tally(group_of, n_groups):
        counts = torch.zeros(n_groups, dtype=torch.int64, device=dev)
        for s, e in spans:
            counts += torch.bincount(group_of(span_pos_keys(s, e)[1]),
                                     minlength=n_groups)
        return counts.cpu().numpy()

    # groups in key order: a bucket, or each key of a bucket over ``rows``
    counts = tally(lambda k: k >> shift, 1 << (2 * p))
    split = (counts > rows) & (shift > 0)
    width = np.where(split, 1 << shift, 1)
    g0 = torch.from_numpy(np.cumsum(width) - width).to(dev)
    split_t = torch.from_numpy(split).to(dev)

    def group_of(k):
        b = k >> shift
        return g0[b] + torch.where(split_t[b], k & ((1 << shift) - 1), 0)

    if split.any():
        counts = tally(group_of, int(width.sum()))
    start = np.cumsum(counts) - counts
    over = counts > rows
    new = np.ones(len(counts), bool)
    new[1:] = (start[1:] // rows != start[:-1] // rows) | over[1:] | over[:-1]
    part_of = np.cumsum(new) - 1
    sizes = np.bincount(part_of, weights=counts).astype(np.int64)
    one_key = np.zeros(len(sizes), bool)
    one_key[part_of[over]] = True
    bounds = np.concatenate([[0], np.cumsum(sizes)]).tolist()
    parts = [(a, b, one) for a, b, one
             in zip(bounds[:-1], bounds[1:], one_key) if b > a]
    part_of = torch.from_numpy(part_of.astype(np.int32)).to(dev)
    rows_total = bounds[-1]

    P = torch.empty(rows_total, dtype=torch.int32, device=dev)
    cursor = torch.tensor(bounds[:-1], dtype=torch.int64, device=dev)
    for s, e in spans:
        pos, keys = span_pos_keys(s, e)
        part = part_of[group_of(keys)]
        sp, order = torch.sort(part, stable=True)
        cnt = torch.bincount(part, minlength=len(sizes))
        first = torch.cumsum(cnt, 0) - cnt
        dest = cursor[sp] + torch.arange(len(pos), device=dev) - first[sp]
        P[dest] = _bits32(pos[order])
        cursor += cnt
        del pos, keys, part, sp, order, dest   # freed before the next step

    I = torch.zeros(n_words, dtype=torch.int32, device=dev)
    S = torch.zeros(n_words + 1, dtype=torch.int32, device=dev)
    for a, b, one in parts:
        if one:    # one key, its positions in order
            uk = keys_at(_u32(P[a:a + 1]))
        else:
            pos = _u32(P[a:b])
            keys, order = torch.sort(keys_at(pos), stable=True)
            P[a:b] = _bits32(pos[order])
            uk = keys[run_starts(keys)]
            del pos, keys, order
        I.index_add_(0, uk >> 5, _bits32(torch.ones_like(uk) << (uk & 31)))
        S.index_add_(0, (uk >> 5) + 1,
                     torch.ones(uk.shape, dtype=torch.int32, device=dev))
        del uk    # freed before the next step allocates

    total = torch.zeros((), dtype=torch.int64, device=dev)
    for a in range(1, n_words + 1, 1 << 24):
        b = min(a + (1 << 24), n_words + 1)
        c = torch.cumsum(S[a:b], 0, dtype=torch.int64) + total
        S[a:b] = _bits32(c)
        total = c[-1]

    SS = torch.empty(int(total) + 1, dtype=torch.int32, device=dev)
    u = 0
    for a, b, one in parts:
        if one:
            at = torch.zeros(1, dtype=torch.int64, device=dev)
        else:
            at = torch.nonzero(run_starts(keys_at(_u32(P[a:b])))).squeeze(1)
        SS[u:u + len(at)] = _bits32(at + a)
        u += len(at)
    SS[u] = rows_total - ((rows_total & 0x80000000) << 1)
    return QGroupIndex(q, I, S, SS, P, n)


def qgroup_range(index: QGroupIndex, keys: torch.Tensor):
    """Bucket ranges [lo, hi) (int64) for q-gram keys — the reference's
    ``QGroupIndexViewCore::range`` (``qgroup.h:120-136``). Keys are taken
    modulo 2^(2q) in uint32 space, so q = 16 works with packed int32 seed
    keys that wrap negative; every table entry is read as uint32."""
    from nvbio_tpu_torch.fmi.rank import popcount32

    k = keys.to(torch.int64) & (((1 << (2 * index.q)) - 1) & 0xFFFFFFFF)
    i = k >> 5
    j = k & 31
    word = _u32(index.I[i])
    present = ((word >> j) & 1) == 1
    slot = _u32(index.S[i]) + popcount32(word & ((1 << j) - 1))
    slot = slot.clamp(0, index.SS.shape[0] - 2)
    lo = torch.where(present, _u32(index.SS[slot]), 0)
    hi = torch.where(present, _u32(index.SS[slot + 1]), 0)
    return lo, hi


def qgroup_locate(index: QGroupIndex, lo: torch.Tensor, slot: torch.Tensor):
    """Text positions (int64) of hit slots within bucket ranges."""
    idx = (lo + slot).clamp(0, index.P.shape[0] - 1)
    return _u32(index.P[idx])


def index_range(index, keys: torch.Tensor):
    """Bucket ranges of either q-gram index flavour."""
    if isinstance(index, QGroupIndex):
        return qgroup_range(index, keys)
    return qgram_range(index, keys)


def index_locate(index, lo: torch.Tensor, slot: torch.Tensor):
    """Positions of hit slots of either q-gram index flavour."""
    if isinstance(index, QGroupIndex):
        return qgroup_locate(index, lo, slot)
    return qgram_locate(index, lo, slot)


def qgram_count(index: QGramIndex, queries, qlens=None):
    """Batch hit counting (the QGramFilter 'rank' pass): queries (B, L>=q),
    tensors or numpy arrays, counted on the index's device (int64)."""
    q = torch.as_tensor(queries, device=index.offsets.device)
    lo, hi = qgram_range(index, seed_keys_from_batch(q, index.q))
    return hi - lo


# ---------------------------------------------------------------------------
# String-set q-gram index: q-grams of a STRING SET (e.g. the reads), kept as
# a sorted unique-key list + slots + (string, pos) coordinates. Memory is
# O(#qgrams) and a query is a LUT over the leading symbols plus a
# fixed-iteration in-bucket binary search (the reference's lut +
# lower_bound, qgram.h:558-580).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class QGramSetIndex:
    q: int
    qgrams: torch.Tensor     # (U,) int32 sorted unique q-gram keys (q <= 15)
    slots: torch.Tensor      # (U + 1,) int32: coords of key u in slots[u:u+1]
    coord_str: torch.Tensor  # (N,) int32 string ids, (key, string, pos) order
    coord_pos: torch.Tensor  # (N,) int32 in-string positions
    qlut: int                # leading symbols resolved by the LUT
    lut: torch.Tensor        # (4^qlut + 1,) int32 bounds into qgrams
    max_probe: int           # halvings covering the widest LUT bin

    def to(self, device) -> "QGramSetIndex":
        return dataclasses.replace(
            self, qgrams=self.qgrams.to(device), slots=self.slots.to(device),
            coord_str=self.coord_str.to(device),
            coord_pos=self.coord_pos.to(device), lut=self.lut.to(device))

    @property
    def device(self) -> torch.device:
        return self.lut.device


def build_qgram_set_index(seqs: np.ndarray, lens: np.ndarray, q: int,
                          stride: int = 1, qlut: int = 8) -> QGramSetIndex:
    """Host build over a padded (B, Lmax) code matrix + lengths (host
    tensors; ``.to(device)`` moves the index).

    ``stride`` extracts q-grams at every ``stride``-th in-string position;
    windows containing N codes (> 3) are excluded."""
    if q < 1 or q > 15:
        raise ValueError("q must be in [1, 15] for int32 keys")
    seqs = np.asarray(seqs)
    lens = np.asarray(lens)
    B, Lm = seqs.shape
    npos = Lm - q + 1
    if npos <= 0:
        raise ValueError("strings shorter than q")
    qlut = min(qlut, q)
    keys = np.zeros((B, npos), np.int64)
    bad = np.zeros((B, npos), bool)
    for j in range(q):
        col = seqs[:, j:j + npos].astype(np.int64)
        bad |= col > 3
        keys = (keys << 2) | np.minimum(col, 3)
    in_len = (np.arange(npos, dtype=np.int64)[None, :] + q) <= lens[:, None]
    valid = ~bad & in_len
    if stride > 1:
        keep = np.zeros(npos, bool)
        keep[::stride] = True
        valid &= keep[None, :]
    sid, spos = np.nonzero(valid)
    kflat = keys[sid, spos].astype(np.int64)
    order = np.argsort(kflat, kind="stable")  # stable: coords stay
    kflat = kflat[order]                      # (key, string, pos)-sorted
    coord_str = sid[order].astype(np.int32)
    coord_pos = spos[order].astype(np.int32)
    if len(kflat):
        new = np.concatenate([[True], kflat[1:] != kflat[:-1]])
        qgrams = kflat[new].astype(np.int32)
        slots = np.concatenate(
            [np.flatnonzero(new), [len(kflat)]]).astype(np.int32)
    else:
        qgrams = np.zeros(0, np.int32)
        slots = np.zeros(1, np.int32)
    shift = 2 * (q - qlut)
    lut = np.searchsorted(
        qgrams >> shift, np.arange((1 << (2 * qlut)) + 1),
        side="left").astype(np.int32)
    widest = int((lut[1:] - lut[:-1]).max()) if len(qgrams) else 1
    max_probe = max(1, int(np.ceil(np.log2(max(widest, 1) + 1))))
    return QGramSetIndex(
        q=q, qgrams=torch.from_numpy(qgrams),
        slots=torch.from_numpy(slots),
        coord_str=torch.from_numpy(coord_str),
        coord_pos=torch.from_numpy(coord_pos), qlut=qlut,
        lut=torch.from_numpy(lut), max_probe=max_probe)


def set_index_range(index: QGramSetIndex, keys):
    """(lo, hi) coordinate ranges (int64) for a batch of q-gram keys, on
    the index's device: LUT bounds + ``max_probe`` halvings of a
    lower_bound (a static loop of dense gathers, every gather clamped into
    its table)."""
    q, qlut = index.q, index.qlut
    dev = index.device
    keys = torch.as_tensor(keys, device=dev).to(torch.int32).to(torch.int64)
    U = index.qgrams.shape[0]
    if U == 0:
        z = torch.zeros_like(keys)
        return z, z
    g_lut = (keys >> (2 * (q - qlut))) & ((1 << (2 * qlut)) - 1)
    lut = index.lut.to(torch.int64)
    lo_b, hi_b = lut[g_lut], lut[g_lut + 1]
    lo, hi = lo_b, hi_b
    for _ in range(index.max_probe):
        mid = (lo + hi) // 2
        v = index.qgrams[mid.clamp(0, U - 1)].to(torch.int64)
        go_right = v < keys
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    i = lo.clamp(0, U - 1)
    found = (lo < hi_b) & (index.qgrams[i].to(torch.int64) == keys)
    rlo = torch.where(found, index.slots[i].to(torch.int64), 0)
    rhi = torch.where(found, index.slots[i + 1].to(torch.int64), 0)
    return rlo, rhi


def set_index_locate(index: QGramSetIndex, slot):
    """(string_id, pos) coordinate of occurrence ``slot`` (the reference's
    uint2 coord, qgram.h:491), int64 on the index's device."""
    s = torch.as_tensor(slot, device=index.device).to(torch.int64)
    n = index.coord_pos.shape[0]
    if n == 0:
        # the JAX package's take from an empty table fills INT32_MIN
        fill = torch.full_like(s, -(2**31))
        return fill, fill
    s = s.clamp(0, n - 1)
    return (index.coord_str[s].to(torch.int64),
            index.coord_pos[s].to(torch.int64))
