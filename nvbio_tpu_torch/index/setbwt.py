"""Read-set BWT construction (nvSetBWT / BWTE equivalent).

A copy of ``nvbio_tpu.index.setbwt`` (host numpy and the native engines).
The set is joined with separator symbols and fed to the native SA-IS sorter
(O(n), ~8 bytes/symbol working set), or built block-incrementally: the
native C++ BWTE engine, the numpy static-rank merge, the PagedText column
insertion, Holt-McMillan merges, or the card's engine
(``index/bwte_device.py``).

Artifact: BWT codes over the 5-symbol alphabet {0:'$' separator, 1..4:ACGT}
plus the suffix array sample and primary metadata, .npz-serialized.
"""

from __future__ import annotations

import numpy as np


def join_reads(reads) -> np.ndarray:
    """Join reads with 0-separators: [r0+1, 0, r1+1, 0, ...] (uint8)."""
    total = sum(len(r) for r in reads) + len(reads)
    out = np.zeros(total, dtype=np.uint8)
    off = 0
    for r in reads:
        out[off:off + len(r)] = np.asarray(r, dtype=np.uint8) + 1
        off += len(r) + 1  # leaves a 0 separator
    return out


def set_bwt(reads, method: str = "auto"):
    """BWT of a read set.

    Returns (bwt uint8[n+1] over {0:'$',1..4:ACGT+1}, primary row index).
    The joined text's own terminator is the appended SA-IS sentinel.
    """
    from nvbio_tpu_torch.index.sa import suffix_array

    text = join_reads(reads)
    sa = suffix_array(text, method=method)  # n+1 rows over text+sentinel
    n = len(text)
    prev = sa - 1
    primary = int(np.nonzero(sa == 0)[0][0])
    bwt = text[np.clip(prev, 0, n - 1)]
    bwt[primary] = 0  # the sentinel row wraps to the global terminator
    return bwt, primary


def save_set_bwt(path: str, bwt: np.ndarray, primary: int) -> None:
    np.savez_compressed(path, bwt=bwt, primary=primary)


def bwt_to_text(bwt: np.ndarray) -> str:
    """ASCII dump ('$ACGT' alphabet), the nvSetBWT .txt output format."""
    table = np.frombuffer(b"$ACGT", dtype=np.uint8)
    return table[bwt].tobytes().decode()


# ---------------------------------------------------------------------------
# Incremental (mergeable) multi-string BWT — the BWTE scale-up path
# (``nvbio/sufsort/bwte.h:57-229``: merge_block over a PagedText). Blocks are
# built with BCR sentinel semantics ($_i < $_j for i < j, comparisons stop at
# sentinels, per-string circular BWT symbols), which makes each block's BWT
# self-contained; blocks then merge by Holt & McMillan interleave refinement
# ("Merging of multi-string BWTs with applications", 2014): repeat a stable
# counting-sort (LF) pass over the interleaved symbols until the interleave
# vector reaches its fixpoint — every pass is one dense vectorized sweep.
# ---------------------------------------------------------------------------


def _bcr_sa(reads, method: str = "auto"):
    """Suffix array of the BCR tagged text (distinct increasing sentinels).

    Returns (sa over the n text rows — terminator row dropped, text int64,
    starts int64). Engine: native integer-alphabet SA-IS (O(n)) when the
    toolchain is available, else the numpy prefix-doubling oracle.
    """
    S = len(reads)
    # linear text with DISTINCT increasing sentinels: suffix comparisons
    # stop at the first sentinel, so the order is per-string local
    if isinstance(reads, np.ndarray) and reads.ndim == 2:
        # uniform-length fast path: no per-read python loop
        m, L = reads.shape
        n = m * (L + 1)
        t2 = np.empty((m, L + 1), np.int64)
        t2[:, :L] = reads.astype(np.int64) + S
        t2[:, L] = np.arange(m)
        text = t2.reshape(n)
        starts = np.arange(S, dtype=np.int64) * (L + 1)
    else:
        lens = [len(r) for r in reads]
        n = sum(lens) + S
        text = np.zeros(n, np.int64)
        starts = np.zeros(S, np.int64)
        off = 0
        for i, r in enumerate(reads):
            starts[i] = off
            text[off:off + len(r)] = np.asarray(r, np.int64) + S
            text[off + len(r)] = i  # $_i
            off += len(r) + 1
    if method in ("auto", "native") and n < 2**31 - 2:
        try:
            from nvbio_tpu_torch import native

            sa = native.sais_i32(text.astype(np.int32), K=S + 4).astype(
                np.int64)
            return sa[sa < n], text, starts
        except Exception:
            if method == "native":
                raise
    from nvbio_tpu_torch.index.sa import _suffix_array_doubling

    sa = _suffix_array_doubling(text)
    return sa[sa < n], text, starts  # drop the global terminator row


def mse_bwt(reads, method: str = "auto"):
    """BCR-semantics multi-string BWT.

    Returns (bwt, tags): one entry per symbol incl. one '$' per read
    (alphabet {0:'$', 1..4}); ``tags[j]`` is the in-set string index of the
    '$' at row j (and -1 elsewhere). The tags give each sentinel a distinct
    identity so merges can LF-map '$' symbols to the right sentinel row —
    collapsed sentinels would resolve ties by cyclic continuation instead
    of string rank.
    """
    S = len(reads)
    if S == 0:
        return np.zeros(0, np.uint8), np.zeros(0, np.int64)
    sa, text, starts = _bcr_sa(reads, method=method)
    # owner string + circular previous symbol
    owner = np.searchsorted(starts, sa, side="right") - 1
    at_start = sa == starts[owner]
    prev = text[np.maximum(sa - 1, 0)]
    is_dollar = at_start | (prev < S)
    bwt = np.where(is_dollar, 0, prev - S + 1).astype(np.uint8)
    # tag: the string whose sentinel this is — circular wrap gives $_owner;
    # a mid-text '$' preceding suffix sa is $_{owner-1}'s? no: prev < S means
    # text[sa-1] is the sentinel of the PREVIOUS string == its own value
    tags = np.where(at_start, owner,
                    np.where(prev < S, prev, -1)).astype(np.int64)
    return bwt, tags


def merge_mse_bwts(bwt1, tags1, bwt2, tags2, max_rounds: int | None = None):
    """Merge two tagged multi-string BWTs (set-1 strings keep lower
    sentinel ranks). Holt-McMillan interleave refinement: each round is one
    stable LF redistribution of the interleave bits; sentinel symbols sort
    by their global string rank so LF sends each '$' to its own row."""
    n1, n2 = len(bwt1), len(bwt2)
    S1 = int(tags1.max()) + 1 if n1 else 0
    S2 = int(tags2.max()) + 1 if n2 else 0
    if n1 == 0:
        return bwt2.copy(), tags2.copy()
    if n2 == 0:
        return bwt1.copy(), tags1.copy()
    ST = S1 + S2
    # sort keys: sentinel rows first ordered by global string rank, then
    # bases by symbol value
    key1 = np.where(bwt1 == 0, tags1, ST + bwt1.astype(np.int64))
    key2 = np.where(bwt2 == 0, tags2 + S1, ST + bwt2.astype(np.int64))

    Z = np.concatenate([np.zeros(n1, bool), np.ones(n2, bool)])
    n = n1 + n2
    merged = np.empty(n, np.int64)
    rounds = 0
    while True:
        merged[~Z] = key1
        merged[Z] = key2
        # stable counting-sort destinations in O(n): every sentinel key
        # (the global string rank) occurs exactly once, so its destination
        # IS the key; the 4 base symbols distribute by cumulative count
        dest = merged.copy()  # sentinel rows: dest = tag
        base_hist = np.bincount(merged, minlength=ST + 5)[ST + 1:ST + 5]
        start_c = ST + np.concatenate([[0], np.cumsum(base_hist[:-1])])
        for c in range(1, 5):
            m = merged == ST + c
            if m.any():
                occ = np.cumsum(m) - 1
                dest[m] = start_c[c - 1] + occ[m]
        Znew = np.empty_like(Z)
        Znew[dest] = Z
        rounds += 1
        if np.array_equal(Znew, Z):
            break
        Z = Znew
        if max_rounds is not None and rounds >= max_rounds:
            break
    bwt = np.empty(n1 + n2, np.uint8)
    bwt[~Z] = bwt1
    bwt[Z] = bwt2
    tags = np.empty(n1 + n2, np.int64)
    tags[~Z] = tags1
    tags[Z] = np.where(tags2 >= 0, tags2 + S1, -1)
    return bwt, tags


def bwte_merge_block_rank(M_bwt, M_tags, reads, S_prev: int,
                          occ_sample: int = 64):
    """One-pass BWTE block merge: static-rank interleave insertion.

    The design the reference's BWTE actually uses at speed
    (``sufsort/bwte.h:57-229``): build the BLOCK's own multi-string BWT
    (native SA-IS over the tagged text), compute each block suffix's rank
    against the EXISTING merged BWT with the LF recurrence

        rank(c·T) = C_M[c] + occ_M(c, rank(T)),   rank($_s) = S_prev

    (occ against a STATIC sampled-occurrence table — vectorized across the
    whole block per round, no mid-block structure mutation), then apply all
    insertions in ONE interleave pass: block row i lands at rank_i + i.
    Data movement per block: O(n) for the occ table + merge pass and
    O(block_symbols * occ_sample) for the rank walks — versus the
    per-symbol paged insertions of ``bwte_insert_block``.

    Returns (merged_bwt, merged_tags).
    """
    m = len(reads)
    if m == 0:
        return M_bwt, M_tags
    uniform = isinstance(reads, np.ndarray) and reads.ndim == 2
    if not uniform and len({len(r) for r in reads}) == 1:
        reads = np.stack([np.asarray(r, np.uint8) for r in reads])
        uniform = True
    # block SA once: serves both the block BWT and the row<->suffix map
    sa, text, starts64 = _bcr_sa(reads)
    if uniform:
        P = reads.shape[1] + 1
        owner = sa // P
        at_start = (sa % P) == 0
    else:
        owner = np.searchsorted(starts64, sa, side="right") - 1
        at_start = sa == starts64[owner]
    prev = text[np.maximum(sa - 1, 0)]
    is_dollar = at_start | (prev < m)
    B_bwt = np.where(is_dollar, 0, prev - m + 1).astype(np.uint8)
    B_tags = np.where(at_start, owner, np.where(prev < m, prev, -1))
    B_tags = np.where(B_tags >= 0, B_tags + S_prev, -1).astype(np.int64)
    n = len(M_bwt)
    if n == 0:
        return B_bwt, B_tags

    # sampled occurrence table over M for symbols 1..4 (the walk never
    # queries '$': sentinel ranks come from the base case)
    K = occ_sample
    pad = (-n) % K + K  # always >= K slack so partial windows never overrun
    Mp = np.concatenate([M_bwt, np.zeros(pad, np.uint8)])
    blocks = Mp[:len(Mp) // K * K].reshape(-1, K)
    per = np.stack([(blocks == c).sum(axis=1) for c in range(1, 5)], axis=1)
    OCC = np.zeros((len(blocks) + 1, 4), np.int64)
    np.cumsum(per, axis=0, out=OCC[1:])
    counts = np.bincount(M_bwt, minlength=5).astype(np.int64)[1:5]
    C = np.zeros(5, np.int64)
    C[1] = S_prev
    C[2:] = S_prev + np.cumsum(counts[:-1])
    karange = np.arange(K, dtype=np.int64)

    def occ_m(cs, rs):
        b, rem = rs // K, rs % K
        win = Mp[(b * K)[:, None] + karange[None, :]]
        part = ((win == cs[:, None])
                & (karange[None, :] < rem[:, None])).sum(axis=1)
        return OCC[b, cs - 1] + part

    # reversed dense block matrix: rev[s, j-1] = j-th-from-last symbol + 1
    if uniform:
        Lmax = reads.shape[1]
        lens = np.full(m, Lmax, np.int64)
        total = m * Lmax
        rev = reads[:, ::-1].astype(np.int64) + 1
    else:
        lens = np.asarray([len(r) for r in reads], np.int64)
        Lmax = int(lens.max()) if m else 0
        total = int(lens.sum())
        rev = np.zeros((m, max(Lmax, 1)), np.int64)
        if total:
            flat = np.concatenate(
                [np.asarray(r, np.int64)[::-1] for r in reads if len(r)])
            rowid = np.repeat(np.arange(m), lens)
            cstart = np.concatenate([[0], np.cumsum(lens)[:-1]])
            col = np.arange(total, dtype=np.int64) - np.repeat(cstart, lens)
            rev[rowid, col] = flat + 1  # symbols 1..4

    # rank walk: suffix starting at text position start_s + L_s - j
    starts = starts64
    block_n = total + m
    ranks_pos = np.empty(block_n, np.int64)
    ranks_pos[starts + lens] = S_prev  # sentinel suffixes
    rank = np.full(m, S_prev, np.int64)
    if uniform:
        for j in range(1, Lmax + 1):
            rank = C[rev[:, j - 1]] + occ_m(rev[:, j - 1], rank)
            ranks_pos[starts + (Lmax - j)] = rank
    else:
        for j in range(1, Lmax + 1):
            idx = np.flatnonzero(lens >= j)
            cs = rev[idx, j - 1]
            rank[idx] = C[cs] + occ_m(cs, rank[idx])
            ranks_pos[starts[idx] + lens[idx] - j] = rank[idx]

    # block row r <-> text position sa[r]; interleave at rank + row index.
    # r_of_row is already non-decreasing (rank_M is monotone in suffix
    # order and rows come in SA order), so the merge needs no sort; one
    # mask-scatter pass shared by both planes (np.insert re-derived its
    # fancy-index machinery per call and was the profile's top cost)
    r_of_row = ranks_pos[sa]
    bn = len(r_of_row)
    newpos = r_of_row + np.arange(bn, dtype=np.int64)
    out_n = n + bn
    keep = np.ones(out_n, bool)
    keep[newpos] = False
    merged = np.empty(out_n, M_bwt.dtype)
    merged[newpos] = B_bwt
    merged[keep] = M_bwt
    merged_tags = np.empty(out_n, M_tags.dtype)
    merged_tags[newpos] = B_tags
    merged_tags[keep] = M_tags
    return merged, merged_tags


def mse_bwt_incremental(reads, block_size: int = 100_000,
                        method: str = "paged", device=None) -> np.ndarray:
    """Block-incremental multi-string BWT (the reference's BWTE pipeline
    shape, ``nvSetBWT.cu:64-305``).

    method="native" (the fast host path, uniform-length reads): the C++
    BWTE engine (``native/bwte.cpp``) — BCR column construction per block +
    dual LF rank walks over fused 64-byte rank lines (two-level: uint64
    superblocks, so reach is memory-bound, not 32-bit-bound) + one
    interleave pass (~5 M symbols/s on one core; takes "rank" for ragged
    sets and reads of length 0; raises where the engine does not build).
    method="rank": per-block native SA-IS + static-rank one-pass interleave
    insertion in numpy (``bwte_merge_block_rank`` — the ``bwte.h:57-229``
    design).
    method="device": the card's engine (``index/bwte_device.py``) on
    ``device`` (cuda unless the caller asks for the CPU) — uniform-length
    reads only; the merged BWT stays on the device across blocks, the
    reference's GPU BWTE form.
    method="paged": BCR column insertion into a PagedText — data movement
    per block bounded by touched pages (``paged_text.h`` dynamic structure).
    method="merge": per-block SA-IS + Holt-McMillan interleave merges."""
    if method == "device":
        from nvbio_tpu_torch.index.bwte_device import BwteDevice

        lens = {len(r) for r in reads}
        if len(lens) != 1:
            raise ValueError("device BWTE engine needs uniform-length reads")
        (L,) = lens
        mat = np.stack([np.asarray(r, np.uint8) for r in reads])
        eng = BwteDevice(capacity=len(reads) * (L + 1),
                         n_strings=len(reads), device=device)
        for i in range(0, len(mat), block_size):
            blk = mat[i:i + block_size]
            eng.add_block(blk)
        bwt, _tags = eng.finalize()
        return bwt
    if method == "native":
        from nvbio_tpu_torch import native

        if isinstance(reads, np.ndarray) and reads.ndim == 2:
            mat = reads
        else:
            if len({len(r) for r in reads}) > 1:
                return mse_bwt_incremental(reads, block_size, method="rank")
            mat = np.stack([np.asarray(r, np.uint8) for r in reads])
        m, L = mat.shape
        if L == 0:
            return mse_bwt_incremental(reads, block_size, method="rank")
        acc = np.zeros(0, np.uint8)
        ns = 0
        for i in range(0, m, block_size):
            blk = np.ascontiguousarray(mat[i:i + block_size])
            acc = native.bwte_merge(acc, ns, blk, native.bcr_block_bwt(blk))
            ns += len(blk)
        return acc
    if method == "rank":
        acc = np.zeros(0, np.uint8)
        acc_tags = np.zeros(0, np.int64)
        ns = 0
        for i in range(0, len(reads), block_size):
            blk = reads[i:i + block_size]
            acc, acc_tags = bwte_merge_block_rank(acc, acc_tags, blk, ns)
            ns += len(blk)
        return acc
    if method == "paged":
        from nvbio_tpu_torch.index.paged_text import (
            PagedText,
            bwte_insert_block,
        )

        pt = PagedText(n_symbols=5)
        ns = 0
        for i in range(0, len(reads), block_size):
            ns = bwte_insert_block(pt, reads[i:i + block_size], ns)
        return pt.gather()
    acc = np.zeros(0, np.uint8)
    acc_tags = np.zeros(0, np.int64)
    for i in range(0, len(reads), block_size):
        bwt, tags = mse_bwt(reads[i:i + block_size])
        acc, acc_tags = merge_mse_bwts(acc, acc_tags, bwt, tags)
    return acc
