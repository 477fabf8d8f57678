"""PagedText: an insertable symbol sequence for incremental BWT merging.

A copy of ``nvbio_tpu.index.paged_text`` (host numpy). Counterpart of the
reference's ``nvbio/sufsort/paged_text.h`` (PagedText + occurrence
bookkeeping used by BWTE, ``bwte.h``): the merged BWT lives in
fixed-capacity pages with slack, so inserting a block of m symbols moves
only the touched pages — O(m + touched_pages * page_size) instead of O(n)
array reallocation per merge. Per-page symbol counters give rank/occ
queries without scanning the whole text.

``bwte_insert_block`` implements the BCR/BWTE column insertion: the j-th
round inserts the j-th-from-last symbol of every new string at the rank
determined by an occ query against the current merged BWT — the same
insert-rank recurrence as the reference's bwte_merge kernels
(``sufsort/bwte_inl.h``), vectorized across the block.
"""

from __future__ import annotations

import numpy as np

PAGE = 4096  # symbols per page (half-filled on split, like a B+-tree leaf)


class PagedText:
    """Paged byte-symbol sequence with bulk insertion and per-page counts."""

    def __init__(self, n_symbols: int = 8, page: int = PAGE):
        self.n_symbols = n_symbols
        self.page = page
        self.pages: list[np.ndarray] = []          # uint8 arrays, len <= page
        self.counts = np.zeros((0, n_symbols), np.int64)  # per-page counts

    # ---- bookkeeping ------------------------------------------------------
    @property
    def n(self) -> int:
        return int(self.page_lens.sum()) if self.pages else 0

    @property
    def page_lens(self) -> np.ndarray:
        return np.asarray([len(p) for p in self.pages], np.int64)

    def _page_starts(self) -> np.ndarray:
        lens = self.page_lens
        starts = np.zeros(len(lens) + 1, np.int64)
        np.cumsum(lens, out=starts[1:])
        return starts

    def gather(self) -> np.ndarray:
        """Materialize the full sequence (O(n); for output/artifacts)."""
        return (np.concatenate(self.pages) if self.pages
                else np.zeros(0, np.uint8))

    def symbol_counts(self) -> np.ndarray:
        return (self.counts.sum(axis=0) if len(self.counts)
                else np.zeros(self.n_symbols, np.int64))

    # ---- queries ----------------------------------------------------------
    def occ_many(self, syms: np.ndarray, positions: np.ndarray) -> np.ndarray:
        """occ(sym_i, pos_i): count of sym_i in text[0:pos_i), vectorized.

        Whole-page contributions come from the per-page counter prefix; the
        partial page is cumsum'd once per TOUCHED page only.
        """
        if not self.pages:
            return np.zeros(len(positions), np.int64)
        starts = self._page_starts()
        pi = np.searchsorted(starts, positions, side="right") - 1
        pi = np.clip(pi, 0, len(self.pages) - 1)
        cnt_prefix = np.zeros((len(self.pages) + 1, self.n_symbols), np.int64)
        np.cumsum(self.counts, axis=0, out=cnt_prefix[1:])
        out = cnt_prefix[pi, syms]
        rem = positions - starts[pi]
        for p in np.unique(pi):
            m = pi == p
            if not (rem[m] > 0).any():
                continue
            page = self.pages[p]
            onehot = page[:, None] == np.arange(self.n_symbols)[None, :]
            cum = np.zeros((len(page) + 1, self.n_symbols), np.int64)
            np.cumsum(onehot, axis=0, out=cum[1:])
            out[m] += cum[np.minimum(rem[m], len(page)), syms[m]]
        return out

    # ---- mutation ---------------------------------------------------------
    def _count_of(self, arr: np.ndarray) -> np.ndarray:
        return np.bincount(arr, minlength=self.n_symbols).astype(np.int64)

    def insert_many(self, positions: np.ndarray, syms: np.ndarray) -> None:
        """Insert sym_i before current position pos_i (positions refer to
        the PRE-insertion sequence; duplicates allowed). Only touched pages
        are rebuilt; oversized pages split at half capacity."""
        order = np.argsort(positions, kind="stable")
        positions = np.asarray(positions, np.int64)[order]
        syms = np.asarray(syms, np.uint8)[order]
        if not self.pages:
            self.pages = [np.zeros(0, np.uint8)]
            self.counts = np.zeros((1, self.n_symbols), np.int64)
        starts = self._page_starts()
        pi = np.clip(np.searchsorted(starts[1:], positions, side="right"),
                     0, len(self.pages) - 1)
        new_pages: list[np.ndarray] = []
        new_counts: list[np.ndarray] = []
        cursor = 0
        for p, page in enumerate(self.pages):
            lo = cursor
            while cursor < len(positions) and pi[cursor] == p:
                cursor += 1
            if cursor == lo:
                new_pages.append(page)
                new_counts.append(self.counts[p])
                continue
            offs = positions[lo:cursor] - starts[p]
            merged = np.insert(page, np.clip(offs, 0, len(page)),
                               syms[lo:cursor])
            # split oversized results into half-page chunks
            if len(merged) <= self.page:
                new_pages.append(merged)
                new_counts.append(self._count_of(merged))
            else:
                half = self.page // 2
                for s in range(0, len(merged), half):
                    chunk = merged[s:s + half]
                    new_pages.append(chunk)
                    new_counts.append(self._count_of(chunk))
        self.pages = new_pages
        self.counts = (np.stack(new_counts) if new_counts
                       else np.zeros((0, self.n_symbols), np.int64))

    def set_many(self, positions: np.ndarray, syms: np.ndarray) -> None:
        """Replace the symbols at ``positions`` in place (counts updated)."""
        if not len(positions):
            return
        starts = self._page_starts()
        pi = np.clip(np.searchsorted(starts, positions, side="right") - 1,
                     0, len(self.pages) - 1)
        for p in np.unique(pi):
            m = pi == p
            offs = (positions[m] - starts[p]).astype(np.int64)
            page = self.pages[p]
            page[offs] = np.asarray(syms, np.uint8)[m]
            self.counts[p] = self._count_of(page)

    @classmethod
    def from_array(cls, arr: np.ndarray, n_symbols: int = 8,
                   page: int = PAGE) -> "PagedText":
        pt = cls(n_symbols, page)
        arr = np.asarray(arr, np.uint8)
        half = page // 2
        pt.pages = [arr[s:s + half].copy() for s in range(0, len(arr), half)]
        if not pt.pages:
            pt.pages = [np.zeros(0, np.uint8)]
        pt.counts = np.stack([pt._count_of(p) for p in pt.pages])
        return pt


def bwte_insert_block(pt: PagedText, reads, n_prev_strings: int) -> int:
    """Insert a block of strings into an existing multi-string BWT.

    BCR/BWTE column insertion (``sufsort/bwte.h`` / ``bwte_inl.h``): strings
    insert symbol-by-symbol from their ends; each string carries its
    current BWT row, advanced by the LF recurrence

        new_row = C[c] + occ(c, row)   (ties ordered by current row)

    so every round is one vectorized ``occ_many`` + one paged multi-insert —
    data movement bounded by touched pages, not the BWT size (the scalable
    alternative to re-sorting/interleave-iterating whole BWTs).

    Symbols: 0 = '$' separator, 1..4 = ACGT+1. New sentinels rank AFTER the
    ``n_prev_strings`` existing ones (sentinel rows stay ordered by global
    string index, matching ``index.setbwt.mse_bwt``). Returns the new total
    string count.
    """
    reads = [np.asarray(r) for r in reads if len(r)]
    m = len(reads)
    if m == 0:
        return n_prev_strings
    maxlen = max(len(r) for r in reads)
    lens = np.asarray([len(r) for r in reads], np.int64)
    S = n_prev_strings + m

    # sentinel rows n_prev..n_prev+m-1 hold the strings' LAST symbols:
    # inserting them all at pre-insert position n_prev (string order) lands
    # them exactly there
    last = np.asarray([r[-1] + 1 for r in reads], np.int64)
    pt.insert_many(np.full(m, n_prev_strings, np.int64),
                   last.astype(np.uint8))
    P = n_prev_strings + np.arange(m, dtype=np.int64)

    # invariant entering round j: B is the complete BWT of the collection
    # truncated to the last (j-1) symbols, and P[s] is the row of string
    # s's '$' (for j == 1, the row of its just-placed last symbol).
    # Round j: the new front symbol c' REPLACES the '$' at P[s] (turning
    # that row into the suffix starting with c'), then the '$' re-inserts
    # at the row of the extended truncation:
    #     final_row = S + sum_{0<d<c'} count_B(d) + occ(c', B, P[s])
    # which counts existing AND this-round-pending smaller rows, so it IS
    # the final coordinate (bases are provably distinct).
    for j in range(1, maxlen + 1):
        active = lens >= j
        if not active.any():
            break
        idx = np.flatnonzero(active)
        cprime = np.asarray(
            [reads[s][lens[s] - j] + 1 for s in idx.tolist()], np.int64)
        if j > 1:
            pt.set_many(P[idx], cprime.astype(np.uint8))
        counts = pt.symbol_counts()
        C = np.full(pt.n_symbols, S, np.int64)
        C[2:] += np.cumsum(counts[1:-1])
        occ = pt.occ_many(cprime, P[idx])
        base = C[cprime] + occ
        order = np.argsort(base, kind="stable")
        pre = base[order] - np.arange(len(idx), dtype=np.int64)
        pt.insert_many(pre, np.zeros(len(idx), np.uint8))
        P[idx] = base
    return S
