"""Read support for assembled haplotypes via trie-dictionary k-mer votes.

Port of ``nvbio_tpu.assembly.support``, the read-to-haplotype evidence step
of the reference's micro-assembler
(``nvMicroAssembly/haplotype_caller.cu:95-118`` scores each region read
against each candidate haplotype): every haplotype's k-mers go into a
sorted-dictionary suffix trie (``trie.SortedDictionary``, the batched-
searchsorted form of ``nvbio/trie/sorted_dictionary.h:40-103``), payload =
haplotype-membership bitmask; each read then votes with its own k-mers — one
batched ``find`` per region — and is assigned to the haplotype(s) sharing
the most k-mers. Counting k-mer support instead of a full pair-HMM is the
assembler's fast evidence pass; sizes are active-region tiny, so the
dictionary walk runs host-side numpy. The payload is an int64 bitmask of up
to 62 haplotypes; ``argmax`` takes the first max.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from nvbio_tpu_torch.trie import SortedDictionary


@dataclasses.dataclass
class HaplotypeSupport:
    region: int
    n_reads: int                 # reads attempted in the region
    votes: np.ndarray            # (n_reads, n_haps) shared-kmer counts
    best_hap: np.ndarray         # (n_reads,) argmax hap id (-1 = no votes)
    support: np.ndarray          # (n_haps,) reads whose best hap is this one


def _kmer_keys(codes: np.ndarray, k: int) -> np.ndarray:
    """All k-mer keys of a code sequence, packed exactly like
    ``trie.pack_keys`` (3 bits/symbol, code+1, max_len=k)."""
    codes = np.asarray(codes, np.int64)
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, np.int64)
    win = np.lib.stride_tricks.sliding_window_view(codes, k)
    shifts = 3 * (k - 1 - np.arange(k, dtype=np.int64))
    return ((win + 1) << shifts[None, :]).sum(axis=1)


def haplotype_support(haplotypes, read_codes, read_lengths, region_ids,
                      is_ref=None, k: int = 10, min_votes: int = 2):
    """k-mer vote assignment of region reads to candidate haplotypes.

    ``haplotypes``: per-region lists from ``k_best_haplotypes``.
    ``read_codes/read_lengths/region_ids/is_ref``: the same dense arrays
    fed to ``build_debruijn_graph`` (reference rows are skipped).

    Returns a list of HaplotypeSupport (None for regions without
    haplotypes). A read votes for the haplotype sharing the most k-mers;
    reads with fewer than ``min_votes`` shared k-mers stay unassigned.
    """
    if (3 * k) > 62:
        raise ValueError("k too large for packed int64 trie keys")
    read_lengths = np.asarray(read_lengths)
    region_ids = np.asarray(region_ids)
    results: list[HaplotypeSupport | None] = []
    for r, haps in enumerate(haplotypes):
        if not haps:
            results.append(None)
            continue
        if len(haps) > 62:
            haps = haps[:62]  # payload bitmask width
        # one dictionary over ALL the region's haplotype k-mers; duplicate
        # keys collapse to an OR'd membership bitmask
        keys, masks = [], {}
        for h, hap in enumerate(haps):
            for key in _kmer_keys(hap.codes, k):
                masks[key] = masks.get(key, 0) | (1 << h)
        if not masks:
            results.append(None)
            continue
        keys = np.fromiter(masks.keys(), np.int64, len(masks))
        payload = np.fromiter(masks.values(), np.int64, len(masks))
        order = np.argsort(keys, kind="stable")
        trie = SortedDictionary(keys[order], payload[order],
                                bits=2, max_len=k)

        rows = np.flatnonzero(
            (region_ids == r)
            & (read_lengths >= k)
            & (np.zeros_like(region_ids, bool) if is_ref is None
               else ~np.asarray(is_ref, bool)))
        n_haps = len(haps)
        votes = np.zeros((len(rows), n_haps), np.int32)
        for i, row in enumerate(rows):
            qk = _kmer_keys(read_codes[row][: int(read_lengths[row])], k)
            found, pay = trie.find(qk)
            pay = pay[found]
            for h in range(n_haps):
                votes[i, h] = int(np.count_nonzero(pay & (1 << h)))
        best = np.where(votes.max(axis=1) >= min_votes,
                        votes.argmax(axis=1), -1)
        support = np.bincount(best[best >= 0], minlength=n_haps)
        results.append(HaplotypeSupport(
            region=r, n_reads=len(rows), votes=votes,
            best_hap=best.astype(np.int32),
            support=support.astype(np.int32)))
    return results
