"""Active-region extraction from sorted alignments + reference haplotypes.

Port of ``nvbio_tpu.assembly.regions`` (the reference's
``nvMicroAssembly/haplotype_caller.cu:38-84`` (``load_active_regions_temp``
+ ``assembly_pipeline::prep_assembly_sequences`` and ``bam_io.cu``): fixed-
size windows tiled over a contig, each collecting the reads overlapping it
from a position-sorted BAM/SAM, plus the reference haplotype slice; all
sequences go to one dense padded code matrix ready for
``build_debruijn_graph``. Host work, over the port's
``io/output.read_alignments`` (SAM and BAM).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from nvbio_tpu_torch.alphabet import string_to_codes


@dataclasses.dataclass
class ActiveRegion:
    """One assembly window (reference ``regions.h`` active_region)."""

    contig: int
    start: int            # 0-based inclusive
    stop: int             # 0-based exclusive
    read_batch_offset: int
    n_reads: int


def _records_from(path: str):
    from nvbio_tpu_torch.io.output import read_alignments

    header, recs = read_alignments(path)
    return header, recs


def load_active_regions(aln_path: str, reference, n_regions: int,
                        region_size: int, start_pos: int = 0,
                        contig: int = 0, max_len: int = 512):
    """Tile ``n_regions`` windows and gather overlapping reads.

    Returns (regions, codes, lengths, region_ids, is_ref, quals): dense
    inputs for ``build_debruijn_graph``; row 0 of every region is its
    reference haplotype.
    """
    _, recs = _records_from(aln_path)
    contig_name = reference.names[contig]
    ref_start = int(reference.offsets[contig])
    ref_stop = int(reference.offsets[contig + 1])

    # position-sorted mapped reads on this contig
    rows = []
    for f in recs:
        flag = int(f[1])
        if flag & 0x4 or f[2] != contig_name:
            continue
        pos = int(f[3]) - 1
        rows.append((pos, f[9], f[10]))
    rows.sort(key=lambda t: t[0])
    starts = np.array([t[0] for t in rows], np.int64)

    regions, seq_rows = [], []
    for i in range(n_regions):
        lo = start_pos + i * region_size
        hi = min(lo + region_size, ref_stop - ref_start)
        if lo >= hi:
            break
        # reference haplotype row
        hap = reference.codes[ref_start + lo:ref_start + hi]
        offset = len(seq_rows)
        seq_rows.append((i, True, hap, None))
        # reads overlapping [lo, hi): those starting before hi whose end > lo
        j0 = np.searchsorted(starts, lo - max_len, side="left")
        j1 = np.searchsorted(starts, hi, side="left")
        n = 0
        for j in range(int(j0), int(j1)):
            pos, seq, qual = rows[j]
            if pos + len(seq) <= lo or seq == "*":
                continue
            codes = string_to_codes(seq)
            q = (np.frombuffer(qual.encode(), np.uint8) - 33
                 if qual != "*" else np.full(len(seq), 40, np.uint8))
            seq_rows.append((i, False, codes, q))
            n += 1
        regions.append(ActiveRegion(contig, lo, hi, offset, n))

    S = len(seq_rows)
    L = max((len(t[2]) for t in seq_rows), default=0)
    codes = np.full((S, L), 4, np.uint8)
    quals = np.zeros((S, L), np.uint8)
    lengths = np.zeros(S, np.int32)
    region_ids = np.zeros(S, np.int32)
    is_ref = np.zeros(S, bool)
    for s, (rid, ref_flag, c, q) in enumerate(seq_rows):
        codes[s, :len(c)] = c
        quals[s, :len(c)] = 0xFF if q is None else q[:len(c)]
        lengths[s] = len(c)
        region_ids[s] = rid
        is_ref[s] = ref_flag
    return regions, codes, lengths, region_ids, is_ref, quals
