"""Synthetic genome / read simulation with realistic repeat structure.

Uniform-random genomes understress everything that makes mapping hard: busy
q-gram buckets, repeat-family score ties, MAPQ discrimination, reseed
economics. Real genomes are ~50% repeats (hg19 is the reference's own
validation target, ``nvBowtie/nvBowtie.dox:40-50``), so the
bench's honest operating point needs duplicated/mutated segments and tandem
arrays, not just more uniform bases.

``repeat_rich_genome`` composes a genome from three processes:
  - fresh segments: i.i.d. random bases;
  - dispersed repeats: a copy of an EARLIER segment with 1-10% divergence
    (substitutions) — the transposon/segdup analogue;
  - tandem arrays: a short unit repeated back-to-back (satellite analogue).
"""

from __future__ import annotations

import numpy as np


def repeat_rich_genome(
    n: int,
    seed: int = 0,
    repeat_frac: float = 0.40,
    tandem_frac: float = 0.15,
    div_lo: float = 0.01,
    div_hi: float = 0.10,
) -> np.ndarray:
    """Genome of ``n`` 2-bit codes with ~``repeat_frac`` repeat content.

    Segment lengths are lognormal (hundreds of bp to tens of kbp). Repeat
    copies diverge from their source by a uniform-random rate in
    [div_lo, div_hi] substitutions; ``tandem_frac`` of repeat events become
    tandem arrays of a 20 bp - 2 kbp unit instead.
    """
    rng = np.random.default_rng(seed)
    g = np.empty(n, np.uint8)
    # unique prefix so early repeat events have a source pool
    pos = min(n, 1 << 20)
    g[:pos] = rng.integers(0, 4, size=pos, dtype=np.uint8)

    while pos < n:
        if rng.random() < repeat_frac:
            seg_len = int(min(rng.lognormal(8.0, 1.2) + 50, n - pos, pos))
            src = int(rng.integers(0, pos - seg_len + 1))
            seg = g[src:src + seg_len].copy()
            # diverge the copy
            nm = rng.binomial(seg_len, rng.uniform(div_lo, div_hi))
            if nm:
                mp = rng.integers(0, seg_len, size=nm)
                seg[mp] = (seg[mp] + rng.integers(1, 4, size=nm)) % 4
            if rng.random() < tandem_frac and seg_len >= 40:
                unit = int(rng.integers(20, min(2000, seg_len)))
                reps = int(rng.integers(2, 8))
                seg = np.tile(seg[:unit], reps)[:n - pos]
        else:
            seg_len = int(min(rng.lognormal(9.0, 1.0) + 100, n - pos))
            seg = rng.integers(0, 4, size=seg_len, dtype=np.uint8)
        g[pos:pos + len(seg)] = seg
        pos += len(seg)
    return g


def sample_reads(
    genome: np.ndarray,
    n_reads: int,
    read_len: int,
    seed: int = 1,
    subst_rate: float = 0.01,
    rc_frac: float = 0.5,
):
    """Sample reads with known truth: returns (reads (B, L) int32, starts
    (B,) int64, is_rc (B,) bool). Substitutions at ``subst_rate``; RC reads
    still report their FORWARD genome start (the mapper's convention)."""
    rng = np.random.default_rng(seed)
    n = len(genome)
    L = read_len
    starts = rng.integers(0, n - L, size=n_reads)
    reads = genome[starts[:, None] + np.arange(L)].astype(np.int32)
    nmut = max(1, int(round(L * subst_rate)))
    mp = rng.integers(0, L, size=(n_reads, nmut))
    mv = rng.integers(1, 4, size=(n_reads, nmut))
    np.put_along_axis(
        reads, mp, (np.take_along_axis(reads, mp, 1) + mv) % 4, 1)
    is_rc = rng.random(n_reads) < rc_frac
    rc = (3 - reads)[:, ::-1]
    reads = np.where(is_rc[:, None], rc, reads)
    return reads, starts, is_rc


def sample_pairs(
    genome: np.ndarray,
    n_pairs: int,
    read_len: int,
    frag_lo: int,
    frag_hi: int,
    seed: int = 1,
    subst_rate: float = 0.01,
):
    """Sample FR read pairs with known truth. Fragments of uniform length
    in [frag_lo, frag_hi] (>= read_len); the forward mate reads the
    fragment's first ``read_len`` bases, the reverse mate the reverse
    complement of its last. Half the pairs have mate 1 on the reverse
    strand. Substitutions at ``subst_rate`` per mate. Returns (reads1,
    reads2 (B, L) int32, starts1, starts2 (B,) int64 forward genome
    starts, rc1, rc2 (B,) bool strands)."""
    rng = np.random.default_rng(seed)
    L = read_len
    frag = rng.integers(frag_lo, frag_hi + 1, size=n_pairs)
    fstart = rng.integers(0, len(genome) - frag)
    rstart = fstart + frag - L
    nmut = max(1, int(round(L * subst_rate)))

    def mates(starts):
        reads = genome[starts[:, None] + np.arange(L)].astype(np.int32)
        mp = rng.integers(0, L, size=(n_pairs, nmut))
        mv = rng.integers(1, 4, size=(n_pairs, nmut))
        np.put_along_axis(
            reads, mp, (np.take_along_axis(reads, mp, 1) + mv) % 4, 1)
        return reads

    left = mates(fstart)
    right = (3 - mates(rstart))[:, ::-1]
    flip = rng.random(n_pairs) < 0.5
    reads1 = np.where(flip[:, None], right, left)
    reads2 = np.where(flip[:, None], left, right)
    return (reads1, reads2, np.where(flip, rstart, fstart),
            np.where(flip, fstart, rstart), flip, ~flip)


def write_fastq(path: str, names, reads, quals) -> None:
    """Write reads as FASTQ: ``reads`` (B, L) symbol codes (0-3 = ACGT, 4 =
    N), ``quals`` (B, L) Phred scores, one name per row."""
    seqs = np.frombuffer(b"ACGTN", np.uint8)[np.asarray(reads)]
    quals = np.asarray(quals, np.uint8) + 33
    with open(path, "wb") as f:
        for name, s, q in zip(names, seqs, quals):
            f.write(b"@%s\n%s\n+\n%s\n" % (name.encode(), s.tobytes(),
                                          q.tobytes()))
