"""Paired-end alignment, torch: concordant pairing + mate rescue, and
paired-end all-mapping.

Port of ``nvbio_tpu.bowtie.paired`` (``align_paired_core`` :35,
``map_pair_batch`` :321, ``align_paired_all`` :473, ``map_pair_batch_all``
:567) on the JAX package's kernel path: both mates go through the
single-end candidate stage (K1; in local mode the flat LOCAL scorer K3),
an all-pairs (C x C) concordance matrix per read pair picks the best
concordant pair, and a mate with no concordant partner is rescued in the
fragment window of its mate's best locus — the Myers kernel
(``align.kernels.myers_semiglobal_windows``, K4) locates the best end in
the window, then the flat banded scorer (``align.kernels.
banded_score_windows``, K3, SEMI_GLOBAL) rescores the mate at that locus;
both read their windows straight from the packed genome. Each mate's final alignment
goes through the fused traceback (K2), or with ``pe_full_traceback`` the
full-matrix traceback (K2-WIDE, band T+M). Per batch: K1 (or K3-LOCAL) x2,
K4 x2, K3 x2, K2 (or K2-WIDE) x2. All-mapping keeps the top K = 4 distinct
pair loci of the matrix and traces each mate's B*K slots in one call (K1
x2, K2 x2; no rescue). Under the scan route (``extension="scan"``,
``pipeline.use_pallas_extension``) the candidates and tracebacks take the
aligner library, as in ``pipeline``, and the rescue is the JAX package's
scan rescue (``paired.py:170-175``): the full-matrix wavefront
``batch_score_full`` (SEMI_GLOBAL Gotoh, the mate's penalties) over the
whole ``maxins + band`` window, the rescued mate's window start taken
from its sink.

One deliberate difference from the JAX package: in local mode a mate's
CIGAR carries its soft clips, as single-end records do, so that it spans
the whole SEQ (``nvbio_tpu.bowtie.paired.map_pair_batch`` and
``map_pair_batch_all`` print only the aligned ops there).

Positions are int64, so the JAX package's clip-at-zero uint32 arithmetic
becomes ``clamp(min=0)``. ``map_pair_batch`` is ``dispatch_pair_batch``
(device work) then ``format_pair_batch`` (host SAM records), split so a
caller can time or overlap the two; likewise ``map_pair_batch_all``.
"""

from __future__ import annotations

import numpy as np
import torch

from nvbio_tpu_torch import packed
from nvbio_tpu_torch.align.batch import batch_score_full
from nvbio_tpu_torch.align.kernels import (
    banded_score_windows,
    myers_semiglobal_windows,
)
from nvbio_tpu_torch.align.types import NEG_INF, SEMI_GLOBAL, GotohAligner
from nvbio_tpu_torch.bowtie.mapq import mapq_v2_end_to_end
from nvbio_tpu_torch.bowtie.params import MapParams
from nvbio_tpu_torch.bowtie.pipeline import (
    HostReads,
    _absdiff,
    alignment_fields,
    finalize_best,
    lazy_ops_rows,
    n_ceil_of,
    read_candidates,
    score_min_of,
    use_pallas_extension,
)
from nvbio_tpu_torch.io.sam import (
    FLAG_FIRST_IN_PAIR,
    FLAG_MATE_REVERSE,
    FLAG_MATE_UNMAPPED,
    FLAG_PAIRED,
    FLAG_PROPER_PAIR,
    FLAG_REVERSE,
    FLAG_SECOND_IN_PAIR,
    FLAG_SECONDARY,
    FLAG_UNMAPPED,
    SamRecord,
)


def _take(x, idx):
    """x[b, idx[b]] for (B, C) x and (B,) idx."""
    return torch.gather(x, 1, idx[:, None])[:, 0]


def check_paired_supported(params: MapParams, read_width: int) -> None:
    """Raise for paired-end settings that select no path: an unknown
    orientation policy. Mate rescue takes reads of any width
    (``read_width``)."""
    if params.pe_policy not in ("fr", "rf", "ff"):
        raise ValueError(f"unknown pe_policy {params.pe_policy!r}")


def _mate_scores(c, reads, P: MapParams):
    """A mate's candidate scores with those under score-min, or of a read
    over the --n-ceil, set to NEG_INF; its score-min and n-ceil mask."""
    score_min = score_min_of(c["lens"], P)
    n_ok = n_ceil_of(reads, c["lens"], P)
    s = torch.where((c["scores"] >= score_min[:, None]) & n_ok[:, None],
                    c["scores"], NEG_INF)
    return s, score_min, n_ok


def _pair_scores(c1, c2, s1, s2, P: MapParams):
    """The (B, C, C) concordance matrix: s1 + s2 where the two candidates
    form a concordant pair under the orientation policy and the fragment
    window, NEG_INF elsewhere."""
    w1 = c1["w0"][:, :, None]
    w2 = c2["w0"][:, None, :]
    st1 = c1["strand"][:, :, None]
    st2 = c2["strand"][:, None, :]
    slack = P.band
    # case A = mate 1 upstream (frag = end2 - w1), B = mate 2 upstream
    if P.pe_policy == "fr":
        condA, condB = ~st1 & st2, st1 & ~st2
    elif P.pe_policy == "rf":
        condA, condB = st1 & ~st2, st2 & ~st1
    else:
        condA, condB = ~st1 & ~st2, st1 & st2
    endA = w2 + c2["lens"].to(torch.int64)[:, None, None]
    okA = (condA & (endA + slack >= w1 + P.minins)
           & (endA <= w1 + (P.maxins + slack)))
    endB = w1 + c1["lens"].to(torch.int64)[:, None, None]
    okB = (condB & (endB + slack >= w2 + P.minins)
           & (endB <= w2 + (P.maxins + slack)))
    return torch.where(okA | okB, s1[:, :, None] + s2[:, None, :], NEG_INF)


def align_paired_core(index, genome_words, n_genome: int, reads1, lens1,
                      quals1, reads2, lens2, quals2, params: MapParams):
    """Map one dense batch of read pairs. Returns (mate-1 result dict,
    mate-2 result dict, pairing dict) of (B,) tensors: the JAX function's
    keys and values, and each mate's ``pattern_start``/``pattern_end``
    (its soft clips in local mode)."""
    P = params
    check_paired_supported(P, max(reads1.shape[1], reads2.shape[1]))
    neg = NEG_INF
    half = neg // 2
    B = reads1.shape[0]
    reads1, reads2 = reads1.to(torch.int32), reads2.to(torch.int32)

    c1 = read_candidates(index, genome_words, n_genome, reads1, lens1,
                         quals1, P)
    c2 = read_candidates(index, genome_words, n_genome, reads2, lens2,
                         quals2, P)
    s1, score_min1, n_ok1 = _mate_scores(c1, reads1, P)
    s2, score_min2, n_ok2 = _mate_scores(c2, reads2, P)
    C = s1.shape[1]
    pair_scores = _pair_scores(c1, c2, s1, s2, P)
    flat = pair_scores.reshape(B, C * C)
    pair_idx = torch.argmax(flat, dim=1)
    pair_best = _take(flat, pair_idx)
    i1 = pair_idx // C
    i2 = pair_idx % C
    has_pair = pair_best > half

    # distinct-locus second-best pair (for the PE MAPQ)
    bw1 = _take(c1["w0"], i1)
    bw2 = _take(c2["w0"], i2)
    tol = 2 * P.max_dist
    same = ((_absdiff(c1["w0"][:, :, None], bw1[:, None, None]) <= tol)
            & (_absdiff(c2["w0"][:, None, :], bw2[:, None, None]) <= tol))
    pair_second = torch.where(same, neg, pair_scores).reshape(
        B, C * C).max(dim=1).values

    # ---- SE bests (fallback + rescue anchors) --------------------------------
    se1_idx = torch.argmax(s1, dim=1)
    se1_score = _take(s1, se1_idx)
    se2_idx = torch.argmax(s2, dim=1)
    se2_score = _take(s2, se2_idx)
    se1_ok = se1_score > half
    se2_ok = se2_score > half
    strand1 = c1["strand"].expand(B, C)
    strand2 = c2["strand"].expand(B, C)

    if P.mate_rescue:
        n_last = max(n_genome - 1, 0)
        RW = P.maxins + P.band  # rescue window length

        def rescue(anchor_w0, anchor_strand, anchor_len, other, other_len,
                   other_mm):
            # the missing mate sits downstream of an upstream-oriented
            # anchor: fr/ff forward anchors, rf reversed ones
            upstream = anchor_strand if P.pe_policy != "rf" \
                else ~anchor_strand
            rev_end = anchor_w0 + (anchor_len.to(torch.int64) + P.band)
            wstart = torch.where(upstream, (rev_end - RW).clamp(min=0),
                                 anchor_w0).clamp(max=n_last)
            wlen = (n_genome - wstart).clamp(min=0, max=RW).to(torch.int32)
            if not use_pallas_extension(P):
                sunk = batch_score_full(
                    other, other_len,
                    packed.extract_window(genome_words, wstart, RW, 2), wlen,
                    GotohAligner(SEMI_GLOBAL, P.scoring),
                    mismatch_scores=other_mm)
                # the rescued mate's window start (its banded re-align)
                rw0 = (wstart + sunk.sink_text.to(torch.int64)
                       - (other_len.to(torch.int64) + P.max_dist)).clamp(
                           min=0).clamp(max=n_last)
                return sunk.score, rw0
            _dist, tend = myers_semiglobal_windows(other, other_len,
                                                   genome_words, wstart,
                                                   wlen, RW)
            rw0 = (wstart + tend.to(torch.int64)
                   - (other_len.to(torch.int64) + P.max_dist)).clamp(min=0)
            rw0 = rw0.clamp(max=n_last)
            TWr = other.shape[1] + P.band - 1
            rwlen = (n_genome - rw0).clamp(min=0, max=TWr).to(torch.int32)
            score, _k = banded_score_windows(other, other_len, genome_words,
                                             rw0, rwlen, P.scoring, P.band,
                                             other_mm)
            return score, rw0

        # the rescued mate's strand: opposite to the anchor's for fr/rf,
        # the same for ff
        same_strand = P.pe_policy == "ff"

        def mate_view(c, rev):
            other = torch.where(rev[:, None], c["rc"], c["reads"])
            omm = None if c["mm"] is None else torch.where(
                rev[:, None], c["mm_rc"], c["mm"])
            return other, omm

        a1_w0, a1_st = _take(c1["w0"], se1_idx), _take(strand1, se1_idx)
        m2_rev = a1_st if same_strand else ~a1_st
        other2, omm2 = mate_view(c2, m2_rev)
        r2_score, r2_w0 = rescue(a1_w0, a1_st, c1["lens"], other2,
                                 c2["lens"], omm2)
        r2_score = torch.where(se1_ok & (r2_score >= score_min2) & n_ok2,
                               r2_score, neg)

        a2_w0, a2_st = _take(c2["w0"], se2_idx), _take(strand2, se2_idx)
        m1_rev = a2_st if same_strand else ~a2_st
        other1, omm1 = mate_view(c1, m1_rev)
        r1_score, r1_w0 = rescue(a2_w0, a2_st, c2["lens"], other1,
                                 c1["lens"], omm1)
        r1_score = torch.where(se2_ok & (r1_score >= score_min1) & n_ok1,
                               r1_score, neg)

        resc2 = ~has_pair & se1_ok & (r2_score > half)
        resc1 = ~has_pair & se2_ok & (r1_score > half) & ~resc2

        # fold the rescues into the chosen pair
        i1 = torch.where(resc2, se1_idx, i1)
        i2 = torch.where(resc1, se2_idx, i2)
        pair1_w0 = torch.where(resc1, r1_w0, _take(c1["w0"], i1))
        pair2_w0 = torch.where(resc2, r2_w0, _take(c2["w0"], i2))
        pair1_strand = torch.where(resc1, m1_rev, _take(strand1, i1))
        pair2_strand = torch.where(resc2, m2_rev, _take(strand2, i2))
        pair1_score = torch.where(resc1, r1_score, _take(s1, i1))
        pair2_score = torch.where(resc2, r2_score, _take(s2, i2))
        has_pair = has_pair | resc1 | resc2
        pair_best = torch.where(resc1 | resc2, pair1_score + pair2_score,
                                pair_best)
    else:
        pair1_w0, pair2_w0 = _take(c1["w0"], i1), _take(c2["w0"], i2)
        pair1_strand, pair2_strand = _take(strand1, i1), _take(strand2, i2)
        pair1_score, pair2_score = _take(s1, i1), _take(s2, i2)
        resc1 = resc2 = torch.zeros(B, dtype=torch.bool, device=s1.device)

    # ---- final per-mate alignments: the pair, else each mate's SE best -------
    fin1_w0 = torch.where(has_pair, pair1_w0, _take(c1["w0"], se1_idx))
    fin2_w0 = torch.where(has_pair, pair2_w0, _take(c2["w0"], se2_idx))
    fin1_st = torch.where(has_pair, pair1_strand, _take(strand1, se1_idx))
    fin2_st = torch.where(has_pair, pair2_strand, _take(strand2, se2_idx))
    fin1_score = torch.where(has_pair, pair1_score, se1_score)
    fin2_score = torch.where(has_pair, pair2_score, se2_score)
    # pe_full_traceback: the full-matrix mate traceback (K2-WIDE)
    fin1 = finalize_best(c1, genome_words, n_genome, fin1_w0, fin1_st, P,
                         full_matrix=P.pe_full_traceback)
    fin2 = finalize_best(c2, genome_words, n_genome, fin2_w0, fin2_st, P,
                         full_matrix=P.pe_full_traceback)
    mapped1 = fin1_score > half
    mapped2 = fin2_score > half

    # ---- MAPQ: pairs through the V2 table on pair scores, unpaired mates
    # against their own second-best
    pair_min = score_min1 + score_min2
    mapq_pair = mapq_v2_end_to_end(pair_best, pair_second,
                                   pair_second >= pair_min, pair_min)
    same1 = (_absdiff(c1["w0"], fin1_w0[:, None]) <= tol) & \
        (strand1 == fin1_st[:, None])
    sec1 = torch.where(same1, neg, s1).max(dim=1).values
    same2 = (_absdiff(c2["w0"], fin2_w0[:, None]) <= tol) & \
        (strand2 == fin2_st[:, None])
    sec2 = torch.where(same2, neg, s2).max(dim=1).values
    mapq1_se = mapq_v2_end_to_end(fin1_score, sec1, sec1 >= score_min1,
                                  score_min1)
    mapq2_se = mapq_v2_end_to_end(fin2_score, sec2, sec2 >= score_min2,
                                  score_min2)
    mapq1 = torch.where(has_pair, mapq_pair, torch.where(mapped1, mapq1_se, 0))
    mapq2 = torch.where(has_pair, mapq_pair, torch.where(mapped2, mapq2_se, 0))

    # discordant: both mates aligned uniquely, just not concordantly
    if P.pe_discordant:
        discordant = ~has_pair & mapped1 & ~(sec1 >= score_min1) & \
            mapped2 & ~(sec2 >= score_min2)
    else:
        discordant = torch.zeros_like(has_pair)

    def pack_mate(fin, mapped, score, mapq, sec, smin):
        return dict(
            mapped=mapped, best_score=score, mapq=mapq,
            has_second=sec >= smin, strand=fin["strand"],
            window_start=fin["window_start"], text_start=fin["text_start"],
            pattern_start=fin["pattern_start"],
            pattern_end=fin["pattern_end"], ops=fin["ops"],
            n_ops=fin["n_ops"], nm=fin["nm"], simple=fin["simple"],
        )

    return (
        pack_mate(fin1, mapped1, fin1_score, mapq1, sec1, score_min1),
        pack_mate(fin2, mapped2, fin2_score, mapq2, sec2, score_min2),
        dict(proper=has_pair, discordant=discordant, rescued1=resc1,
             rescued2=resc2, pair_score=pair_best),
    )


def dispatch_pair_batch(mapper, batch1, batch2):
    """Enqueue the device work of one pair of ``ReadBatch``es on the
    mapper's device; returns ``align_paired_core``'s tensors
    (asynchronous on CUDA until read)."""
    return align_paired_core(mapper.index, mapper.genome_words,
                             mapper.n_genome, *mapper.batch_tensors(batch1),
                             *mapper.batch_tensors(batch2), mapper.params)


def format_pair_batch(mapper, batch1, batch2, res,
                      stats=None) -> list[SamRecord]:
    """Interleaved SAM records (mate 1, mate 2 per pair) of a dispatched
    pair batch, with the pair flags, RNEXT/PNEXT/TLEN and bowtie2's YT
    tag; the host formatting of ``nvbio_tpu.bowtie.paired.
    map_pair_batch``, plus the soft clips of local-mode CIGARs. ``stats``
    (an optional ``utils.stats.AlignmentStats``) accumulates each mate's
    mapping stats and the proper and discordant pairs, over real reads
    (length > 0) only."""
    res1, res2, pinfo = res
    ops_dev = (res1["ops"], res2["ops"])
    res1 = {k: v.cpu().numpy() for k, v in res1.items() if k != "ops"}
    res2 = {k: v.cpu().numpy() for k, v in res2.items() if k != "ops"}
    proper = pinfo["proper"].cpu().numpy()
    discordant = pinfo["discordant"].cpu().numpy()
    if stats is not None:
        stats.update_from_result(res1, batch1.lengths)
        stats.update_from_result(res2, batch2.lengths)
        real = np.asarray(batch1.lengths) > 0
        stats.n_proper_pairs += int((proper & real).sum())
        stats.n_discordant += int((discordant & real).sum())
    proper, discordant = proper.tolist(), discordant.tolist()

    mates = []
    for batch, res, dev_ops in ((batch1, res1, ops_dev[0]),
                                (batch2, res2, ops_dev[1])):
        gpos = res["window_start"] + res["text_start"]
        cis, local = mapper.contig_of(gpos)
        need = res["mapped"] & ((res["nm"] > 0) | ~res["simple"])
        reads = HostReads(batch)
        mates.append(dict(
            reads=reads, lens=reads.lens, mapped=res["mapped"].tolist(),
            strand=(res["strand"] & res["mapped"]).tolist(),
            gpos=gpos.tolist(), ci=cis.tolist(), local=local.tolist(),
            score=res["best_score"].tolist(), nm=res["nm"].tolist(),
            mapq=res["mapq"].tolist(), n_ops=res["n_ops"].tolist(),
            simple=res["simple"].tolist(), ops=lazy_ops_rows(need, dev_ops),
            clip=list(zip(res["pattern_start"].tolist(),
                          res["pattern_end"].tolist()))))
    names = mapper.ref_names
    rev_ops = use_pallas_extension(mapper.params)

    out = []
    for b, name in enumerate(batch1.names):
        if mates[0]["lens"][b] == 0:
            continue  # batch padding
        for m in range(2):
            me, ot = mates[m], mates[1 - m]
            L = me["lens"][b]
            mapped, strand = me["mapped"][b], me["strand"][b]
            flag = FLAG_PAIRED | (FLAG_FIRST_IN_PAIR if m == 0
                                  else FLAG_SECOND_IN_PAIR)
            if proper[b]:
                flag |= FLAG_PROPER_PAIR
            if not mapped:
                flag |= FLAG_UNMAPPED
            if strand:
                flag |= FLAG_REVERSE
            if not ot["mapped"][b]:
                flag |= FLAG_MATE_UNMAPPED
            elif ot["strand"][b]:
                flag |= FLAG_MATE_REVERSE
            seq, qual = me["reads"].seq_qual(b, strand)
            if not mapped:
                out.append(SamRecord(qname=name, flag=flag, rname="*",
                                     pos=0, mapq=0, cigar="*", seq=seq,
                                     qual=qual))
                continue
            ci, gpos = me["ci"][b], me["gpos"][b]
            rnext, pnext, tlen = "*", 0, 0
            if ot["mapped"][b]:
                co, gpo = ot["ci"][b], ot["gpos"][b]
                rnext = "=" if co == ci else names[co]
                pnext = ot["local"][b] + 1
                if co == ci:
                    # leftmost start to rightmost end, signed by position
                    tlen = max(gpos + L, gpo + ot["lens"][b]) - min(gpos, gpo)
                    if gpos > gpo or (gpos == gpo and m == 1):
                        tlen = -tlen
            yt = "CP" if proper[b] else "DP" if discordant[b] else "UP"
            cigar, md_tags = alignment_fields(
                me["ops"].get(b), me["n_ops"][b], me["nm"][b],
                me["simple"][b], *me["clip"][b], L, rev_ops)
            out.append(SamRecord(
                qname=name, flag=flag, rname=names[ci],
                pos=me["local"][b] + 1, mapq=me["mapq"][b], cigar=cigar,
                seq=seq, qual=qual, rnext=rnext, pnext=pnext, tlen=tlen,
                tags={"AS": me["score"][b], "NM": me["nm"][b], "YT": yt,
                      **md_tags}))
    return out


def map_pair_batch(mapper, batch1, batch2, stats=None) -> list[SamRecord]:
    """Map paired ``ReadBatch``es -> interleaved SAM records. ``mapper`` is
    a ``bowtie.pipeline.ReadMapper``; ``stats`` as ``format_pair_batch``."""
    return format_pair_batch(mapper, batch1, batch2,
                             dispatch_pair_batch(mapper, batch1, batch2),
                             stats)


# pair loci kept per read pair by all-mapping (the JAX package's default
# ``max_pairs``, which no caller there changes)
PAIR_ALL_K = 4


def top_k_stable(x, k: int):
    """The k largest entries of each row of x and their indices, ties in
    index order as ``jax.lax.top_k`` puts them (``torch.topk`` promises no
    order among ties; every non-concordant cell of a pair matrix ties at
    NEG_INF)."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def align_paired_all(index, genome_words, n_genome: int, reads1, lens1,
                     quals1, reads2, lens2, quals2, params: MapParams):
    """Paired-end all-mapping: up to ``PAIR_ALL_K`` concordant pair loci per
    read pair, the top cells of the (C x C) concordance matrix with the
    slots that repeat an earlier slot's locus (both mates within
    2*max_dist) dropped, and one flattened traceback of the B*K slots per
    mate. No mate rescue. Port of ``nvbio_tpu.bowtie.paired.
    align_paired_all`` (:473). Returns keep, pair_score (B, K), mapq (B,)
    and each mate's traceback fields (B, K)."""
    P = params
    if P.pe_policy not in ("fr", "rf", "ff"):
        raise ValueError(f"unknown pe_policy {P.pe_policy!r}")
    B = reads1.shape[0]
    reads1, reads2 = reads1.to(torch.int32), reads2.to(torch.int32)
    c1 = read_candidates(index, genome_words, n_genome, reads1, lens1,
                         quals1, P)
    c2 = read_candidates(index, genome_words, n_genome, reads2, lens2,
                         quals2, P)
    s1, score_min1, _ = _mate_scores(c1, reads1, P)
    s2, score_min2, _ = _mate_scores(c2, reads2, P)
    C = s1.shape[1]
    flat = _pair_scores(c1, c2, s1, s2, P).reshape(B, C * C)

    K = PAIR_ALL_K
    top_vals, top_idx = top_k_stable(flat, K)
    i1, i2 = top_idx // C, top_idx % C
    pw1 = torch.gather(c1["w0"], 1, i1)
    pw2 = torch.gather(c2["w0"], 1, i2)
    pst1 = torch.gather(c1["strand"].expand(B, C), 1, i1)
    pst2 = torch.gather(c2["strand"].expand(B, C), 1, i2)
    keep = top_vals > NEG_INF // 2
    # distinct loci among the K slots (neighbouring cells of the matrix
    # are often the same pair locus)
    tol = 2 * P.max_dist
    for k in range(1, K):
        samek = torch.zeros(B, dtype=torch.bool, device=keep.device)
        for j in range(k):
            samek |= ((_absdiff(pw1[:, k], pw1[:, j]) <= tol)
                      & (_absdiff(pw2[:, k], pw2[:, j]) <= tol)
                      & keep[:, j])
        keep[:, k] &= ~samek

    def fin_mates(c, w0k, stk):
        # each read repeated K times: one flattened traceback of B*K rows
        rep = {key: None if c[key] is None
               else c[key].repeat_interleave(K, dim=0)
               for key in ("reads", "rc", "lens", "mm", "mm_rc")}
        fin = finalize_best(rep, genome_words, n_genome, w0k.reshape(B * K),
                            stk.reshape(B * K), P)
        return {key: v.reshape((B, K) + v.shape[1:])
                for key, v in fin.items()}

    mapq = mapq_v2_end_to_end(
        top_vals[:, 0], torch.where(keep[:, 1], top_vals[:, 1], NEG_INF),
        keep[:, 1], score_min1 + score_min2)
    return dict(keep=keep, pair_score=top_vals, mapq=mapq,
                fin1=fin_mates(c1, pw1, pst1), fin2=fin_mates(c2, pw2, pst2))


def dispatch_pair_batch_all(mapper, batch1, batch2):
    """Enqueue the paired-end all-mapping device work of one pair of
    ``ReadBatch``es (``align_paired_all``)."""
    return align_paired_all(mapper.index, mapper.genome_words,
                            mapper.n_genome, *mapper.batch_tensors(batch1),
                            *mapper.batch_tensors(batch2), mapper.params)


def format_pair_batch_all(mapper, batch1, batch2, res) -> list[SamRecord]:
    """SAM records of a dispatched paired-end all-mapping batch: for each
    kept pair slot, mate 1 then mate 2 (proper, YT:Z:CP, the pair score as
    AS), the first slot primary and the others secondary (0x100, SEQ/QUAL
    ``*``); an unmapped pair of records where no slot is kept. The host
    formatting of ``nvbio_tpu.bowtie.paired.map_pair_batch_all``, plus the
    soft clips of local-mode CIGARs."""
    keep = res["keep"].cpu().numpy()
    mapqs = res["mapq"].cpu().numpy().tolist()
    pscores = res["pair_score"].cpu().numpy().tolist()
    B, K = keep.shape
    mates = []
    for batch, fin in ((batch1, res["fin1"]), (batch2, res["fin2"])):
        ops_dev = fin["ops"]
        f = {k: v.cpu().numpy() for k, v in fin.items() if k != "ops"}
        cis, locs = mapper.contig_of(
            (f["window_start"] + f["text_start"]).reshape(B * K))
        reads = HostReads(batch)
        mates.append(dict(
            reads=reads, lens=reads.lens, strand=f["strand"].tolist(),
            ci=cis.reshape(B, K).tolist(), local=locs.reshape(B, K).tolist(),
            nm=f["nm"].tolist(), n_ops=f["n_ops"].tolist(),
            simple=f["simple"].tolist(), ps=f["pattern_start"].tolist(),
            pe=f["pattern_end"].tolist(),
            ops=lazy_ops_rows(keep & ((f["nm"] > 0) | ~f["simple"]),
                              ops_dev)))
    names = mapper.ref_names
    rev_ops = use_pallas_extension(mapper.params)

    out = []
    for b, name in enumerate(batch1.names):
        if mates[0]["lens"][b] == 0:
            continue  # batch padding
        slots = np.flatnonzero(keep[b]).tolist()
        for rank, k in enumerate(slots):
            for m in range(2):
                me, ot = mates[m], mates[1 - m]
                strand = me["strand"][b][k]
                flag = (FLAG_PAIRED | FLAG_PROPER_PAIR
                        | (FLAG_FIRST_IN_PAIR if m == 0
                           else FLAG_SECOND_IN_PAIR)
                        | (FLAG_REVERSE if strand else 0)
                        | (FLAG_SECONDARY if rank else 0)
                        | (FLAG_MATE_REVERSE if ot["strand"][b][k] else 0))
                # secondary records omit SEQ and QUAL
                seq, qual = (("*", "*") if rank
                             else me["reads"].seq_qual(b, strand))
                nm = me["nm"][b][k]
                cigar, md_tags = alignment_fields(
                    me["ops"].get((b, k)), me["n_ops"][b][k], nm,
                    me["simple"][b][k], me["ps"][b][k], me["pe"][b][k],
                    me["lens"][b], rev_ops)
                out.append(SamRecord(
                    qname=name, flag=flag, rname=names[me["ci"][b][k]],
                    pos=me["local"][b][k] + 1,
                    mapq=mapqs[b] if rank == 0 else 0, cigar=cigar,
                    seq=seq, qual=qual, rnext="=",
                    pnext=ot["local"][b][k] + 1,
                    tags={"AS": pscores[b][k], "YT": "CP", "NM": nm,
                          **md_tags}))
        if not slots:
            for m in range(2):
                seq, qual = mates[m]["reads"].seq_qual(b)
                out.append(SamRecord(
                    qname=name,
                    flag=FLAG_PAIRED | FLAG_UNMAPPED
                    | (FLAG_FIRST_IN_PAIR if m == 0 else FLAG_SECOND_IN_PAIR),
                    rname="*", pos=0, mapq=0, cigar="*", seq=seq, qual=qual))
    return out


def map_pair_batch_all(mapper, batch1, batch2) -> list[SamRecord]:
    """Paired-end all-mapping of two ``ReadBatch``es -> SAM records."""
    return format_pair_batch_all(
        mapper, batch1, batch2,
        dispatch_pair_batch_all(mapper, batch1, batch2))
