"""MEM mapping pipeline: SMEM -> chain -> local extension -> soft-clipped SAM.

Port of ``nvbio_tpu.mem.pipeline``, the nvmem call stack
(``nvmem/nvmem.cu:46-150``): mem_search -> mem_locate -> build_chains ->
filter_chains -> banded local Gotoh extension. Every stage is a dense
batched transform on the mapper's device, both strands folded into the
batch. The extension of every kept chain of every read and strand is ONE
launch of the fused local traceback (K2-LOCAL,
``align.traceback.batch_traceback_banded_fast(..., local=True)``), the
walk the JAX package takes on its accelerator; its ops come END->START and
the host formatter reverses them. SAM formatting stays on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nvbio_tpu_torch import packed
from nvbio_tpu_torch.align.traceback import (
    batch_traceback_banded_fast,
    cigar_to_string,
)
from nvbio_tpu_torch.align.types import NEG_INF, GotohScoring
from nvbio_tpu_torch.alphabet import Alphabet, codes_to_string
from nvbio_tpu_torch.fmi.mem import find_smems_batch
from nvbio_tpu_torch.io.sam import (
    FLAG_REVERSE,
    FLAG_SECONDARY,
    FLAG_UNMAPPED,
    SamRecord,
    quals_to_string,
)
from nvbio_tpu_torch.mem.chain import chain_anchors_topk


@dataclasses.dataclass(frozen=True)
class MemParams:
    max_read_len: int = 256
    min_seed_len: int = 19          # bwa-mem -k
    max_smems: int = 16
    hits_per_smem: int = 4
    max_dist: int = 16              # extension band radius
    # bwa-mem scoring: A=1 B=4 O=6 E=1 (gap_open includes first extension)
    scoring: GotohScoring = GotohScoring(
        match=1, mismatch=-4,
        pattern_gap_open=-7, pattern_gap_ext=-1,
        text_gap_open=-7, text_gap_ext=-1,
    )
    chain_max_gap: int = 1000
    chain_bandwidth: int = 100
    min_score: int = 30             # bwa-mem -T
    max_chains: int = 2             # chains kept/extended per strand
                                    # (nvmem per-read chain lists,
                                    # nvmem/pipeline.h:107-147)

    @property
    def band(self) -> int:
        return 2 * self.max_dist + 1


def both_strands(reads, lens):
    """(rc, reads2, lens2): the reverse complements (tail past each
    length: 3 - 0) and both strands folded into the batch, rows [0, B)
    forward and [B, 2B) reverse complement."""
    reads = reads.to(torch.int32)
    lens = lens.to(torch.int32).to(reads.device)
    rc = 3 - packed.reverse_rows(reads, lens)
    return rc, torch.cat([reads, rc], dim=0), torch.cat([lens, lens], dim=0)


def kept_chains(fmi_rev, reads2, lens2, params: MemParams):
    """The SMEMs of every row, their located hits as anchors (S·H a row)
    and the ``max_chains`` best chains of those anchors (TopChains)."""
    P = params
    sm = find_smems_batch(fmi_rev, reads2, lens2, P.min_seed_len,
                          P.max_smems, P.hits_per_smem)
    R, S, H = sm.tpos.shape

    def flat(x):
        return x.expand(R, S, H).reshape(R, S * H)

    return chain_anchors_topk(flat(sm.qbeg[:, :, None]),
                              flat(sm.qend[:, :, None]), flat(sm.tpos),
                              flat(sm.hit_valid), P.max_chains,
                              max_gap=P.chain_max_gap,
                              bandwidth=P.chain_bandwidth)


def extension_inputs(genome_words, n_genome: int, reads2, lens2, ch,
                     params: MemParams):
    """K2-LOCAL's inputs for every kept chain of every row, flattened to
    (2B*K) lanes: (reads, lengths, genome windows of L + W - 1 symbols
    from ``tbeg - qbeg - max_dist``, window lengths, window starts)."""
    P = params
    K = ch.valid.shape[1]
    L = reads2.shape[1]
    W = P.band
    TW = L + W - 1
    w0 = (ch.tbeg - ch.qbeg - P.max_dist).clamp(0, max(n_genome - 1, 0))
    w0f = w0.reshape(-1)
    win = packed.extract_window(genome_words, w0f, TW)
    wlens = (n_genome - w0f).clamp(0, TW).to(torch.int32)
    return (torch.repeat_interleave(reads2, K, dim=0),
            torch.repeat_interleave(lens2, K), win, wlens, w0f)


def mem_align_core(fmi_rev, genome_words, n_genome: int, reads, lens,
                   params: MemParams) -> dict:
    """Best local alignment per read via the MEM pipeline, both strands:
    (B,) and (B, 2K) tensors on the reads' device (candidates: the forward
    strand's K chains, then the reverse strand's)."""
    P = params
    B = reads.shape[0]
    dev = reads.device
    rc, reads2, lens2 = both_strands(reads, lens)
    ch = kept_chains(fmi_rev, reads2, lens2, P)           # fields (2B, K)
    K = ch.valid.shape[1]

    # local banded extension around EVERY kept chain (the reference's
    # repeated align() passes over the chain list, nvmem/nvmem.cu:128-149),
    # one launch over the (2B*K) lanes
    reads_f, lens_f, win, wlens, w0f = extension_inputs(
        genome_words, n_genome, reads2, lens2, ch, P)
    tb, _nm = batch_traceback_banded_fast(reads_f, lens_f, win, wlens,
                                          P.scoring, P.band, local=True)
    score = torch.where(ch.valid.reshape(-1), tb.score.to(torch.int64),
                        NEG_INF)

    # combine strands: per read, 2K candidates (forward K, then rc K)
    def fold(x):
        x = x.reshape(2 * B, K)
        return torch.cat([x[:B], x[B:]], dim=1)            # (B, 2K)

    cscore = fold(score)
    cops = tb.ops.reshape(2 * B, K, -1)
    cops = torch.cat([cops[:B], cops[B:]], dim=1)          # (B, 2K, MAXS)
    cand = torch.arange(2 * K, dtype=torch.int64, device=dev)[None, :]
    cstrand = cand >= K

    best_idx = torch.argmax(cscore, dim=1)
    best = torch.gather(cscore, 1, best_idx[:, None])[:, 0]
    is_best = cand == best_idx[:, None]
    second = torch.where(is_best, NEG_INF, cscore).max(dim=1).values
    mapped = best >= P.min_score
    # int32 floor division in the JAX package; only unmapped reads (score
    # below min_score) have a negative numerator, and they get MAPQ 0
    mq = ((60 * (best - second.clamp(min=0)))
          // best.clamp(min=1)).clamp(0, 60)

    return dict(
        mapped=mapped,
        is_best=is_best,
        cand_mapped=cscore >= P.min_score,
        score=cscore,
        strand=cstrand.expand(B, 2 * K),
        window_start=fold(w0f),
        text_start=fold(tb.text_start),
        pattern_start=fold(tb.pattern_start),
        pattern_end=fold(tb.pattern_end),
        ops=cops,
        n_ops=fold(tb.n_ops),
        mapq=torch.where(mapped, mq, 0),
        rc_reads=rc,
    )


@dataclasses.dataclass
class MemMapper:
    fmi_rev: object            # fmi.index.FMIndex of the reversed genome
    genome_words: torch.Tensor
    n_genome: int
    ref_names: list
    ref_offsets: np.ndarray
    params: MemParams
    device: torch.device

    @classmethod
    def build(cls, reference, params: MemParams = MemParams(),
              device=None) -> "MemMapper":
        """The FM index of the reversed genome, built on the card
        (``index.device_sa.build_fmindex_device``) or, with
        ``device="cpu"``, by host SA-IS (``fmi.index.build_fmindex``);
        cuda unless the caller asks for the CPU."""
        from nvbio_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        rev = reference.codes[::-1].copy()
        if dev.type == "cuda":
            from nvbio_tpu_torch.index.device_sa import build_fmindex_device

            fmi_rev = build_fmindex_device(rev, device=dev)
        else:
            from nvbio_tpu_torch.fmi.index import build_fmindex

            fmi_rev = build_fmindex(rev)
        return cls(
            fmi_rev=fmi_rev.to(dev),
            genome_words=packed.words_to_tensor(reference.packed_words(),
                                                dev),
            n_genome=reference.total_length,
            ref_names=reference.names,
            ref_offsets=reference.offsets,
            params=params,
            device=dev,
        )

    def dispatch(self, batch) -> dict:
        """The batch's device results (enqueued, not synchronized)."""
        reads = torch.from_numpy(np.asarray(batch.codes, np.int32))
        lens = torch.from_numpy(np.asarray(batch.lengths, np.int32))
        return mem_align_core(self.fmi_rev, self.genome_words,
                              self.n_genome, reads.to(self.device),
                              lens.to(self.device), self.params)

    def format_batch(self, batch, res: dict) -> list[SamRecord]:
        """SAM records of a dispatched batch (host): per mapped read the
        primary, then the other candidates at or above ``min_score`` as
        secondaries in descending score order, ``AS`` on each and ``XA``
        on the primary; soft clips from the pattern start and end."""
        res = {k: v.cpu().numpy() for k, v in res.items()}
        out = []
        for b, name in enumerate(batch.names):
            if batch.lengths[b] == 0:
                continue
            L = int(batch.lengths[b])
            fwd_seq = codes_to_string(batch.codes[b, :L], Alphabet.DNA)
            if not res["mapped"][b]:
                out.append(SamRecord(
                    qname=name, flag=FLAG_UNMAPPED, rname="*", pos=0, mapq=0,
                    cigar="*", seq=fwd_seq,
                    qual=quals_to_string(batch.quals[b], L),
                ))
                continue

            def fields(c):
                strand = bool(res["strand"][b, c])
                gpos = int(res["window_start"][b, c]) + int(
                    res["text_start"][b, c])
                ci = int(np.searchsorted(self.ref_offsets, gpos,
                                         side="right") - 1)
                local = gpos - int(self.ref_offsets[ci])
                ps = int(res["pattern_start"][b, c])
                pe = int(res["pattern_end"][b, c])
                core = cigar_to_string(res["ops"][b, c], res["n_ops"][b, c],
                                       reverse=True)
                cigar = ((f"{ps}S" if ps else "") + core
                         + (f"{L - pe}S" if pe < L else ""))
                return strand, ci, local, cigar

            # primary first, then the other above-threshold chains as
            # secondaries (repeat loci, nvmem multi-alignment output)
            cands = np.flatnonzero(res["cand_mapped"][b])
            prim = int(np.flatnonzero(res["is_best"][b])[0])
            order = [prim] + sorted(
                (c for c in cands.tolist() if c != prim),
                key=lambda c: -int(res["score"][b, c]))
            xa = []
            for c in order[1:]:
                strand, ci, local, cigar = fields(c)
                xa.append(f"{self.ref_names[ci]},"
                          f"{'-' if strand else '+'}{local + 1},{cigar},0")
            for rank, c in enumerate(order):
                strand, ci, local, cigar = fields(c)
                if rank == 0:
                    seq = (codes_to_string(res["rc_reads"][b, :L],
                                           Alphabet.DNA)
                           if strand else fwd_seq)
                    qual = (quals_to_string(batch.quals[b, :L][::-1], L)
                            if strand else quals_to_string(batch.quals[b], L))
                else:  # SAM: secondary records omit seq/qual
                    seq, qual = "*", "*"
                tags = {"AS": int(res["score"][b, c])}
                if rank == 0 and xa:
                    tags["XA"] = ";".join(xa) + ";"
                out.append(SamRecord(
                    qname=name,
                    flag=(FLAG_REVERSE if strand else 0)
                    | (FLAG_SECONDARY if rank else 0),
                    rname=self.ref_names[ci], pos=local + 1,
                    mapq=int(res["mapq"][b]) if rank == 0 else 0,
                    cigar=cigar, seq=seq, qual=qual, tags=tags,
                ))
        return out

    def map_batch(self, batch) -> list[SamRecord]:
        return self.format_batch(batch, self.dispatch(batch))
