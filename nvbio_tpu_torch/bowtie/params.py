"""Pipeline parameters (the analogue of nvBowtie's Params,
``nvBowtie/bowtie2/cuda/params.h:93-164``) — a hashable frozen dataclass.

Same fields and defaults as ``nvbio_tpu.bowtie.params.MapParams``, so one
set of values configures both packages (see ``nvbio_tpu_torch.convert``).
The port's pipeline implements the q-gram paths (single-end, paired-end,
local, all-mapping, the full-matrix mate traceback); fields of other paths
are kept for parity and rejected by the pipeline when they select a path
that is not ported yet. ``extension`` picks the engine
(``pipeline.use_pallas_extension``): ``"pallas"`` and ``"auto"`` the CUDA
kernels (their plain versions for CPU tensors), any other value
(``"scan"``) the aligner library's scan route, as in the JAX package."""

from __future__ import annotations

import dataclasses

from nvbio_tpu_torch.align.types import GotohScoring


@dataclasses.dataclass(frozen=True)
class MapParams:
    max_read_len: int = 128       # reads padded/bucketed to this (ref caps at 512)
    seed_len: int = 22            # bowtie2 default seed length
    # seed every `stride` bases. 0 = auto: bowtie2's interval function of
    # read length, -i S,1,1.15 -> ceil(1 + 1.15*sqrt(L)) at L=max_read_len
    # (the reference's seed_freq SimpleFunc, params.h:93-164 /
    # params.cpp:84-90; static per compiled batch shape, so evaluated at
    # the padded read length)
    seed_stride: int = 15
    hits_per_seed: int = 8        # SA rows located per seed (select width)
    # band radius for extension: the reference's default (params.cpp:121
    # max_dist = 15, band = 2*15+1 = 31). Wider bands are FASTER on the
    # register-tiled TPU kernel (fixed per-row costs amortize over more
    # band registers) as well as more indel-tolerant.
    max_dist: int = 15
    # Bowtie2 end-to-end defaults: match 0, mismatch -2..-6 by quality,
    # gap open 5 + first extend 3 => -8, extend -3.
    scoring: GotohScoring = GotohScoring(
        match=0, mismatch=-6,
        pattern_gap_open=-8, pattern_gap_ext=-3,
        text_gap_open=-8, text_gap_ext=-3,
    )
    # alignment mode: "end-to-end" (bowtie2 default) or "local"
    # (soft-clipped ends, match bonus, local MAPQ family —
    # params.cpp:113-158 --local)
    mode: str = "end-to-end"
    # min-score threshold, bowtie2 end-to-end default: -0.6 + -0.6 * L;
    # local mode uses G-type thresholds const + coeff * ln(L)
    score_min_const: float = -0.6
    score_min_coeff: float = -0.6
    score_min_log: bool = False
    # quality-dependent mismatch penalties (bowtie2 MX=6, MN=2)
    mm_penalty_min: int = 2
    mm_penalty_max: int = 6
    use_quality_penalties: bool = True
    # read-N scoring: flat --np penalty (bowtie2 default 1) charged at N
    # read positions instead of the quality mismatch cost, and the --n-ceil
    # filter f(L) = const + coeff*L (default L,0,0.15): reads with more Ns
    # are reported unmapped (the reference's N handling, scoring.h N_penalty)
    np_penalty: int = 1
    n_ceil_const: float = 0.0
    n_ceil_coeff: float = 0.15
    # seeding index: "qgram" (direct-address k-mer table, 2 gathers/seed — the
    # fast path) or "fmi" (FM-index backward search + sampled-SA locate — the
    # compact/bowtie2-faithful path)
    seeding: str = "qgram"
    qgram_q: int = 12
    # hit selection across seed ranges: "stratified" (deterministic jittered
    # grid, H slots per seed — the default) or "randomized" (SumTree-CDF
    # sampling: each of the per-read locate slots draws its seed with
    # probability proportional to 1/range^2, then a uniform slot within the
    # range — the reference select stage's randomized hit sampling,
    # select.h:52-80 / SumTree sum_tree.h:42-104). Replicated indexes only;
    # sharded paths keep the stratified grid.
    select_mode: str = "stratified"
    # extension scorer: "pallas" (TPU kernel), "scan" (XLA), or "auto"
    extension: str = "auto"
    # paired-end (bowtie2 defaults: -I 0 -X 500, fr orientation)
    minins: int = 0
    maxins: int = 500
    mate_rescue: bool = True
    # mate orientation policy (bowtie2 --fr/--rf/--ff; reference pe policies
    # params.h:115, aligner_best_approx_paired.h concordance tests)
    pe_policy: str = "fr"
    # report discordant pairs (both mates unique but not concordant;
    # aligner_best_approx_paired.h:280-286 mark_discordant)
    pe_discordant: bool = True
    # full-matrix traceback for paired-mate finalization (the reference's
    # opposite-mate full-DP traceback, aligner_best_approx_paired.h:404-479):
    # no band constraint inside the mate window, O(L*(T+L)) per mate — off
    # by default (the banded traceback covers max_dist of drift at ~1/20th
    # the cost; enable for indel-heavy libraries)
    pe_full_traceback: bool = False
    # multi-pass reseeding (the reference's `seeding_pass <= max_reseed`
    # loop with a reseed queue of unaligned reads,
    # aligner_best_approx.h:206,274-282). TPU re-expression: still-unaligned
    # reads are compacted to the front and re-seeded on a shifted seed grid
    # in a fixed-capacity sub-batch (ceil(B * reseed_frac) rows) — the
    # capacity-bounded queue semantics at static shapes.
    max_reseed: int = 1
    # queue capacity 1/8 of the batch: measured first-pass failure rates are
    # well under this (overflow is REPORTED via reseed_overflow when not),
    # and the reseed tax at this capacity is ~15% of batch time instead of
    # the 50% a quarter-batch queue cost
    reseed_frac: float = 0.125
    # 1-mismatch approximate seeding in reseed passes (q-gram key mutation;
    # the analogue of the reference's approx-hybrid seeding,
    # mapping.h:132-163). Reads whose every exact seed covers a SNP become
    # mappable through the mutated-key buckets.
    seeding_1mm: bool = True
    # unique-locus extension slots kept per strand half after the dedup
    # vote tournament (0 = auto: min(2*hits_per_seed, seeds*hits)). The
    # slots are evidence-ranked, so capping trades extension work for tail
    # sensitivity: measured on 100 Mbp (SLOT_STATS.json, 1%-error reads)
    # the winning slot ranks 0 in 99.7% of reads on uniform genomes; on a
    # 40%-repeat genome cap 8 keeps 99.15% of cap-12's 99.30% single-pass
    # sensitivity (the reseed pass recovers reads that fall under
    # score_min). nvBowtie's analogue is max-effort/trys bail-out
    # (reduce.h:45-64) — effort capped by evidence rank, not time.
    dedup_slots: int = 0
    # pass-0 whole-read exact matching on the FM path: before seeded
    # mapping, backward-search the ENTIRE read (both strands) and feed any
    # exact locus in as a guaranteed candidate — the reference's first
    # seeding pass maps the whole read exactly
    # (aligner_best_approx.h:162-166). q-gram seeding has no whole-read
    # search; the flag is ignored there.
    whole_read_exact: bool = True

    @classmethod
    def local(cls, **kw) -> "MapParams":
        """bowtie2 --local preset: match +2, quality mismatch 2..6, gaps
        5+3/3, score-min G,20,8 (20 + 8*ln L), soft-clipped output and the
        local MAPQ branch (``params.cpp:113-158``, ``mapq.h:267+``)."""
        kw.setdefault("scoring", GotohScoring(
            match=2, mismatch=-6,
            pattern_gap_open=-8, pattern_gap_ext=-3,
            text_gap_open=-8, text_gap_ext=-3,
        ))
        kw.setdefault("score_min_const", 20.0)
        kw.setdefault("score_min_coeff", 8.0)
        kw.setdefault("score_min_log", True)
        return cls(mode="local", **kw)

    @classmethod
    def edit_distance(cls, **kw) -> "MapParams":
        """nvBowtie's --ed mode (aligner_best_approx_ed): unit-cost edit
        distance — Gotoh with open == extend == mismatch == -1 IS the
        unit-cost DP, so the same fused kernels serve both modes. The
        threshold becomes "at most max_dist edits"."""
        max_dist = kw.pop("max_dist", 8)
        kw.setdefault("scoring", GotohScoring(
            match=0, mismatch=-1,
            pattern_gap_open=-1, pattern_gap_ext=-1,
            text_gap_open=-1, text_gap_ext=-1,
        ))
        kw.setdefault("use_quality_penalties", False)
        kw.setdefault("score_min_const", float(-max_dist))
        kw.setdefault("score_min_coeff", 0.0)
        return cls(max_dist=max_dist, **kw)

    def __post_init__(self):
        if self.seed_stride == 0:
            # bowtie2 -i S,1,1.15: interval = ceil(1 + 1.15 * sqrt(L))
            import math

            stride = math.ceil(1.0 + 1.15 * math.sqrt(self.max_read_len))
            object.__setattr__(self, "seed_stride", int(stride))

    @property
    def band(self) -> int:
        return 2 * self.max_dist + 1

    @property
    def seeds_per_strand(self) -> int:
        return max(1, (self.max_read_len - self.seed_len) // self.seed_stride + 1)

    @property
    def num_seeds(self) -> int:
        return 2 * self.seeds_per_strand  # both strands

    @property
    def nch(self) -> int:
        """Dedup slots per strand half (evidence-ranked, see dedup_slots)."""
        auto = min(self.hits_per_seed * 2,
                   self.seeds_per_strand * self.hits_per_seed)
        return min(self.dedup_slots, auto) if self.dedup_slots else auto

    @property
    def num_candidates(self) -> int:
        """Unique-locus extension slots after dedup (per read, both strands)."""
        return 2 * self.nch
