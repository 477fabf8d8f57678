"""Single-end read mapping pipeline, torch: seed -> locate -> dedup ->
extend -> reduce -> reseed -> traceback -> MAPQ -> SAM.

Port of ``nvbio_tpu.bowtie.pipeline``
(``read_candidates`` :207, ``finalize_best`` :627, ``align_batch_all``
:714, ``align_batch_core`` :809, ``ReadMapper`` :926). Every stage is
fixed-shape tensor code on the mapper's device, apart from the hand
kernels: candidate scoring (``align.kernels.banded_score_cands``, twice per
batch: first pass and reseed pass; LOCAL in local mode) and the fused
traceback
(``align.kernels.banded_traceback``, once per batch, LOCAL in local mode;
its wide form ``banded_traceback_wide`` for the full-matrix mate traceback
of ``finalize_best(..., full_matrix=True)``). All-mapping (``--all``,
``align_batch_all``) scores once, with no reseed pass, and traces every
candidate in one flattened call. That is the kernel route, the JAX
package's kernel path, which ``extension="pallas"`` and ``"auto"`` (the
default) take; where it sends local candidates to its flat scorer over
extracted windows (``pipeline.py:573-581``), the port computes the same
function in the candidate kernel, straight from the packed genome. Any
other ``extension`` (``"scan"``) takes the scan route, the JAX package's
engine off the accelerator: the aligner library's ``batch_score_banded``
over the B*C extracted windows, its ``batch_traceback_banded`` (or
``batch_traceback_full_scan``) and ``_md_pack_entries``, all plain torch
ops on the mapper's device, ops in forward order (``use_pallas_extension``).

Seeding is by a q-gram index (the direct-address ``QGramIndex`` or the
two-level ``QGroupIndex``) or, under ``seeding="fmi"``, by the FM index
(``fmi/``: backward search, rows of each SA interval located by the
sampled suffix array, the whole-read exact pass 0, and the approx-hybrid
1-mismatch search in the reseed pass; ``pipeline.py:330-373`` and
``:426-451`` of the JAX package). Hits are picked from each seed's range
by stratified slots or, under ``select_mode="randomized"``, by the SumTree
draws of ``_sumtree_select`` (``threefry.py`` gives ``jax.random``'s
bits). Positions are int64 throughout, so the JAX package's clip-at-zero
uint32 helpers become plain clamps, and its dtype-max sentinels become one
int64 constant ``_BIG`` compared by value.

The sharded indexes seed through branches of their own
(``pipeline.py:262-296`` and ``:384-409`` of the JAX package), inside a
step over the reads mesh (``parallel.mesh``): a ``ShardedQGramIndex``
(``parallel.sharded_index.sharded_seed_hits``, and in the reseed pass one
stratified slot of each mutated key's bucket, ``stratified_offsets(rs, 1,
NS*3q)``, not the middle slot) and a ``ShardedFMIndex``
(``fmi.sharded``: pass 0 keeps the first slice with a hit, and the reseed
pass takes the dense ``search_1mm``, 3s slots a seed, not the top-8 hybrid
search). Neither honours ``select_mode="randomized"``. So a sharded step
equals a replicated one only where the data make these the same.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nvbio_tpu_torch import packed, sumtree, threefry
from nvbio_tpu_torch.align.batch import batch_score_banded
from nvbio_tpu_torch.align.kernels import banded_score_cands
from nvbio_tpu_torch.align.traceback import (
    batch_traceback_banded,
    batch_traceback_banded_fast,
    batch_traceback_full,
    batch_traceback_full_scan,
    cigar_to_string,
    md_from_entries,
)
from nvbio_tpu_torch.align.types import (
    LOCAL,
    NEG_INF,
    SEMI_GLOBAL,
    GotohAligner,
)
from nvbio_tpu_torch.alphabet import _FROM_CODE, Alphabet
from nvbio_tpu_torch.bowtie.mapq import mapq_v2_end_to_end, mapq_v2_local
from nvbio_tpu_torch.bowtie.params import MapParams
from nvbio_tpu_torch.device import resolve_device
from nvbio_tpu_torch.fmi.index import FMIndex, attach_ftab, build_fmindex
from nvbio_tpu_torch.fmi.search import (
    backward_search_core,
    locate_core,
    search_1mm_hybrid_topk,
)
from nvbio_tpu_torch.fmi.sharded import (
    ShardedFMIndex,
    sharded_fmi_seed_hits,
    sharded_fmi_seed_hits_1mm,
    sharded_fmi_whole_read,
)
from nvbio_tpu_torch.index.device_sa import (
    build_fmindex_device,
    prefer_device_sa,
)
from nvbio_tpu_torch.io.sam import (
    FLAG_REVERSE,
    FLAG_SECONDARY,
    FLAG_UNMAPPED,
    SamRecord,
)
from nvbio_tpu_torch.parallel.sharded_index import (
    ShardedQGramIndex,
    sharded_seed_hits,
)
from nvbio_tpu_torch.qgram import (
    QGramIndex,
    QGroupIndex,
    build_qgram_index,
    index_locate,
    index_range,
    midpos_lookup,
    seed_keys_from_batch,
    stratified_locate_rows,
    stratified_offsets,
)
from nvbio_tpu_torch.utils.timers import count, span

# "no position" sentinel: larger than any genome position plus tolerance
_BIG = torch.iinfo(torch.int64).max

# what read_candidates seeds from (the sharded two placed on a mesh)
SeedIndex = (QGramIndex | QGroupIndex | FMIndex | ShardedQGramIndex
             | ShardedFMIndex)


def use_pallas_extension(params: MapParams) -> bool:
    """Whether candidate scoring, tracebacks and mate rescue take the
    kernel route (``"pallas"``, and ``"auto"``: the JAX package's
    ``"auto"`` takes its Pallas kernels on the accelerator) or the aligner
    library's scan route (any other value, ``"scan"`` in particular: the
    JAX package's engine off the accelerator, ``bowtie/pipeline.py:
    129-132``). The kernel route's op rows are END->START, the scan
    route's forward."""
    return params.extension in ("pallas", "auto")


def check_supported(params: MapParams) -> None:
    """Raise for parameter values that select a path not ported yet."""
    if params.seeding not in ("qgram", "fmi"):
        raise ValueError(f"unknown seeding {params.seeding!r}")
    if params.select_mode not in ("stratified", "randomized"):
        raise ValueError(f"unknown select_mode {params.select_mode!r}")
    if params.mode not in ("end-to-end", "local"):
        raise ValueError(f"unknown mode {params.mode!r}")


def host_rc_ascii(codes_np: np.ndarray) -> np.ndarray:
    """Reverse-complement ASCII matrix of a batch's codes (host-side);
    read b's rc occupies the TAIL of row b (slice [Lfull-len:])."""
    rc_table = _FROM_CODE[Alphabet.DNA_N][[3, 2, 1, 0, 4]]
    return rc_table[np.asarray(codes_np, np.uint8)][:, ::-1]


def soft_clipped(core: str, ps: int, pe: int, L: int) -> str:
    """CIGAR of an L-base read aligned over pattern span [ps, pe): the
    aligned ops ``core`` between soft clips (none in end-to-end mode)."""
    return (f"{ps}S" if ps else "") + core + (f"{L - pe}S" if pe < L else "")


class HostReads:
    """A ``ReadBatch``'s SEQ and QUAL as host ASCII planes, both strands."""

    def __init__(self, batch):
        codes = np.asarray(batch.codes, np.uint8)
        self.fwd = _FROM_CODE[Alphabet.DNA_N][codes]
        self.rc = host_rc_ascii(codes)
        self.q = np.asarray(batch.quals, np.uint8) + 33
        self.qr = self.q[:, ::-1]
        self.lens = np.asarray(batch.lengths).tolist()

    def seq_qual(self, b: int, reverse: bool = False) -> tuple[str, str]:
        """Read b's SEQ and QUAL as aligned: reverse-complemented (and
        QUAL reversed) on the reverse strand."""
        L = self.lens[b]
        if reverse:
            tail = slice(self.fwd.shape[1] - L, None)
            return (self.rc[b, tail].tobytes().decode(),
                    self.qr[b, tail].tobytes().decode())
        return (self.fwd[b, :L].tobytes().decode(),
                self.q[b, :L].tobytes().decode())


def alignment_fields(ops_row, n_ops: int, nm: int, simple: bool, ps: int,
                     pe: int, L: int, reverse: bool) -> tuple[str, dict]:
    """CIGAR (the aligned ops between soft clips) and the MD/XM/XO/XG tags
    of one alignment of an L-base read over pattern span [ps, pe). Its op
    row ``ops_row`` (END->START where ``reverse``, as the kernel route
    writes it; forward from the scan route) is read only where the
    alignment has gaps (not ``simple``) or edits (NM > 0)."""
    core = (f"{n_ops}M" if simple else
            cigar_to_string(ops_row, n_ops, reverse=reverse))
    if nm > 0:
        md, xm, xo, xg = md_from_entries(ops_row, n_ops, reverse=reverse)
    else:
        md, xm, xo, xg = str(n_ops), 0, 0, 0
    return soft_clipped(core, ps, pe, L), dict(MD=md, XM=xm, XO=xo, XG=xg)


def lazy_ops_rows(need: np.ndarray, ops) -> dict:
    """The op rows of ``ops`` where the host mask ``need`` holds (its
    leading dims): {b: row} for a 1-D mask, {(b, c): row} for a 2-D one.
    ``ops`` is a device tensor (its rows fetched in one gather) or a host
    array already fetched. Most mapped reads are all-M with NM = 0 and need
    none."""
    idx = np.nonzero(need)
    if not len(idx[0]):
        return {}
    if isinstance(ops, np.ndarray):
        rows = ops[idx]
    else:
        rows = ops[tuple(torch.from_numpy(i).to(ops.device)
                         for i in idx)].cpu().numpy()
    keys = (idx[0].tolist() if need.ndim == 1
            else list(zip(*(i.tolist() for i in idx))))
    return dict(zip(keys, rows))


@dataclasses.dataclass
class HostResult:
    """A dispatched batch's result tensors on their way to the host: copies
    into pinned host memory enqueued right behind the batch's kernels, and
    the CUDA event recorded after them (``None`` on the CPU, where the
    tensors are already the host's)."""

    tensors: dict
    event: torch.cuda.Event | None = None
    ordinal: int | None = None

    def wait(self) -> dict:
        """The results as numpy arrays, once this batch's copies are done;
        work enqueued after them (the next batch) is not waited for."""
        with span("wait", self.ordinal):
            if self.event is not None:
                self.event.synchronize()
            return {k: v.numpy() for k, v in self.tensors.items()}


def _mm_penalties(reads, quals, params: MapParams):
    """Bowtie2 quality-dependent mismatch penalty (positive magnitude);
    read-N positions charge the flat ``--np`` penalty."""
    if not params.use_quality_penalties:
        return None
    q = quals.to(torch.int32).clamp(max=40)
    span = params.mm_penalty_max - params.mm_penalty_min
    pen = params.mm_penalty_min + (span * q) // 40
    return torch.where(reads > 3, params.np_penalty, pen).to(torch.int32)


def n_ceil_of(reads, lens, params: MapParams):
    """bowtie2 ``--n-ceil``: reads with more Ns than const + coeff*len are
    filtered (float32 arithmetic, as the JAX package)."""
    L = reads.shape[1]
    in_len = (torch.arange(L, device=reads.device)[None, :]
              < lens[:, None])
    n_count = torch.sum((reads > 3) & in_len, dim=1, dtype=torch.int32)
    ceil = torch.floor(params.n_ceil_const
                       + params.n_ceil_coeff * lens.to(torch.float32))
    return n_count <= ceil.to(torch.int32)


def score_min_of(lens, params: MapParams):
    x = lens.to(torch.float32)
    if params.score_min_log:
        x = torch.log(torch.clamp(x, min=1.0))
    return torch.ceil(params.score_min_const
                      + params.score_min_coeff * x).to(torch.int32)


def _absdiff(a, b):
    return torch.maximum(a, b) - torch.minimum(a, b)


def _vote_reps(pv, valid, tol: int, n_reps: int):
    """Evidence-ranked locus tournament over the last axis.

    Each candidate's vote is the number of valid candidates within ``tol``;
    each round picks the (max votes, leftmost) cluster, emits its leftmost
    member and retires its members. Returns (reps, rep_valid) with a new
    last axis of ``n_reps``; missing reps are 0 / False."""
    pv = torch.where(valid, pv, _BIG)
    near = (_absdiff(pv[..., :, None], pv[..., None, :]) <= tol) & \
        valid[..., None, :]
    votes = torch.where(valid, near.sum(dim=-1, dtype=torch.int32), -1)
    reps, valids = [], []
    for _ in range(n_reps):
        m_v = votes.max(dim=-1).values
        any_v = m_v > 0
        picked = votes == m_v[..., None]
        sel = torch.where(picked, pv, _BIG).min(dim=-1).values
        members = (_absdiff(pv, sel[..., None]) <= tol) & (votes >= 0)
        rep = torch.where(members, pv, _BIG).min(dim=-1).values
        reps.append(torch.where(any_v, rep, _BIG))
        valids.append(any_v)
        votes = torch.where(members, -1, votes)
    rep = torch.stack(reps, dim=-1)
    rep_valid = torch.stack(valids, dim=-1) & (rep < _BIG)
    return torch.where(rep_valid, rep, 0), rep_valid


def reverse_strand(reads, lens):
    """Reverse complements of (B, L) int32 read codes by length; read Ns
    (code 4) reverse on their own plane and stay 4."""
    rc = 3 - packed.reverse_rows(reads.clamp(max=3), lens)
    return torch.where(
        packed.reverse_rows((reads > 3).to(torch.int32), lens) > 0, 4, rc)


def seed_grid(reads, rc, lens, params: MapParams, seed_phase: int = 0):
    """The seeds of both strands: S1 = ``params.seeds_per_strand`` starts
    ``seed_phase + i * seed_stride``; returns (starts (S1,), seeds (B, 2S1,
    seed_len) forward strand first, valid (B, 2S1): the seed lies inside
    the read and holds no N)."""
    P = params
    dev, L = reads.device, reads.shape[1]
    starts = seed_phase + torch.arange(P.seeds_per_strand, dtype=torch.int64,
                                       device=dev) * P.seed_stride
    gather = (starts[:, None] + torch.arange(P.seed_len, device=dev)[None, :]
              ).clamp(max=L - 1)
    seeds = torch.cat([reads[:, gather], rc[:, gather]], dim=1)
    seed_valid = (starts[None, :] + P.seed_len) <= lens[:, None]
    seed_valid2 = torch.cat([seed_valid, seed_valid], dim=1)
    return starts, seeds, seed_valid2 & ~torch.any(seeds > 3, dim=-1)


# the key of randomized hit selection: fold_in(PRNGKey(_SELECT_SEED), phase)
_SELECT_SEED = 0x5E1EC7


def _sumtree_select(lo, range_size, seed_valid2, starts, S1: int, H: int,
                    seed_phase: int):
    """SumTree-CDF randomized hit selection (``select.h:52-80``; the JAX
    package's ``_sumtree_select``, ``pipeline.py:135-182``).

    Each strand half draws its S1*H slots: which seed to locate from, with
    probability proportional to 1/range^2 (specific seeds get the budget),
    then a uniform slot within that seed's range. The uniforms are
    ``jax.random.uniform(fold_in(fold_in(PRNGKey(0x5E1EC7), seed_phase),
    h), (2, B, S1*H))`` for half h, bit for bit. Returns (lo_c, slot,
    seed_off, valid), all (B, 2*S1, H): the chosen seed's range start, the
    slot within it, the chosen seed's read offset, draw validity."""
    B = lo.shape[0]
    key = threefry.fold_in(threefry.prng_key(_SELECT_SEED), seed_phase)
    outs = []
    for h in (0, 1):
        sl = slice(h * S1, (h + 1) * S1)
        rs_h = range_size[:, sl]
        rsf = rs_h.to(torch.float32)
        w = torch.where(seed_valid2[:, sl] & (rs_h > 0),
                        1.0 / (rsf * rsf + 1e-30), 0.0)
        uk, us = threefry.uniform(threefry.fold_in(key, h),
                                  (2, B, S1 * H), lo.device)
        choice = sumtree.sample_columns(w, uk)               # (B, S1*H)
        rs_c = torch.gather(rs_h, 1, choice)
        slot = torch.minimum((us * rs_c.to(torch.float32)).to(torch.int64),
                             (rs_c - 1).clamp(min=0))
        valid = (w.sum(dim=-1) > 0)[:, None] & (rs_c > 0)
        outs.append((torch.gather(lo[:, sl], 1, choice), slot,
                     starts[choice], valid))
    return tuple(torch.cat([o[i].reshape(B, S1, H) for o in outs], dim=1)
                 for i in range(4))


def _append_offsets(sel_off, starts, k: int):
    """``sel_off`` (B, 2S1, H) with k more columns holding each row's own
    seed offset (extra hits of a seed row belong to that seed); None stays
    None."""
    if sel_off is None:
        return None
    B, NS, _ = sel_off.shape
    own = torch.cat([starts, starts])[None, :, None].expand(B, NS, k)
    return torch.cat([sel_off, own], dim=-1)


def _append_pass0(pos, hit_valid, pos_e, ok_e, B: int, S1: int):
    """Append the pass-0 whole-read exact loci (fwd = pos_e[:B], rc =
    pos_e[B:]) as 2 extra hit columns on the offset-0 seed rows of each
    strand, twice: the duplicate is a free extra vote in the dedup, so a
    pass-0 locus cannot lose its slot to single-seed repeat loci."""
    NS = pos.shape[1]
    extra_pos = torch.zeros((B, NS, 2), dtype=pos.dtype, device=pos.device)
    extra_ok = torch.zeros((B, NS, 2), dtype=torch.bool, device=pos.device)
    extra_pos[:, 0, :] = pos_e[:B, None]
    extra_pos[:, S1, :] = pos_e[B:, None]
    extra_ok[:, 0, :] = ok_e[:B, None]
    extra_ok[:, S1, :] = ok_e[B:, None]
    return (torch.cat([pos, extra_pos], dim=-1),
            torch.cat([hit_valid, extra_ok], dim=-1))


def fm_seed_ranges(index: FMIndex, seeds):
    """SA intervals of (B, NS, s) seeds by backward search: (lo, size),
    each (B, NS) int64."""
    B, NS, slen = seeds.shape
    lo, hi = backward_search_core(
        index, seeds.reshape(B * NS, slen),
        torch.full((B * NS,), slen, dtype=torch.int64, device=seeds.device))
    return lo.reshape(B, NS), (hi - lo).clamp(min=0).reshape(B, NS)


def fm_locate_rows(index: FMIndex, rows):
    """Text positions of SA rows (any shape), clipped to [0, n]."""
    pos, _ = locate_core(index, rows.clamp(0, index.n).reshape(-1))
    return pos.reshape(rows.shape)


def fm_seed_hits(index: FMIndex, seeds, seed_valid2, H: int):
    """FM seeding of (B, NS, s) seeds: backward search, H stratified rows
    of each SA interval (``qgram.stratified_offsets``) located. Returns
    (pos (B, NS, H) int64, hit_valid)."""
    lo, range_size = fm_seed_ranges(index, seeds)
    k = torch.arange(H, device=seeds.device)
    hit_valid = (k < range_size[:, :, None]) & seed_valid2[:, :, None]
    rows = lo[:, :, None] + stratified_offsets(range_size, H, seeds.shape[1])
    return fm_locate_rows(index, rows), hit_valid


def fm_whole_read(index: FMIndex, reads, rc, lens):
    """Pass 0: both strands of every read backward-searched whole, the
    middle row of each interval located. Returns (pos (2B,), ok (2B,)):
    forward strands first."""
    q2 = torch.cat([reads.clamp(max=3), rc.clamp(max=3)])
    l2 = torch.cat([lens, lens])
    lo, hi = backward_search_core(index, q2, l2)
    pos, _ = locate_core(index, (lo + (hi - lo) // 2).clamp(0, index.n))
    ok = (hi > lo) & (l2 > 0) & ~torch.any(torch.cat([reads, rc]) > 3, dim=1)
    return pos, ok


def fm_seed_hits_1mm(index: FMIndex, seeds):
    """The FM reseed pass's 1-mismatch loci: ``search_1mm_hybrid_topk``
    over the seeds ((seed_len+1)//2 approximate positions, 8 survivors a
    seed, as the JAX package), the middle row of each range located.
    Returns (pos (B, NS, 8), nonempty)."""
    B, NS, slen = seeds.shape
    _, _, mm_lo, mm_hi = search_1mm_hybrid_topk(
        index, seeds.reshape(B * NS, slen),
        torch.full((B * NS,), slen, dtype=torch.int64, device=seeds.device),
        (slen + 1) // 2, K=8)
    pos, _ = locate_core(
        index, (mm_lo + (mm_hi - mm_lo) // 2).clamp(0, index.n).reshape(-1))
    return (pos.reshape(B, NS, -1),
            (mm_hi - mm_lo).reshape(B, NS, -1) > 0)


def _seed_loci(index: SeedIndex, n_genome: int, reads, rc, lens,
               params: MapParams, seed_phase: int, approx_1mm: bool):
    """The seeding stage of ``read_candidates``: the seed grid looked up in
    the index (backward-searched and located in an FM index), pass 0 and
    the 1-mismatch loci. Returns (w0, valid) of (B, 2CH) candidate windows,
    forward strand first, and CH, the candidates of a strand."""
    P = params
    dev = reads.device
    B = reads.shape[0]
    S1 = P.seeds_per_strand
    H = P.hits_per_seed
    starts, seeds, seed_valid2 = seed_grid(reads, rc, lens, P, seed_phase)
    randomized = P.select_mode == "randomized"
    sel_off = None   # (B, 2S1, H) read offset of each randomized draw's seed

    if isinstance(index, ShardedFMIndex):
        # genome-sliced FM indexes, one a rank: local backward search,
        # answers routed home by all_to_all
        pos, hvalid, _ = sharded_fmi_seed_hits(index, seeds, P.seed_len, H)
        hit_valid = hvalid & seed_valid2[:, :, None]
        if P.whole_read_exact and seed_phase == 0:
            q2 = torch.cat([reads.clamp(max=3), rc.clamp(max=3)])
            l2 = torch.cat([lens, lens])
            pos_e, ok_e = sharded_fmi_whole_read(index, q2, l2)
            ok_e = ok_e & (l2 > 0) & \
                ~torch.any(torch.cat([reads, rc]) > 3, dim=1)
            pos, hit_valid = _append_pass0(pos, hit_valid, pos_e, ok_e, B, S1)
            H = H + 2
    elif isinstance(index, ShardedQGramIndex):
        # bucket-range shards, one a rank: all-gathered keys, masked
        # answers all-reduced
        keys = seed_keys_from_batch(seeds, index.q)          # (B, 2S1)
        pos, range_size = sharded_seed_hits(index, keys, H)
        k = torch.arange(H, device=dev)
        hit_valid = (k[None, None, :] < range_size[:, :, None]) & \
            seed_valid2[:, :, None]
    elif isinstance(index, FMIndex):
        if randomized:
            lo, range_size = fm_seed_ranges(index, seeds)
            lo_c, slot, sel_off, hit_valid = _sumtree_select(
                lo, range_size, seed_valid2, starts, S1, H, seed_phase)
            pos = fm_locate_rows(index, lo_c + slot)
        else:
            pos, hit_valid = fm_seed_hits(index, seeds, seed_valid2, H)
        if P.whole_read_exact and seed_phase == 0:
            pos_e, ok_e = fm_whole_read(index, reads, rc, lens)
            pos, hit_valid = _append_pass0(pos, hit_valid, pos_e, ok_e, B, S1)
            sel_off = _append_offsets(sel_off, starts, 2)
            H = H + 2
    else:
        keys = seed_keys_from_batch(seeds, index.q)          # (B, 2S1)
        lo, hi = index_range(index, keys)
        range_size = (hi - lo).clamp(min=0)
        if randomized:
            lo_c, slot, sel_off, hit_valid = _sumtree_select(
                lo, range_size, seed_valid2, starts, S1, H, seed_phase)
            pos = index_locate(index, lo_c, slot)
        else:
            k = torch.arange(H, device=dev)
            hit_valid = (k[None, None, :] < range_size[:, :, None]) & \
                seed_valid2[:, :, None]
            if isinstance(index, QGroupIndex):
                # per-slot locate (the JAX package's slot layout for it)
                pos = index_locate(index, lo[:, :, None],
                                   stratified_offsets(range_size, H, 2 * S1))
            else:
                pos = stratified_locate_rows(index, lo, range_size, H,
                                             2 * S1)

    if approx_1mm:
        if isinstance(index, ShardedFMIndex):
            # the dense 1-mismatch search of each seed against each slice
            pos1, nonempty = sharded_fmi_seed_hits_1mm(index, seeds,
                                                       P.seed_len)
        elif isinstance(index, FMIndex):
            # approx-hybrid 1-mismatch ranges of each seed, the middle row
            # of each nonempty range located
            pos1, nonempty = fm_seed_hits_1mm(index, seeds)
        else:
            # every single-symbol mutation of each seed key, one bucket
            # entry each
            qq = index.q
            jj = torch.arange(qq, dtype=torch.int32, device=dev)
            dd = torch.arange(1, 4, dtype=torch.int32, device=dev)
            xor = (dd[None, :] << (2 * (qq - 1 - jj))[:, None]).reshape(
                3 * qq)
            mut_keys = keys[:, :, None] ^ xor[None, None, :]  # (B, NS, 3q)
            if isinstance(index, ShardedQGramIndex):
                # one stratified slot of each mutated bucket:
                # floor(j * r / (NS * 3q)) for column j, not the middle
                NS = mut_keys.shape[1]
                p1, rs1 = sharded_seed_hits(
                    index, mut_keys.reshape(B, NS * 3 * qq), 1)
                pos1 = p1.reshape(B, NS, 3 * qq)
                nonempty = rs1.reshape(B, NS, 3 * qq) > 0
            elif getattr(index, "mid_pos", None) is not None:
                pos1, nonempty = midpos_lookup(index, mut_keys)
            else:   # the middle slot of each range (a Q-Group index)
                lo1, hi1 = index_range(index, mut_keys)
                rs1 = (hi1 - lo1).clamp(min=0)
                pos1, nonempty = index_locate(index, lo1, rs1 // 2), rs1 > 0
        # a within-seed vote keeps the two best-supported loci
        valid1 = nonempty & seed_valid2[:, :, None]
        NK = 2
        pos_extra, valid_extra = _vote_reps(pos1, valid1, 2 * P.max_dist, NK)
        pos = torch.cat([pos, pos_extra], dim=-1)
        hit_valid = torch.cat([hit_valid, valid_extra], dim=-1)
        sel_off = _append_offsets(sel_off, starts, NK)
        H = H + NK

    # candidate window start: seed offset within the (strand) read (each
    # draw's own seed under randomized selection), slack of max_dist on
    # each side
    seed_off = (torch.cat([starts, starts])[None, :, None] if sel_off is None
                else sel_off)
    w0 = (pos - (seed_off + P.max_dist)).clamp(min=0)
    w0 = w0.clamp(max=max(n_genome - 1, 0))
    CH = S1 * H
    w0 = w0.reshape(B, 2 * CH)
    cand_valid_all = hit_valid.reshape(B, 2 * CH)
    return w0, cand_valid_all, CH


def read_candidates(index: SeedIndex, genome_words,
                    n_genome: int, reads, lens, quals, params: MapParams,
                    seed_phase: int = 0, approx_1mm: bool = False):
    """Seed + locate + dedup + extension-score candidates for one batch.

    Returns a dict of per-candidate (B, C) tensors (scores, w0, strand,
    valid) plus the per-read strands and penalty planes. ``seed_phase``
    shifts the seed grid (reseed passes); ``approx_1mm`` adds the
    1-mismatch loci (two per seed, by a within-seed vote). A q-gram index
    (``QGramIndex`` or ``QGroupIndex``) seeds by direct lookup, an
    ``FMIndex`` by backward search and locate (plus, in the first pass
    under ``whole_read_exact``, the whole-read exact pass 0). Each seed's
    hits are its stratified slots, or the SumTree draws of
    ``_sumtree_select`` under ``select_mode="randomized"``. A placed
    ``ShardedFMIndex`` or ``ShardedQGramIndex`` seeds through its own
    branch (module docstring), with collectives over its mesh: every rank
    of the mesh must make the same calls.
    """
    P = params
    check_supported(P)
    want = ((FMIndex, ShardedFMIndex) if P.seeding == "fmi"
            else (QGramIndex, QGroupIndex, ShardedQGramIndex))
    if not isinstance(index, want):
        raise TypeError(f"seeding={P.seeding!r} needs a "
                        f"{' or '.join(w.__name__ for w in want)}, "
                        f"not a {type(index).__name__}")
    dev = reads.device
    B, L = reads.shape
    W = P.band
    TW = L + W - 1
    reads = reads.to(torch.int32)
    lens = lens.to(torch.int32)

    rc = reverse_strand(reads, lens)
    pen = _mm_penalties(reads, quals, P)
    mm = None if pen is None else -pen
    mm_rc = None if pen is None else -packed.reverse_rows(pen, lens)
    with span("seed"):
        w0, cand_valid_all, CH = _seed_loci(index, n_genome, reads, rc,
                                            lens, P, seed_phase,
                                            approx_1mm)

    # ---- dedup to unique loci per strand (evidence-ranked) -----------------
    NCH = min(P.nch, CH)
    tol = 2 * P.max_dist
    with span("vote"):
        w0f, validf = _vote_reps(w0[:, :CH], cand_valid_all[:, :CH], tol,
                                 NCH)
        w0r, validr = _vote_reps(w0[:, CH:], cand_valid_all[:, CH:], tol,
                                 NCH)
    C = 2 * NCH
    w0 = torch.cat([w0f, w0r], dim=1).contiguous()           # (B, C) int64
    cand_valid = torch.cat([validf, validr], dim=1)
    cand_strand = (torch.arange(C, device=dev) >= NCH)[None, :].expand(B, C)
    # of the B x C slots that the scorer below fills, those that hold a
    # candidate
    count("cand_valid", cand_valid)
    count("cand_slots", B * C)

    # ---- extension scoring -------------------------------------------------
    wlens = (n_genome - w0).clamp(min=0, max=TW).to(torch.int32)
    local = P.mode == "local"
    with span("extend"):
        if use_pallas_extension(P):
            # local mode: the JAX kernel path's local branch scores B*C
            # extracted windows with its flat LOCAL scorer; the same
            # function, read from the packed genome
            sc, _ = banded_score_cands(
                reads.contiguous(), rc.contiguous(), lens, w0, wlens,
                genome_words, P.scoring, W, NCH, mm, mm_rc, local=local)
        else:
            # the scan route: the library's banded scorer over the B*C
            # windows (the JAX package's batch_score_banded,
            # pipeline.py:573-587)
            flip = cand_strand[:, :, None]
            pats = torch.where(flip, rc[:, None, :], reads[:, None, :])
            mm_flat = None if mm is None else torch.where(
                flip, mm_rc[:, None, :], mm[:, None, :]).reshape(B * C, L)
            aligner = GotohAligner(LOCAL if local else SEMI_GLOBAL,
                                   P.scoring)
            sc = batch_score_banded(
                pats.reshape(B * C, L),
                lens[:, None].expand(B, C).reshape(B * C),
                packed.extract_window(genome_words, w0.reshape(B * C), TW,
                                      2),
                wlens.reshape(B * C), aligner, W, mm_flat).score.reshape(B, C)
    scores = torch.where(cand_valid, sc, NEG_INF)

    return dict(scores=scores, w0=w0, strand=cand_strand, valid=cand_valid,
                reads=reads, lens=lens, rc=rc, mm=mm, mm_rc=mm_rc)


def _reduce_best2(cands, params: MapParams):
    """(best_score, best_pos, best_strand, second_score): the first-max
    candidate and the best score at a distinct locus."""
    scores, w0, strand = cands["scores"], cands["w0"], cands["strand"]
    best_idx = torch.argmax(scores, dim=1)[:, None]
    best_score = torch.gather(scores, 1, best_idx)[:, 0]
    best_pos = torch.gather(w0, 1, best_idx)[:, 0]
    best_strand = torch.gather(strand, 1, best_idx)[:, 0]
    same_locus = (_absdiff(w0, best_pos[:, None]) <= 2 * params.max_dist) & \
        (strand == best_strand[:, None])
    second_score = torch.where(same_locus, NEG_INF, scores).max(dim=1).values
    return best_score, best_pos, best_strand, second_score


def _md_pack_entries(tb, bpat, btext):
    """(packed MD entries in forward order, NM) of a scan-route traceback:
    each op's entry op | mismatch << 2 | (reference symbol & 15) << 3, the
    layout the kernel walk writes; NM counts mismatches, I and D. Port of
    the JAX function (``bowtie/pipeline.py:598-630``)."""
    L = bpat.shape[1]
    TW = btext.shape[1]
    ops = tb.ops
    is_m, is_i, is_d = ops == 1, ops == 2, ops == 3
    pat_cursor = (torch.cumsum((is_m | is_i).to(torch.int32), dim=1) - 1
                  + tb.pattern_start[:, None])
    txt_cursor = (torch.cumsum((is_m | is_d).to(torch.int32), dim=1) - 1
                  + tb.text_start[:, None])
    pat_sym = torch.gather(bpat, 1, pat_cursor.clamp(0, L - 1).long())
    txt_sym = torch.gather(btext, 1, txt_cursor.clamp(0, TW - 1).long())
    mism = is_m & (pat_sym != txt_sym)
    nm = (mism | is_i | is_d).sum(dim=1, dtype=torch.int32)
    entries = torch.where(
        ops != 0, ops | (mism.to(torch.int32) << 2) | ((txt_sym & 15) << 3),
        0).to(torch.int32)
    return entries, nm


def _traceback(bpat, blens, btext, btlen, params: MapParams, mm, band: int,
               local: bool, full_matrix: bool = False):
    """(TracebackResult with packed entries, nm) of the chosen windows by
    ``params``' route: the fused kernel (K2, or K2-WIDE for
    ``full_matrix``; END->START) or the scan route's library traceback
    with ``_md_pack_entries`` (forward)."""
    sc = params.scoring
    if use_pallas_extension(params):
        if full_matrix:
            return batch_traceback_full(bpat, blens, btext, btlen, sc, mm,
                                        local=local)
        return batch_traceback_banded_fast(bpat, blens, btext, btlen, sc,
                                           band, mm, local=local)
    aligner = GotohAligner(LOCAL if local else SEMI_GLOBAL, sc)
    if full_matrix:
        tb = batch_traceback_full_scan(bpat, blens, btext, btlen, aligner, mm)
    else:
        tb = batch_traceback_banded(bpat, blens, btext, btlen, aligner, band,
                                    mm)
    entries, nm = _md_pack_entries(tb, bpat, btext)
    return tb._replace(ops=entries), nm


def finalize_best(cands, genome_words, n_genome: int, best_pos, best_strand,
                  params: MapParams, full_matrix: bool = False):
    """Traceback + NM of each read's chosen candidate over the
    re-extracted winning windows (``_traceback``: the fused traceback
    kernel, or the scan route's; LOCAL in local mode). ``full_matrix=True``
    takes the full-matrix traceback instead (no band inside the window:
    the paired-end mates of ``pe_full_traceback``)."""
    P = params
    W = P.band
    reads, lens, rc = cands["reads"], cands["lens"], cands["rc"]
    mm, mm_rc = cands["mm"], cands["mm_rc"]
    L = reads.shape[1]
    TW = L + W - 1

    btext = packed.extract_window(genome_words, best_pos, TW, 2)
    btlen = (n_genome - best_pos).clamp(min=0, max=TW).to(torch.int32)
    bpat = torch.where(best_strand[:, None], rc, reads).contiguous()
    bmm = (None if mm is None
           else torch.where(best_strand[:, None], mm_rc, mm).contiguous())
    tb, nm = _traceback(bpat, lens, btext, btlen, P, bmm, W,
                        P.mode == "local", full_matrix)

    # pure-match reads (no I/D): their CIGAR is just "{L}M"; the host needs
    # their op rows only when NM > 0 (for the MD tag)
    simple = (tb.n_ops == lens) & ((tb.text_end - tb.text_start) == lens)
    ent = tb.ops
    opc = ent & 3
    vmask = (torch.arange(ent.shape[1], device=ent.device)[None, :]
             < tb.n_ops[:, None])
    subs = torch.sum(vmask & (opc == 1) & (((ent >> 2) & 1) == 1), dim=1,
                     dtype=torch.int32)
    ins = torch.sum(vmask & (opc == 2), dim=1, dtype=torch.int32)
    dels = torch.sum(vmask & (opc == 3), dim=1, dtype=torch.int32)
    return dict(
        strand=best_strand, window_start=best_pos,
        text_start=tb.text_start, pattern_start=tb.pattern_start,
        pattern_end=tb.pattern_end, ops=tb.ops.to(torch.uint8),
        n_ops=tb.n_ops, nm=nm, subs=subs, ins=ins, dels=dels, simple=simple,
        tb_score=tb.score,
    )


def align_batch_core(index: SeedIndex, genome_words,
                     n_genome: int, reads, lens, quals, params: MapParams):
    """Map one dense batch of reads (single-end); per-read result tensors.

    One seeding + extension pass, then one capacity-bounded reseed pass per
    ``max_reseed``: still-unaligned reads are compacted (stable) to the
    front of a queue of B2 rows, re-seeded on a shifted grid with 1-mismatch
    seeding, re-scored, and scattered back where they improved. Then the
    traceback of each read's winner and MAPQ.
    """
    P = params
    B = reads.shape[0]
    cands = read_candidates(index, genome_words, n_genome, reads, lens,
                            quals, P)
    lens = cands["lens"]
    best_score, best_pos, best_strand, second_score = _reduce_best2(cands, P)
    score_min = score_min_of(lens, P)

    reseed_overflow = torch.zeros((1,), dtype=torch.int32, device=reads.device)
    if P.max_reseed > 0 and B > 1:
        tol = 2 * P.max_dist
        B2 = max(8, min(B, int(round(B * P.reseed_frac / 8)) * 8))
        for p in range(1, P.max_reseed + 1):
            with span("reseed"):
                phase = (p * P.seed_stride) // (P.max_reseed + 1)
                needs = (best_score < score_min) & (lens >= P.seed_len)
                n_needs = needs.sum(dtype=torch.int32)
                count("reseed_needed", n_needs)
                count("reseed_rows", B2)
                reseed_overflow = torch.maximum(
                    reseed_overflow, (n_needs - B2).clamp(min=0)[None])
                order = torch.argsort(torch.where(needs, 0, 1).to(
                    torch.int32), stable=True)
                sel = order[:B2]
                c2 = read_candidates(
                    index, genome_words, n_genome, cands["reads"][sel],
                    lens[sel], quals[sel], P, seed_phase=phase,
                    approx_1mm=P.seeding_1mm)
                bs2, bp2, bstr2, sec2 = _reduce_best2(c2, P)
                old_b, old_p = best_score[sel], best_pos[sel]
                old_st, old_sec = best_strand[sel], second_score[sel]
                sm2, sub_needs = score_min[sel], needs[sel]
                improved = (bs2 > old_b) & sub_needs
                diff_locus = (_absdiff(bp2, old_p) > tol) | (bstr2 != old_st)
                # the displaced old best becomes a distinct-locus second
                new_sec = torch.maximum(
                    sec2, torch.where(diff_locus, old_b, old_sec))
                # a non-improving distinct hit still informs the second-best
                sec_keep = torch.maximum(
                    old_sec, torch.where(diff_locus & (bs2 >= sm2), bs2,
                                         NEG_INF))
                best_score = best_score.clone()
                best_pos = best_pos.clone()
                best_strand = best_strand.clone()
                second_score = second_score.clone()
                best_score[sel] = torch.where(improved, bs2, old_b)
                best_pos[sel] = torch.where(improved, bp2, old_p)
                best_strand[sel] = torch.where(improved, bstr2, old_st)
                second_score[sel] = torch.where(
                    improved, new_sec,
                    torch.where(sub_needs, sec_keep, old_sec))

    with span("finalize"):
        fin = finalize_best(cands, genome_words, n_genome, best_pos,
                            best_strand, P)
        mapped = (best_score >= score_min) & (lens >= P.seed_len) & \
            n_ceil_of(reads, lens, P)
        has_second = second_score >= score_min
        if P.mode == "local":
            mapq = mapq_v2_local(best_score, second_score, has_second,
                                 score_min, P.scoring.match * lens)
        else:
            mapq = mapq_v2_end_to_end(best_score, second_score, has_second,
                                      score_min)
        mapq = torch.where(mapped, mapq, 0)
    out = dict(mapped=mapped, best_score=best_score,
               second_score=second_score, has_second=has_second,
               reseed_overflow=reseed_overflow, mapq=mapq)
    for key in ("strand", "window_start", "text_start", "pattern_start",
                "pattern_end", "ops", "n_ops", "nm", "subs", "ins", "dels",
                "simple"):
        out[key] = fin[key]
    return out


def align_batch_all(index: SeedIndex, genome_words,
                    n_genome: int, reads, lens, quals, params: MapParams):
    """All-mapping of one dense batch (single-end): a traceback of every
    candidate of every read, in one flattened (B*C) call of the traceback
    kernel; ``keep`` marks the candidates above threshold, ``is_best`` the
    primary. Port of ``nvbio_tpu.bowtie.pipeline.align_batch_all`` (:714),
    which traces SEMI_GLOBAL in local mode too and gives the primary the
    end-to-end MAPQ; the port follows it. Returns (B, C) tensors, ``ops``
    (B, C, MAXS) uint8 (END->START on the kernel route), and the (B,)
    ``mapq``."""
    P = params
    W = P.band
    cands = read_candidates(index, genome_words, n_genome, reads, lens,
                            quals, P)
    scores, w0 = cands["scores"], cands["w0"]
    lens, reads, rc = cands["lens"], cands["reads"], cands["rc"]
    mm, mm_rc = cands["mm"], cands["mm_rc"]
    B, C = scores.shape
    L = reads.shape[1]
    TW = L + W - 1

    score_min = score_min_of(lens, P)
    keep = cands["valid"] & (scores >= score_min[:, None]) & \
        (lens[:, None] >= P.seed_len) & n_ceil_of(reads, lens, P)[:, None]
    best_idx = torch.argmax(scores, dim=1)
    is_best = torch.arange(C, device=scores.device)[None, :] == \
        best_idx[:, None]

    with span("finalize"):
        # every candidate flattened into one traceback batch, read-major
        w0f = w0.reshape(B * C)
        btext = packed.extract_window(genome_words, w0f, TW, 2)
        btlen = (n_genome - w0f).clamp(min=0, max=TW).to(torch.int32)
        strand = cands["strand"].expand(B, C)
        flip = strand.reshape(B * C)[:, None]
        bpat = torch.where(flip, rc.repeat_interleave(C, dim=0),
                           reads.repeat_interleave(C, dim=0))
        blens = lens.repeat_interleave(C)
        bmm = None if mm is None else torch.where(
            flip, mm_rc.repeat_interleave(C, dim=0),
            mm.repeat_interleave(C, dim=0))
        tb, nm = _traceback(bpat, blens, btext, btlen, P, bmm, W, local=False)
        simple = (tb.n_ops == blens) & ((tb.text_end - tb.text_start) == blens)

        # the primary's MAPQ: the best-only reduce
        best_score, _, _, second_score = _reduce_best2(cands, P)
        has_second = second_score >= score_min
        mapq = mapq_v2_end_to_end(best_score, second_score, has_second,
                                  score_min)
    return dict(
        keep=keep, is_best=is_best, scores=scores, strand=strand,
        window_start=w0, text_start=tb.text_start.reshape(B, C),
        ops=tb.ops.to(torch.uint8).reshape(B, C, -1),
        n_ops=tb.n_ops.reshape(B, C), nm=nm.reshape(B, C),
        simple=simple.reshape(B, C), mapq=mapq,
    )


@dataclasses.dataclass
class ReadMapper:
    """Host-side driver owning the device index and reference metadata."""

    index: QGramIndex | FMIndex  # on ``device``, per ``params.seeding``
    genome_words: torch.Tensor   # int32 bits of the packed uint32 genome
    n_genome: int
    ref_names: list
    ref_offsets: np.ndarray
    params: MapParams
    device: torch.device
    # batches dispatched: the ordinal of a batch's dispatch, fetch and wait
    # spans
    dispatched: int = dataclasses.field(default=0, repr=False,
                                        compare=False)

    @classmethod
    def build(cls, reference, params: MapParams = MapParams(), index=None,
              device=None) -> "ReadMapper":
        """From an ``io.Reference`` (host): builds the seeding index of
        ``params.seeding`` unless given (a q-gram index on the host, or an
        FM index: on the card where ``prefer_device_sa`` says so, as the
        JAX package does on an accelerator, else by host SA-IS; the index
        is the same either way), then moves index and genome to ``device``
        (``cuda`` unless the caller passes ``device="cpu"``). On cuda an FM
        index without a k-mer table gets the k = 11 one, built on the card
        (the JAX package attaches it off the CPU only; results do not
        depend on it)."""
        dev = resolve_device(device)
        check_supported(params)
        if index is None:
            if params.seeding == "fmi" and prefer_device_sa(
                    reference.total_length, dev):
                index = build_fmindex_device(reference.codes, device=dev)
            elif params.seeding == "fmi":
                index = build_fmindex(reference.codes)
            else:
                index = build_qgram_index(reference.codes, params.qgram_q,
                                          n_flags=reference.n_flags())
        index = index.to(dev)
        if (isinstance(index, FMIndex) and index.ftab_lo is None
                and dev.type == "cuda"):
            index = attach_ftab(index, k=11)
        return cls(
            index=index,
            genome_words=packed.words_to_tensor(reference.packed_words(),
                                                dev),
            n_genome=reference.total_length,
            ref_names=reference.names,
            ref_offsets=reference.offsets,
            params=params,
            device=dev,
        )

    def contig_of(self, gpos: np.ndarray):
        """(contig index, 0-based position within it) of each genome
        position of an int64 array."""
        ci = np.searchsorted(self.ref_offsets, gpos, side="right") - 1
        return ci, gpos - self.ref_offsets[np.clip(ci, 0, None)]

    def next_ordinal(self) -> int:
        """The ordinal of the batch about to be dispatched."""
        self.dispatched += 1
        return self.dispatched - 1

    def batch_tensors(self, batch):
        """(codes, lengths, quals) of a ``ReadBatch`` as int32 tensors on
        the mapper's device.

        On CUDA each copy is from pageable host memory: a
        ``cudaMemcpyAsync`` that CUDA stages behind the stream's earlier
        work, then a ``cudaStreamSynchronize``. So the host waits
        here until the batch dispatched before it is done (``map`` and the
        benchmark dispatch batch i+1 before they wait on batch i): 35.9 ms
        (q-gram seeding) and 38.9 ms (FM) of host time for a batch of 2^18
        150-base reads on an H100, the card idle 3.5-10.3 ms of it."""
        def t(a, dtype=None):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(
                self.device).to(torch.int32)

        with span("upload"):
            return t(batch.codes), t(batch.lengths, np.int32), t(batch.quals)

    def dispatch(self, batch) -> dict:
        """Enqueue the device work of one ``ReadBatch``; returns device
        tensors (asynchronous on CUDA until read)."""
        with span("dispatch", self.next_ordinal()):
            return align_batch_core(self.index, self.genome_words,
                                    self.n_genome,
                                    *self.batch_tensors(batch), self.params)

    def map_batch(self, batch) -> list[SamRecord]:
        """Map a ReadBatch -> SAM records (host-side formatting)."""
        return self.format_batch(batch, self.dispatch(batch))

    def dispatch_all(self, batch) -> dict:
        """Enqueue the all-mapping device work of one ``ReadBatch``
        (``align_batch_all``)."""
        with span("dispatch", self.next_ordinal()):
            return align_batch_all(self.index, self.genome_words,
                                   self.n_genome, *self.batch_tensors(batch),
                                   self.params)

    def map_batch_all(self, batch) -> list[SamRecord]:
        """All-mapping: every above-threshold locus of each read, the
        primary first, then the secondaries (flag 0x100, SEQ/QUAL ``*``)."""
        return self.format_batch_all(batch, self.dispatch_all(batch))

    def format_batch_all(self, batch, res) -> list[SamRecord]:
        """SAM records of a dispatched all-mapping batch: the host
        formatting of ``nvbio_tpu``'s ``ReadMapper.map_batch_all``."""
        ops_dev = res["ops"]
        res = {k: v.cpu().numpy() for k, v in res.items() if k != "ops"}
        keep = res["keep"]
        need = keep & ((res["nm"] > 0) | ~res["simple"])
        ops_of = lazy_ops_rows(need, ops_dev)
        B, C = keep.shape
        cis, locs = self.contig_of(
            (res["window_start"] + res["text_start"]).reshape(B * C))
        cis, locs = cis.reshape(B, C).tolist(), locs.reshape(B, C).tolist()
        scores, strands = res["scores"].tolist(), res["strand"].tolist()
        is_best, nms = res["is_best"].tolist(), res["nm"].tolist()
        n_ops_l, simple = res["n_ops"].tolist(), res["simple"].tolist()
        mapqs = res["mapq"].tolist()
        rev_ops = use_pallas_extension(self.params)

        reads = HostReads(batch)
        out = []
        for b, name in enumerate(batch.names):
            L = reads.lens[b]
            if L == 0:
                continue  # batch padding
            kept = np.flatnonzero(keep[b]).tolist()
            if not kept:
                seq, qual = reads.seq_qual(b)
                out.append(SamRecord(
                    qname=name, flag=FLAG_UNMAPPED, rname="*", pos=0,
                    mapq=0, cigar="*", seq=seq, qual=qual))
                continue
            # the primary first, then by score (a stable sort)
            order = sorted(kept, key=lambda c: (not is_best[b][c],
                                                -scores[b][c]))
            for rank, c in enumerate(order):
                strand = strands[b][c]
                # secondary records omit SEQ and QUAL
                seq, qual = ("*", "*") if rank else reads.seq_qual(b, strand)
                cigar, md_tags = alignment_fields(
                    ops_of.get((b, c)), n_ops_l[b][c], nms[b][c],
                    simple[b][c], 0, L, L, rev_ops)
                out.append(SamRecord(
                    qname=name,
                    flag=(FLAG_REVERSE if strand else 0)
                    | (FLAG_SECONDARY if rank else 0),
                    rname=self.ref_names[cis[b][c]], pos=locs[b][c] + 1,
                    mapq=mapqs[b] if rank == 0 else 0, cigar=cigar,
                    seq=seq, qual=qual,
                    tags={"AS": scores[b][c], "NM": nms[b][c], **md_tags}))
        return out

    def fetch(self, res: dict) -> HostResult:
        """Enqueue the device->host copy of every result tensor of a
        dispatched batch (what formatting, the stats and the debug records
        read, the whole op plane included); ``format_fetched`` reads them.

        On one CUDA stream a copy issued after the next batch's dispatch
        would wait for that batch's kernels too, so the copies go in now,
        each into a fresh pinned buffer (the caching host allocator reuses
        a block only once its copy has completed and nothing holds it),
        followed by one event. On the CPU nothing is copied. The result
        carries the ordinal of the batch dispatched last."""
        ordinal = self.dispatched - 1
        with span("fetch", ordinal):
            if self.device.type == "cpu":
                return HostResult(dict(res), ordinal=ordinal)
            host = {}
            for k, v in res.items():
                host[k] = torch.empty(v.shape, dtype=v.dtype,
                                      pin_memory=True)
                host[k].copy_(v, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            return HostResult(host, event, ordinal)

    def format_batch(self, batch, res) -> list[SamRecord]:
        ops_dev = res["ops"]  # fetched below only for rows that need it
        res = {k: v.cpu().numpy() for k, v in res.items() if k != "ops"}
        return self._records(batch, res, ops_dev)

    def format_fetched(self, batch, host: dict) -> list[SamRecord]:
        """``format_batch``'s records from ``fetch(res).wait()``: the same
        records, read from the host arrays alone."""
        return self._records(batch, host, host["ops"])

    def _records(self, batch, res: dict, ops) -> list[SamRecord]:
        """SAM records of a batch from its host result arrays ``res``;
        ``ops`` (device tensor or host array) holds the op rows."""
        reads = HostReads(batch)
        mapped = res["mapped"].tolist()
        strands = res["strand"].tolist()
        cis, locals_ = self.contig_of(res["window_start"] + res["text_start"])
        cis, locals_ = cis.tolist(), locals_.tolist()
        mapqs = res["mapq"].tolist()
        scores = res["best_score"].tolist()
        nms = res["nm"].tolist()
        has2 = res["has_second"].tolist()
        second = res["second_score"].tolist()
        n_ops_l = res["n_ops"].tolist()
        pat_starts = res["pattern_start"].tolist()
        pat_ends = res["pattern_end"].tolist()
        ops_of = lazy_ops_rows(
            res["mapped"] & ((res["nm"] > 0) | ~res["simple"]), ops)
        simple = res["simple"].tolist()
        rev_ops = use_pallas_extension(self.params)

        out = []
        for b, name in enumerate(batch.names):
            L = reads.lens[b]
            if L == 0:
                continue  # batch padding
            if not mapped[b]:
                seq, qual = reads.seq_qual(b)
                out.append(SamRecord(
                    qname=name, flag=FLAG_UNMAPPED, rname="*", pos=0,
                    mapq=0, cigar="*", seq=seq, qual=qual))
                continue
            strand = strands[b]
            seq, qual = reads.seq_qual(b, strand)
            tags = {"AS": scores[b], "NM": nms[b]}
            if has2[b]:
                tags["XS"] = second[b]
            cigar, md_tags = alignment_fields(
                ops_of.get(b), n_ops_l[b], nms[b], simple[b], pat_starts[b],
                pat_ends[b], L, rev_ops)
            tags.update(md_tags)
            out.append(SamRecord(
                qname=name, flag=FLAG_REVERSE if strand else 0,
                rname=self.ref_names[cis[b]], pos=locals_[b] + 1,
                mapq=mapqs[b], cigar=cigar, seq=seq, qual=qual, tags=tags))
        return out
