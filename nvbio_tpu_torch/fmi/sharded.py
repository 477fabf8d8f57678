"""The genome-sliced FM index, served over the reads mesh.

Port of ``nvbio_tpu.fmi.sharded``. The q-gram table shards by bucket
range (``parallel.sharded_index``); the FM index shards by GENOME RANGE:
backward search is a walk over global ranks, so the text is cut into D
slices (each with ``overlap`` symbols of the next one, so a match across a
seam is found by the earlier slice) and each slice gets its own compact
index, one a rank. Queries are all-gathered, every rank answers all of
them from its slice, and ``all_to_all`` routes each rank the answers to
its own reads from every slice: dense fixed-shape transfers only.

Positions are int64 throughout; the JAX package forms global positions in
uint32 (``d * slice_len + pos_local``), which the int64 ones equal below
2^32. A hit belongs to the slice it starts in (``pos_local < slice_len``)
and must start inside the genome (the last slice is wrap-padded with the
genome's start).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from nvbio_tpu_torch.fmi.index import FMIndex, build_fmindex
from nvbio_tpu_torch.fmi.search import (
    backward_search_core,
    locate_core,
    search_1mm,
)
from nvbio_tpu_torch.parallel.mesh import ReadsMesh, all_gather, all_to_all
from nvbio_tpu_torch.qgram import stratified_offsets

# the per-slice tables, stacked on dim 0 (``primary`` is a host tensor)
_TABLES = ("bwt_words", "occ", "count", "ssa_marks", "ssa_cum", "ssa_vals",
           "rank_rows", "ssa_rows")


@dataclasses.dataclass
class ShardedFMIndex:
    """D per-slice FM indexes of one shape, their tables stacked on dim 0
    (``shard_fmindex``), or one rank's row of them on its card
    (``place_sharded_fmindex``: ``mesh`` set, dim 0 of size 1). The fused
    rank rows of the port's ``fmi.rank`` take the place of the JAX
    package's ``ranktab``."""

    n_shards: int
    slice_len: int          # symbols a slice, without the overlap tail
    overlap: int
    n: int                  # genome length
    sa_interval: int
    bwt_words: torch.Tensor
    occ: torch.Tensor
    count: torch.Tensor
    primary: torch.Tensor   # int64[D|1], on the host
    ssa_marks: torch.Tensor
    ssa_cum: torch.Tensor
    ssa_vals: torch.Tensor
    rank_rows: torch.Tensor
    ssa_rows: torch.Tensor
    mesh: ReadsMesh | None = None

    def to(self, device) -> "ShardedFMIndex":
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f in _TABLES})

    def rows(self, rank: int) -> "ShardedFMIndex":
        """A view of one rank's slice (dim 0 of size 1)."""
        return dataclasses.replace(self, primary=self.primary[rank:rank + 1],
                                   **{f: getattr(self, f)[rank:rank + 1]
                                      for f in _TABLES})

    def nbytes(self) -> int:
        return sum(getattr(self, f).numel() * getattr(self, f).element_size()
                   for f in _TABLES)


def _fm_fields(fmi: FMIndex) -> dict:
    """The tables of a slice's index as host numpy arrays (what a build
    worker sends back) plus its scalars."""
    out = {f: getattr(fmi, f).cpu().numpy() for f in _TABLES}
    out.update(primary=fmi.primary, n=fmi.n, sa_interval=fmi.sa_interval)
    return out


def _build_slice_worker(arg) -> dict:
    """A host build of one slice in a spawned child (picklable): one torch
    thread, the port's native SA-IS; returns ``_fm_fields``."""
    torch.set_num_threads(1)
    codes, method = arg
    return _fm_fields(build_fmindex(codes, method=method))


def _stack(subs: list[dict], n_shards, slice_len, overlap, n) -> \
        ShardedFMIndex:
    def stack(f):
        return torch.stack([torch.as_tensor(s[f]) for s in subs])

    return ShardedFMIndex(
        n_shards=n_shards, slice_len=slice_len, overlap=overlap, n=n,
        sa_interval=int(subs[0]["sa_interval"]),
        primary=torch.tensor([int(s["primary"]) for s in subs],
                             dtype=torch.int64),
        **{f: stack(f) for f in _TABLES})


def shard_fmindex(codes: np.ndarray, n_shards: int, overlap: int = 256,
                  method: str = "auto", jobs: int = 1,
                  resident: bool = False, on_slice=None,
                  device=None) -> ShardedFMIndex:
    """D per-slice FM indexes of identical shapes.

    Slice d covers [d * slice_len, d * slice_len + slice_len + overlap);
    a short tail is padded by wrapping to the genome's start, so every
    slice has one length (the padding's hits are dropped at query time).
    ``method`` is the suffix sort of ``fmi.index.build_fmindex`` (``"auto"``
    and the host methods), or ``"device"``: the whole index of each slice
    built on ``device`` (cuda unless the caller asks for the CPU) by
    ``index.device_sa.build_fmindex_device``, one slice after another.
    ``jobs > 1`` builds host-method slices in that many spawned processes.
    ``resident`` keeps device-built tables on ``device`` (stacked there,
    ``on_slice(d, seconds)`` called after each slice); otherwise the
    stacked tables are host tensors."""
    n = len(codes)
    slice_len = (n + n_shards - 1) // n_shards
    full = slice_len + overlap
    slices = []
    for d in range(n_shards):
        sl = codes[d * slice_len:d * slice_len + full]
        if len(sl) < full:  # wrap-pad so every slice has one length
            sl = np.concatenate([sl, codes[:full - len(sl)]])
        slices.append(np.ascontiguousarray(sl, np.uint8))
    if jobs > 1 and method != "device":
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(min(jobs, n_shards)) as pool:
            subs = pool.map(_build_slice_worker,
                            [(sl, method) for sl in slices])
    elif resident and method == "device":
        from nvbio_tpu_torch.index.device_sa import build_fmindex_device

        subs = []
        for d, sl in enumerate(slices):
            t0 = time.time()
            fx = build_fmindex_device(sl, device=device)
            fields = {f: getattr(fx, f) for f in _TABLES}
            fields.update(primary=fx.primary, sa_interval=fx.sa_interval)
            subs.append(fields)
            if on_slice:
                if fx.device.type == "cuda":
                    torch.cuda.synchronize(fx.device)
                on_slice(d, time.time() - t0)
    else:
        subs = [_fm_fields(build_fmindex(sl, method=method, device=device))
                for sl in slices]
    return _stack(subs, n_shards, slice_len, overlap, n)


def place_sharded_fmindex(mesh: ReadsMesh,
                          sidx: ShardedFMIndex) -> ShardedFMIndex:
    """This rank's slice on its card, bound to ``mesh`` (its primary row
    stays on the host)."""
    if sidx.n_shards != mesh.size:
        raise ValueError(f"{sidx.n_shards} slices on a mesh of {mesh.size}")
    if sidx.bwt_words.shape[0] != sidx.n_shards:
        raise ValueError("place_sharded_fmindex takes the stacked slices")
    return dataclasses.replace(sidx.rows(mesh.rank).to(mesh.device),
                               mesh=mesh)


def _local_fmi(sidx: ShardedFMIndex) -> FMIndex:
    """This rank's slice as a regular ``FMIndex`` (a view of row 0)."""
    return FMIndex(
        bwt_words=sidx.bwt_words[0], occ=sidx.occ[0], count=sidx.count[0],
        primary=int(sidx.primary[0]), n=sidx.slice_len + sidx.overlap,
        sa_interval=sidx.sa_interval, ssa_marks=sidx.ssa_marks[0],
        ssa_cum=sidx.ssa_cum[0], ssa_vals=sidx.ssa_vals[0],
        rank_rows=sidx.rank_rows[0], ssa_rows=sidx.ssa_rows[0])


def _global(sidx: ShardedFMIndex, pos_local, valid):
    """(global positions, valid & the hit starts in this rank's slice and
    inside the genome)."""
    gpos = sidx.mesh.rank * sidx.slice_len + pos_local
    return gpos, valid & (pos_local < sidx.slice_len) & (gpos < sidx.n)


def _merge_valid_first(cand, cval, k: int):
    """The first k of each row's slots, valid ones first (a stable order:
    shard 0's hits ahead)."""
    order = torch.argsort(torch.where(cval, 0, 1).to(torch.int32), dim=-1,
                          stable=True)[..., :k]
    return (torch.gather(cand, -1, order), torch.gather(cval, -1, order))


def sharded_fmi_seed_hits(sidx: ShardedFMIndex, seeds, seed_len: int,
                          H: int):
    """Pipeline seeding against the placed genome-sliced index.

    seeds: (b, NS, s) seed symbols of this rank's reads. Every rank
    backward-searches every rank's seeds against its slice, locates H
    stratified rows of each interval and routes the answers home; each
    (read, seed) keeps the first H valid of its D*H slots. Returns (pos
    (b, NS, H) global int64, valid (b, NS, H), range_size (b, NS) summed
    over the slices)."""
    mesh = sidx.mesh
    fmi = _local_fmi(sidx)
    all_seeds = all_gather(mesh, seeds)                 # (D, b, NS, s)
    Dn, b, NS, slen = all_seeds.shape
    flat = all_seeds.reshape(Dn * b * NS, slen)
    lo, hi = backward_search_core(fmi, flat, torch.full(
        (flat.shape[0],), seed_len, dtype=torch.int64, device=flat.device))
    rs = (hi - lo).clamp(min=0)                         # (D*b*NS,)
    off = stratified_offsets(rs.reshape(Dn * b, NS), H, NS).reshape(
        Dn * b * NS, H)
    rows = (lo[:, None] + off).clamp(0, fmi.n)
    pos_local, resolved = locate_core(fmi, rows.reshape(-1))
    pos_local = pos_local.reshape(Dn * b * NS, H)
    resolved = resolved.reshape(Dn * b * NS, H)
    k = torch.arange(H, device=flat.device)
    gpos, gvalid = _global(sidx, pos_local,
                           (k[None, :] < rs[:, None]) & resolved)
    # piece d of each plane goes to rank d: its reads' answers
    gpos = all_to_all(mesh, gpos.reshape(Dn, b, NS, H))
    gvalid = all_to_all(mesh, gvalid.reshape(Dn, b, NS, H))
    range_size = all_to_all(mesh, rs.reshape(Dn, b, NS)).sum(dim=0)
    pos, valid = _merge_valid_first(
        gpos.permute(1, 2, 0, 3).reshape(b, NS, Dn * H),
        gvalid.permute(1, 2, 0, 3).reshape(b, NS, Dn * H), H)
    return pos, valid, range_size


def sharded_fmi_whole_read(sidx: ShardedFMIndex, queries, qlens):
    """Pass 0's whole-read exact search against the placed sliced index:
    every rank backward-searches every rank's reads ((b, L) symbols
    clipped to ACGT, (b,) lengths) against its slice and locates the
    middle row of each interval; per query the first slice with a hit
    wins. Returns (pos (b,) global int64, valid (b,))."""
    mesh = sidx.mesh
    fmi = _local_fmi(sidx)
    allq = all_gather(mesh, queries)                    # (D, b, L)
    alll = all_gather(mesh, qlens)                      # (D, b)
    Dn, b, L = allq.shape
    lo, hi = backward_search_core(fmi, allq.reshape(Dn * b, L),
                                  alll.reshape(Dn * b))
    ploc, resolved = locate_core(fmi, (lo + (hi - lo) // 2).clamp(0, fmi.n))
    gpos, gvalid = _global(sidx, ploc, (hi > lo) & resolved)
    gpos = all_to_all(mesh, gpos.reshape(Dn, b))
    gvalid = all_to_all(mesh, gvalid.reshape(Dn, b))
    first = torch.argmax(gvalid.to(torch.uint8), dim=0)     # (b,)
    return (torch.gather(gpos, 0, first[None, :])[0], gvalid.any(dim=0))


def sharded_fmi_seed_hits_1mm(sidx: ShardedFMIndex, seeds, seed_len: int):
    """1-mismatch seeding against the placed sliced index: every rank runs
    the dense ``search_1mm`` of every rank's seeds against its slice (3s
    mutated searches a seed), locates the middle row of each nonempty
    range and routes the answers home; per (read, seed) the D*3s slots
    merge valid-first down to 3s. seeds: (b, NS, s). Returns (pos (b, NS,
    3s) global int64, valid (b, NS, 3s))."""
    mesh = sidx.mesh
    fmi = _local_fmi(sidx)
    all_seeds = all_gather(mesh, seeds)                 # (D, b, NS, s)
    Dn, b, NS, slen = all_seeds.shape
    NM3 = 3 * slen
    flat = all_seeds.reshape(Dn * b * NS, slen)
    _, _, mm_lo, mm_hi, _ = search_1mm(fmi, flat, torch.full(
        (flat.shape[0],), seed_len, dtype=torch.int64, device=flat.device))
    mm_lo, mm_hi = mm_lo.reshape(-1), mm_hi.reshape(-1)
    ploc, resolved = locate_core(
        fmi, (mm_lo + (mm_hi - mm_lo) // 2).clamp(0, fmi.n))
    gpos, gvalid = _global(sidx, ploc, (mm_hi > mm_lo) & resolved)
    gpos = all_to_all(mesh, gpos.reshape(Dn, b, NS, NM3))
    gvalid = all_to_all(mesh, gvalid.reshape(Dn, b, NS, NM3))
    return _merge_valid_first(
        gpos.permute(1, 2, 0, 3).reshape(b, NS, Dn * NM3),
        gvalid.permute(1, 2, 0, 3).reshape(b, NS, Dn * NM3), NM3)
