"""The bucket-sharded q-gram index, served over the reads mesh.

Port of ``nvbio_tpu.parallel.sharded_index``. Buckets are range-partitioned
over the ranks: rank d owns the q-gram keys [d*K/D, (d+1)*K/D) (K/D
ceil-divided). A lookup all-gathers the (small) query keys, answers the
keys it owns from its own offset and position rows, masks the others to 0
and all-reduces the disjoint answers, so the sum is the owner's answer,
then keeps its own rows: a replicated query over sharded data, every
transfer dense and fixed-shape. A position table too large for one card
(a whole human genome's is ~12.4 GB at 3.1 Gbp) is held at 1/D a card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nvbio_tpu_torch.parallel.mesh import (
    ReadsMesh,
    all_gather,
    all_reduce_sum,
)
from nvbio_tpu_torch.qgram import stratified_offsets


@dataclasses.dataclass
class ShardedQGramIndex:
    """D bucket-range shards of a direct-address q-gram index, stacked on
    dim 0 (``shard_qgram_index``), or one rank's row of them placed on its
    card (``place_sharded_index``: ``mesh`` set, dim 0 of size 1). The
    pipeline seeds from it through ``sharded_seed_hits``
    (``bowtie.pipeline.read_candidates`` dispatches on this type).
    Positions are GLOBAL text coordinates."""

    q: int
    n_shards: int
    keys_per_shard: int     # bucket keys owned a rank
    pos_per_shard: int      # padded position rows a rank
    offsets: torch.Tensor   # int32[D|1, keys_per_shard + 1] local offsets
    positions: torch.Tensor  # int32/int64[D|1, pos_per_shard] positions
    n: int
    mesh: ReadsMesh | None = None

    def to(self, device) -> "ShardedQGramIndex":
        return dataclasses.replace(self, offsets=self.offsets.to(device),
                                   positions=self.positions.to(device))

    def rows(self, rank: int) -> "ShardedQGramIndex":
        """A view of one rank's rows (dim 0 of size 1)."""
        return dataclasses.replace(
            self, offsets=self.offsets[rank:rank + 1],
            positions=self.positions[rank:rank + 1])


def shard_qgram_index(index, n_shards: int) -> ShardedQGramIndex:
    """Split a ``QGramIndex`` into D bucket-range shards (on the host).

    Each shard's offsets are rebased to its own position slice and padded
    to one length with its end offset; positions are padded with zeros.
    The key space is ceil-divided, so any shard count works (the tail shard
    may own fewer keys)."""
    n_keys = 1 << (2 * index.q)
    kps = (n_keys + n_shards - 1) // n_shards
    offsets = index.offsets.cpu().numpy().astype(np.int64)
    positions = index.positions.cpu().numpy()

    slices, local_offsets = [], []
    for d in range(n_shards):
        a = min(d * kps, n_keys)
        b = min((d + 1) * kps, n_keys)
        lo, hi = int(offsets[a]), int(offsets[b])
        slices.append(positions[lo:hi])
        loc = (offsets[a:b + 1] - lo).astype(np.int32)
        if len(loc) < kps + 1:  # ragged tail shard: repeat the end offset
            loc = np.concatenate([loc, np.full(
                kps + 1 - len(loc), loc[-1] if len(loc) else 0, np.int32)])
        local_offsets.append(loc)
    pos_per_shard = max(max(len(s) for s in slices), 1)
    pos = np.zeros((n_shards, pos_per_shard), positions.dtype)
    for d, s in enumerate(slices):
        pos[d, :len(s)] = s
    return ShardedQGramIndex(
        q=index.q, n_shards=n_shards, keys_per_shard=kps,
        pos_per_shard=pos_per_shard,
        offsets=torch.from_numpy(np.stack(local_offsets)),
        positions=torch.from_numpy(pos), n=index.n)


def place_sharded_index(mesh: ReadsMesh,
                        sidx: ShardedQGramIndex) -> ShardedQGramIndex:
    """This rank's shard rows on its card, bound to ``mesh``."""
    if sidx.n_shards != mesh.size:
        raise ValueError(f"{sidx.n_shards} shards on a mesh of {mesh.size}")
    if sidx.offsets.shape[0] != sidx.n_shards:
        raise ValueError("place_sharded_index takes the stacked shards")
    return dataclasses.replace(sidx.rows(mesh.rank).to(mesh.device),
                               mesh=mesh)


def _owned(mesh: ReadsMesh, flat_keys, kps: int, offs):
    """(mine, lo, range size) of every key against this rank's offsets."""
    local_key = flat_keys.to(torch.int64) - mesh.rank * kps
    mine = (local_key >= 0) & (local_key < kps)
    lk = local_key.clamp(0, kps - 1)
    lo = offs[lk].to(torch.int64)
    rs = (offs[lk + 1].to(torch.int64) - lo).clamp(min=0)
    return mine, lo, rs


def sharded_lookup(mesh: ReadsMesh, sidx_offsets, sidx_positions, keys,
                   slots, *, q: int, n_shards: int, keys_per_shard: int):
    """Positions of (key, slot) queries and the keys' range sizes.

    ``sidx_offsets``/``sidx_positions`` are this rank's (1, kps+1)/(1,
    pps) rows; ``keys``/``slots`` this rank's query block (any shape).
    Returns (pos, range_size) of the same shape, int64, combined over the
    ranks by an all-reduce."""
    all_keys = all_gather(mesh, keys)                   # (D, ...)
    all_slots = all_gather(mesh, slots)
    mine, lo, rs = _owned(mesh, all_keys.reshape(-1), keys_per_shard,
                          sidx_offsets[0])
    poss = sidx_positions[0]
    idx = (lo + all_slots.reshape(-1).to(torch.int64)).clamp(
        0, poss.shape[0] - 1)
    p = torch.where(mine, poss[idx].to(torch.int64), 0)
    rs = torch.where(mine, rs, 0)
    # the shards are disjoint, so the sum is the owner's answer
    p = all_reduce_sum(mesh, p).reshape(all_keys.shape)[mesh.rank]
    rs = all_reduce_sum(mesh, rs).reshape(all_keys.shape)[mesh.rank]
    return p.reshape(keys.shape), rs.reshape(keys.shape)


def sharded_seed_hits(sidx: ShardedQGramIndex, keys, H: int):
    """Pipeline seeding against the placed bucket-sharded index.

    keys: (b, NS) q-gram seed keys of this rank's reads. Returns (pos (b,
    NS, H) global positions int64, range_size (b, NS) int64): the contract
    of the replicated path's range + locate, H jittered stratified slots of
    each bucket (``qgram.stratified_offsets`` over the all-gathered (D*b,
    NS) plane; its jitter depends on NS only, so each rank's rows are those
    of the single-process call)."""
    mesh = sidx.mesh
    kps = sidx.keys_per_shard
    all_keys = all_gather(mesh, keys)                   # (D, b, NS)
    Dn, b, NS = all_keys.shape
    flat = all_keys.reshape(Dn * b, NS).clamp(0, (1 << (2 * sidx.q)) - 1)
    offs = sidx.offsets[0]                              # (kps + 1,)
    poss = sidx.positions[0]                            # (pps,)
    mine, lo, rs = _owned(mesh, flat, kps, offs)        # (D*b, NS)
    off = stratified_offsets(rs, H, NS)                 # (D*b, NS, H)
    idx = torch.minimum(lo[..., None] + off, offs[-1].to(torch.int64) - 1)
    idx = idx.clamp(0, poss.shape[0] - 1)
    p = torch.where(mine[..., None], poss[idx].to(torch.int64), 0)
    rs = torch.where(mine, rs, 0)
    p = all_reduce_sum(mesh, p).reshape(Dn, b, NS, H)[mesh.rank]
    rs = all_reduce_sum(mesh, rs).reshape(Dn, b, NS)[mesh.rank]
    return p, rs
