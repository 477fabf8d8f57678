"""The reads mesh and the sharded pipeline steps.

Port of ``nvbio_tpu.parallel.mesh``. JAX runs a 1-D ``reads`` mesh under
``shard_map``: one process may own several devices, and collectives ride
the mesh axis. The torch idiom is one process a card in a
``torch.distributed`` process group:

- a mesh of D devices is a group of D ranks (``ReadsMesh``: the group, this
  process's rank in it, its size and the rank's device);
- ``shard_map``'s per-shard body is the function each rank calls on its
  own rows;
- ``jax.lax.all_gather`` / ``psum`` / ``all_to_all`` (split and concat on
  axis 0) are ``all_gather`` into one tensor / ``all_reduce(SUM)`` /
  ``all_to_all_single`` (``all_gather``, ``all_reduce_sum`` and
  ``all_to_all`` below). All three stack the pieces by rank along dim 0,
  as JAX does.

The backend follows the tensors' device: NCCL for ``cuda`` (one card a
rank), gloo for ``cpu``. ``make_reads_mesh`` refuses any other pairing, so
no CUDA tensor is staged through the host.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from nvbio_tpu_torch.bowtie.params import MapParams
from nvbio_tpu_torch.device import resolve_device

READS_AXIS = "reads"

# the backend each device type's tensors need
_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True)
class ReadsMesh:
    """The counterpart of a 1-D ``reads`` mesh: a process group of D ranks,
    this process's rank in it and the device its tensors live on."""

    group: Any          # a ProcessGroup (None: the default group)
    rank: int
    size: int
    device: torch.device

    @property
    def shape(self) -> dict:
        return {READS_AXIS: self.size}


def local_rank() -> int:
    """This process's index among the ranks of its host: torchrun's
    ``LOCAL_RANK``, else the global rank (one host)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def make_reads_mesh(group=None, device=None) -> ReadsMesh:
    """The reads mesh of ``group`` (the default group when None) on
    ``device``: ``cuda:{LOCAL_RANK % device_count}`` unless the caller
    asks for another (``"cpu"`` for a gloo group). Raises where the group's
    backend cannot carry the device's tensors (NCCL for cuda, gloo for
    cpu)."""
    if not dist.is_initialized():
        raise RuntimeError("make_reads_mesh needs an initialized process "
                           "group (parallel.dist.init_distributed)")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
    backend = str(dist.get_backend(group)).lower()
    if _BACKEND[dev.type] not in backend:
        raise ValueError(f"a {backend} group cannot carry {dev.type} tensors "
                         f"(needs {_BACKEND[dev.type]})")
    return ReadsMesh(group=group, rank=dist.get_rank(group),
                     size=dist.get_world_size(group), device=dev)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """Collectives move bool tensors as uint8."""
    x = x.contiguous()
    return x.to(torch.uint8) if x.dtype == torch.bool else x


def all_gather(mesh: ReadsMesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` stacked by rank: (D, *x.shape) (``all_gather``
    on a new leading axis)."""
    w = _wire(x)
    out = torch.empty(mesh.size * w.numel(), dtype=w.dtype, device=w.device)
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, w.reshape(-1), group=mesh.group)
    out = out.view((mesh.size,) + tuple(w.shape))
    return out.to(torch.bool) if x.dtype == torch.bool else out


def all_reduce_sum(mesh: ReadsMesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``x`` (``psum``), a new tensor."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    return out


def all_to_all(mesh: ReadsMesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` of shape (D, ...): piece s goes to rank s; returns (D, ...)
    whose piece s came from rank s (``all_to_all`` with split and concat
    on axis 0)."""
    if x.shape[0] != mesh.size:
        raise ValueError(f"all_to_all of {tuple(x.shape)} over {mesh.size} "
                         f"ranks")
    w = _wire(x)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=mesh.group)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def shard_batch(mesh: ReadsMesh, arr) -> torch.Tensor:
    """This rank's contiguous rows ``[r*B/D, (r+1)*B/D)`` of a host batch
    array, on the rank's device. B must divide by D, as in JAX."""
    t = torch.as_tensor(arr)
    B = t.shape[0]
    if B % mesh.size:
        raise ValueError(f"batch of {B} rows does not divide over "
                         f"{mesh.size} ranks")
    b = B // mesh.size
    return t[mesh.rank * b:(mesh.rank + 1) * b].to(mesh.device)


def replicate(mesh: ReadsMesh, tree):
    """A copy of a tree of tensors, numpy arrays or objects with ``.to``
    (indexes) on the rank's device."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree).to(mesh.device)
    if isinstance(tree, dict):
        return {k: replicate(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(mesh, v) for v in tree)
    if isinstance(tree, torch.Tensor) or hasattr(tree, "to"):
        return tree.to(mesh.device)
    return tree


def _summed(mesh: ReadsMesh, counts: dict) -> dict:
    """The int64 counts of this rank, all-reduced in one collective."""
    keys = list(counts)
    v = all_reduce_sum(mesh, torch.stack(
        [counts[k].to(torch.int64) for k in keys]))
    return {k: v[i] for i, k in enumerate(keys)}


def _check_index(mesh: ReadsMesh, index, index_sharded: bool) -> None:
    from nvbio_tpu_torch.fmi.sharded import ShardedFMIndex
    from nvbio_tpu_torch.parallel.sharded_index import ShardedQGramIndex

    sharded = isinstance(index, (ShardedQGramIndex, ShardedFMIndex))
    if sharded != index_sharded:
        raise TypeError(f"index_sharded={index_sharded} step given a "
                        f"{type(index).__name__}")
    if sharded and index.mesh != mesh:
        raise ValueError("the sharded index is not placed on this mesh "
                         "(place_sharded_index / place_sharded_fmindex)")


def sharded_align_step(mesh: ReadsMesh, params: MapParams,
                       index_sharded: bool = False):
    """The SPMD single-end step over ``mesh``: a function of (index,
    genome_words, n_genome, reads, lens, quals) that runs
    ``align_batch_core`` on this rank's rows (``shard_batch``) and returns
    (its per-read results, the stats all-reduced over the mesh: n_reads,
    n_mapped, n_unique, sum_mapq).

    ``index_sharded=True`` takes a ``ShardedQGramIndex`` or a
    ``ShardedFMIndex`` placed on ``mesh`` (one shard a rank, served with
    collectives inside the step); ``False`` takes a regular index
    replicated on every rank (``replicate``)."""
    from nvbio_tpu_torch.bowtie.pipeline import align_batch_core

    def step(index, genome_words, n_genome, reads, lens, quals):
        _check_index(mesh, index, index_sharded)
        res = align_batch_core(index, genome_words, int(n_genome), reads,
                               lens, quals, params)
        return res, _summed(mesh, dict(
            n_reads=(lens > 0).sum(),
            n_mapped=res["mapped"].sum(),
            n_unique=(res["mapped"] & ~res["has_second"]).sum(),
            sum_mapq=res["mapq"].to(torch.int64).sum()))

    return step


def sharded_all_step(mesh: ReadsMesh, params: MapParams):
    """The SPMD all-mapping step (``align_batch_all`` on this rank's rows;
    replicated index); stats n_reads and n_alignments all-reduced."""
    from nvbio_tpu_torch.bowtie.pipeline import align_batch_all

    def step(index, genome_words, n_genome, reads, lens, quals):
        _check_index(mesh, index, False)
        res = align_batch_all(index, genome_words, int(n_genome), reads,
                              lens, quals, params)
        return res, _summed(mesh, dict(n_reads=(lens > 0).sum(),
                                       n_alignments=res["keep"].sum()))

    return step


def sharded_paired_step(mesh: ReadsMesh, params: MapParams):
    """The SPMD paired-end step (``align_paired_core`` on this rank's rows
    of both mates; replicated index); stats n_pairs, n_proper and n_mapped
    all-reduced."""
    from nvbio_tpu_torch.bowtie.paired import align_paired_core

    def step(index, genome_words, n_genome, r1, l1, q1, r2, l2, q2):
        _check_index(mesh, index, False)
        res1, res2, pinfo = align_paired_core(
            index, genome_words, int(n_genome), r1, l1, q1, r2, l2, q2,
            params)
        return res1, res2, pinfo, _summed(mesh, dict(
            n_pairs=(l1 > 0).sum(),
            n_proper=pinfo["proper"].sum(),
            n_mapped=(res1["mapped"] | res2["mapped"]).sum()))

    return step
