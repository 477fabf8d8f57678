"""Multi-process runtime: process-group init, per-process input striping,
per-rank placement, and SAM shard merging.

Port of ``nvbio_tpu.parallel.dist``. Every process joins one
``torch.distributed`` group (the counterpart of ``jax.distributed``: one
process a card instead of one runtime over every chip), feeds its own
stripe of the input, and writes its own SAM shard; ``merge_sam_shards``
concatenates the shards under one header. The JAX package's global-array
functions become their per-rank forms, since a torch rank holds only its
own rows:

- ``global_batch`` (this host's rows as the local shard of a global
  array) -> this rank's rows as a tensor on its device;
- ``place_replicated`` (a host tree on every device of a global mesh) ->
  the tree on this rank's device;
- ``local_rows`` (this process's rows of a global array, as host numpy)
  -> this rank's result tree as host numpy.

Single-process use needs no initialization: every helper then acts as
rank 0 of 1.
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator, Sequence

import torch
import torch.distributed as dist

from nvbio_tpu_torch.parallel.mesh import make_reads_mesh, replicate


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str = "gloo") -> bool:
    """Join the process group (idempotent).

    Explicit arguments win; otherwise torchrun's variables are read
    (``MASTER_ADDR``/``MASTER_PORT`` for the coordinator ``HOST:PORT``,
    ``WORLD_SIZE``, ``RANK``). Returns False when nothing is configured
    (the single-process case), True once the group is up.
    ``init_process_group`` gets ``init_method="tcp://<coordinator>"``, the
    world size and the rank; ``backend`` is ``"gloo"`` (CPU tensors, or a
    group that only carries barriers) or ``"nccl"`` (CUDA tensors, one
    card a rank)."""
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    if coordinator_address is None and num_processes is None:
        return False
    if dist.is_initialized():
        return True
    missing = [what for what, v in (
        ("the coordinator HOST:PORT (or MASTER_ADDR/MASTER_PORT)",
         coordinator_address),
        ("the number of processes (or WORLD_SIZE)", num_processes),
        ("this process's id (or RANK)", process_id)) if v is None]
    if missing:
        raise ValueError(f"a multi-process run needs {', '.join(missing)}")
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_reads_mesh(device=None):
    """The reads mesh over every rank of the default group (on ``device``,
    cuda by default: ``parallel.mesh.make_reads_mesh``)."""
    return make_reads_mesh(None, device)


def host_stripe(batches: Iterable, process_id: int | None = None,
                num_processes: int | None = None) -> Iterator:
    """Round-robin stripe of a batch stream for this process: every
    process scans the same input and keeps batches ``i % num_processes ==
    process_id``."""
    pid = process_index() if process_id is None else process_id
    n = process_count() if num_processes is None else num_processes
    for i, b in enumerate(batches):
        if i % n == pid:
            yield b


def global_batch(mesh, arr) -> torch.Tensor:
    """This rank's batch rows (host array or tensor) on its device."""
    return torch.as_tensor(arr).to(mesh.device)


def place_replicated(mesh, tree):
    """A host tree (tensors, arrays, indexes) on this rank's device: every
    rank holds the same data, as the reference copies its index to each
    GPU (``compute_thread.cu:95-112``)."""
    return replicate(mesh, tree)


def local_rows(tree):
    """This rank's result tree as host numpy."""
    if isinstance(tree, dict):
        return {k: local_rows(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(local_rows(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    return tree


def shard_path(base: str, process_id: int | None = None) -> str:
    """Per-process output shard: ``out.sam`` -> ``out.sam.shard0007``."""
    pid = process_index() if process_id is None else process_id
    return f"{base}.shard{pid:04d}"


def merge_sam_shards(paths: Sequence[str], out_path: str,
                     remove: bool = False) -> int:
    """Concatenate SAM shards under the first shard's header.

    Returns the number of alignment records written. Shards are assumed to
    share an identical header (same reference); bodies append in shard
    order so output is deterministic.
    """
    n = 0
    with open(out_path, "w") as out:
        for i, p in enumerate(paths):
            with open(p) as f:
                for line in f:
                    if line.startswith("@"):
                        if i == 0:
                            out.write(line)
                        continue
                    out.write(line)
                    n += 1
            if remove:
                os.remove(p)
    return n
