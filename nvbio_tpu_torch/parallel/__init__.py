"""Multi-GPU mapping: the reads mesh over ``torch.distributed``, the
sharded pipeline steps, the bucket-sharded q-gram index (``fmi.sharded``
holds the genome-sliced FM index) and the multi-process runtime.

Port of ``nvbio_tpu.parallel``. The reference's multi-GPU model is one
ComputeThread per device with host-side stat merging
(``nvBowtie.cpp:644-699``); here it is one process a card in a process
group, each rank mapping its own rows of a batch, the stats all-reduced
(``mesh.py``).
"""

from nvbio_tpu_torch.parallel.mesh import (  # noqa: F401
    make_reads_mesh,
    sharded_align_step,
)
