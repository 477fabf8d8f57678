"""nvbio_tpu_torch — the PyTorch/CUDA port of nvbio_tpu for NVIDIA Hopper.

The JAX package ``nvbio_tpu`` is the reference; this package does what it
does with plain torch tensor code and hand-written CUDA kernels for
``sm_90a``. ``python -m nvbio_tpu_torch`` runs the same ten commands:
``index``, ``map`` (single-end, paired-end with mate rescue, local,
``--all``, q-gram or FM-index seeding, the kernel and the scan engines),
``mem``, ``setbwt``, ``correct``, ``sort``, ``aln-diff``, ``extract``,
``serve`` and ``assemble``. The library underneath mirrors
``nvbio_tpu``'s modules and package-level names: packed strings, q-gram,
Q-Group and FM indexes, suffix arrays and BWTs built on the host or the
card, the DP aligner library, sequence and alignment I/O.

Each of the JAX package's five Pallas kernels has a CUDA counterpart in
``csrc/`` (banded candidate scoring, window scoring, the banded traceback
and its wide form, Myers' bit-parallel edit distance, the pre-blocked
scorer), built by nvcc at first use and bound by ctypes in
``align/kernels.py``; each has a plain torch twin that CPU tensors take.
``parallel/`` maps reads over several cards in a ``torch.distributed``
group (a reads mesh, sharded q-gram and FM indexes, ``map --dist``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
The package never imports JAX or anything of ``nvbio_tpu``: the jax-free
modules it needs (alphabet, sequence I/O, the native host builders) are
copied.
"""

__version__ = "0.1.0"

from nvbio_tpu_torch.alphabet import Alphabet  # noqa: F401
