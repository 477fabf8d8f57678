"""Index construction: suffix arrays and BWTs on the host or the card,
the blockwise BWT of large genomes and read-set BWTs."""

from nvbio_tpu_torch.index.sa import suffix_array  # noqa: F401
