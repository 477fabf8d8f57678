"""Sequence I/O copied from the JAX package: FASTA/FASTQ readers, the
reference container and its .pac artifacts, SAM and BAM (BGZF) output,
and the binary debug records."""
