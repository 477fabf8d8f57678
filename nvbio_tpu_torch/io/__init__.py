"""Sequence I/O copied from the JAX package: FASTA/FASTQ readers, the
reference container and its .pac artifacts, SAM and BAM (BGZF) output,
VCF, and the binary debug records."""

from nvbio_tpu_torch.io.fasta import read_fasta, write_fasta  # noqa: F401
from nvbio_tpu_torch.io.fastq import read_fastq, fastq_batches  # noqa: F401
from nvbio_tpu_torch.io.reference import Reference  # noqa: F401
from nvbio_tpu_torch.io.sam import SamWriter  # noqa: F401
from nvbio_tpu_torch.io.bam import BamReader, BamWriter  # noqa: F401
from nvbio_tpu_torch.io.output import (  # noqa: F401
    open_alignment_output,
    read_alignments,
)
from nvbio_tpu_torch.io.vcf import SNPDatabase, load_vcf  # noqa: F401
