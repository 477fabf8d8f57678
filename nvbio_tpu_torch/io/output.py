"""Format-dispatching alignment output/input (SAM text or BGZF BAM).

Counterpart of the reference's ``io/output/output_file.h:71-124``
(``OutputFile::open`` choosing SamOutput/BamOutput/DebugOutput by extension):
one factory returning a writer with the shared ``write(SamRecord)`` /
``close()`` interface, plus a symmetric reader dispatch for the diff tools.

A copy of ``nvbio_tpu.io.output`` (default ``program``
``nvbio_tpu_torch``).
"""

from __future__ import annotations

import sys


def open_alignment_output(path_or_dash, ref_names, ref_lengths,
                          program: str = "nvbio_tpu_torch",
                          sort_order: str = "unsorted"):
    """Open '-', *.sam, or *.bam for writing alignment records."""
    from nvbio_tpu_torch.io.sam import SamWriter

    if path_or_dash == "-":
        return SamWriter(sys.stdout, ref_names, ref_lengths, program,
                         sort_order=sort_order)
    if str(path_or_dash).endswith(".bam"):
        from nvbio_tpu_torch.io.bam import BamWriter

        return BamWriter(path_or_dash, ref_names, ref_lengths, program,
                         sort_order=sort_order)
    return SamWriter(str(path_or_dash), ref_names, ref_lengths, program,
                     sort_order=sort_order)


def read_alignments(path: str):
    """(header_lines, records-as-column-lists) from a SAM or BAM file."""
    if path.endswith(".bam"):
        from nvbio_tpu_torch.io.bam import read_bam

        return read_bam(path)
    from nvbio_tpu_torch.io.sam import read_sam

    return read_sam(path)
