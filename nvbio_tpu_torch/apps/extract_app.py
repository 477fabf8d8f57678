"""`nvbio_tpu_torch extract` — dump read archives to plain text (nvExtractReads).

Reference: ``nvExtractReads/nvExtractReads.cu`` (sequence-archive -> ASCII
dump perf tool).

Port of ``nvbio_tpu/apps/extract_app.py`` (host only), over the port's
``io.fasta`` and ``io.fastq``.
"""

from __future__ import annotations

import sys


def add_parser(sub):
    p = sub.add_parser("extract", help="dump reads to plain ASCII")
    p.add_argument("reads", help="FASTQ(.gz) or FASTA(.gz)")
    p.add_argument("-o", "--output", default="-")
    p.add_argument("--rc", action="store_true", help="emit reverse complements")
    p.set_defaults(func=run)
    return p


def run(args):
    from nvbio_tpu_torch.io.fasta import read_fasta
    from nvbio_tpu_torch.io.fastq import read_fastq
    from nvbio_tpu_torch.utils.console import log_stats

    comp = str.maketrans("ACGTacgt", "TGCAtgca")
    out = sys.stdout if args.output == "-" else open(args.output, "w")
    n = 0
    if args.reads.rstrip(".gz").endswith((".fa", ".fasta")):
        records = ((name, seq) for name, seq in read_fasta(args.reads))
    else:
        records = ((name, seq) for name, seq, _ in read_fastq(args.reads))
    for _, seq in records:
        if args.rc:
            seq = seq.translate(comp)[::-1]
        out.write(seq + "\n")
        n += 1
    if out is not sys.stdout:
        out.close()
    log_stats(f"extracted {n:,} sequences")
    return 0
