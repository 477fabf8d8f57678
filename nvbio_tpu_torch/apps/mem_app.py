"""`nvbio_tpu_torch mem` — BWA-MEM-style local alignment (nvmem equivalent).

    python -m nvbio_tpu_torch mem ref.fa reads.fq [-o out.sam|bam]
        [--batch N] [--max-read-len L] [-k MIN_SEED] [-T MIN_SCORE]
        [--max-dist D] [--device cpu]

Port of ``nvbio_tpu/apps/mem_app.py``, the same flags plus ``--device``:
SMEM seeding over the reversed genome's FM index (built on the card, or by
host SA-IS with ``--device cpu``), anchor chaining, one K2-LOCAL launch a
batch, soft-clipped SAM with secondaries and ``XA``. Runs on the CUDA card
unless ``--device cpu`` is given, and raises where there is no card.
"""

from __future__ import annotations

import time


def add_parser(sub):
    p = sub.add_parser("mem", help="MEM-seeded local alignment -> SAM")
    p.add_argument("reference", help="reference FASTA")
    p.add_argument("reads", help="FASTQ(.gz)")
    p.add_argument("-o", "--output", default="-")
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--max-read-len", type=int, default=256)
    p.add_argument("-k", "--min-seed-len", type=int, default=19)
    p.add_argument("-T", "--min-score", type=int, default=30)
    p.add_argument("--max-dist", type=int, default=16)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.set_defaults(func=run)
    return p


def run(args):
    from nvbio_tpu_torch.device import resolve_device
    from nvbio_tpu_torch.io.fastq import fastq_batches
    from nvbio_tpu_torch.io.output import open_alignment_output
    from nvbio_tpu_torch.io.reference import Reference
    from nvbio_tpu_torch.mem import MemMapper, MemParams
    from nvbio_tpu_torch.utils.console import log_info, log_stats

    dev = resolve_device(args.device)
    t0 = time.time()
    ref = Reference.from_fasta(args.reference)
    params = MemParams(
        max_read_len=args.max_read_len, min_seed_len=args.min_seed_len,
        min_score=args.min_score, max_dist=args.max_dist,
    )
    mapper = MemMapper.build(ref, params, device=dev)
    log_info(f"MEM index ready in {time.time()-t0:.1f}s "
             f"({ref.total_length:,} bp, {dev.type})")

    n = mapped = 0
    t0 = time.time()
    with open_alignment_output(args.output, ref.names,
                               (ref.offsets[1:] - ref.offsets[:-1]).tolist()) as w:
        for batch in fastq_batches(args.reads, args.batch, args.max_read_len):
            for rec in mapper.map_batch(batch):
                w.write(rec)
                n += 1
                mapped += 0 if rec.flag & 0x4 else 1
    dt = time.time() - t0
    log_stats(f"{n:,} reads in {dt:.1f}s; {mapped:,} mapped")
    return 0
