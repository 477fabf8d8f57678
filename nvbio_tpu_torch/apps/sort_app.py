"""`nvbio_tpu_torch sort` — coordinate-sort a SAM/BAM file (bamsort equivalent).

Usage: nvbio_tpu_torch sort in.bam out.bam [--run-size N] [--device cpu]

Equivalent of the reference's out-of-core BAM sorting prototype
(``prototypes/bamsort/bam_sort.cu:56-78``): device-sorted runs spilled to
temp BGZF files and k-way merged, so inputs larger than memory still sort.

Port of ``nvbio_tpu/apps/sort_app.py``; the runs sort on the CUDA card
unless ``--device cpu`` is given, and it raises where there is no card.
"""

from __future__ import annotations

import time


def add_parser(sub):
    p = sub.add_parser("sort", help="coordinate-sort SAM/BAM")
    p.add_argument("input", help="input SAM/BAM")
    p.add_argument("output", help="output SAM/BAM (format by extension)")
    p.add_argument("--run-size", type=int, default=262_144,
                   help="records per in-memory sorted run")
    p.add_argument("--tmp-dir", help="spill directory for runs")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.set_defaults(func=run)
    return p


def run(args):
    from nvbio_tpu_torch.io.bamsort import sort_alignments
    from nvbio_tpu_torch.utils.console import log_stats

    t0 = time.time()
    n = sort_alignments(args.input, args.output, run_size=args.run_size,
                        tmp_dir=args.tmp_dir, device=args.device)
    dt = time.time() - t0
    log_stats(f"sorted {n:,} records in {dt:.1f}s "
              f"({n/max(dt,1e-9):,.0f} records/s)")
    return 0
