"""`nvbio_tpu_torch map` — Bowtie2-style read mapping to SAM.

    python -m nvbio_tpu_torch map <ref.fa | index-prefix> reads.fq -o out.sam
    python -m nvbio_tpu_torch map <ref.fa | index-prefix> -1 r1.fq -2 r2.fq
        [-I MIN] [-X MAX] [--no-rescue] [--pe-policy fr|rf|ff]
        [--no-discordant] [--local] [--all] [--config FILE] [--device cpu]

Port of the single-end and paired-end paths of ``nvbio_tpu/apps/
map_app.py``, end-to-end or local (``--local``), best-alignment or
all-mapping (``--all``: every locus above threshold, SE and PE, the
others as secondary records). ``--config FILE`` overlays ``key=value``
lines onto the ``MapParams`` fields after the presets (for example
``pe_full_traceback=1``, the full-matrix mate traceback); a value that
selects a path not ported yet stops before any work. The reference is a
FASTA (q-gram index built on the fly) or the prefix of artifacts the JAX
package's ``index`` app wrote (``<prefix>.ref.npz``, and
``<prefix>.qgram.npz`` when present). Runs on the CUDA card unless
``--device cpu`` is given. Flags of ``nvbio_tpu map`` that select paths not
ported yet (FM seeding, BAM, reports, multi-host, ...) are rejected with a
"not yet ported" error.
"""

from __future__ import annotations

import os
import sys
import time

# flags of `nvbio_tpu map` whose paths are not ported yet
NOT_PORTED = (
    "--seeding", "--report", "--profile", "--mapq-filter", "--debug-output",
    "--dist", "--coordinator", "--num-processes", "--process-id",
)


def add_parser(sub):
    p = sub.add_parser("map", help="map reads (SE or PE) -> SAM")
    p.add_argument("reference", help="index prefix (from `index`) or FASTA")
    p.add_argument("reads", nargs="?", help="single-end FASTQ(.gz)")
    p.add_argument("-1", dest="mate1", help="mate-1 FASTQ (paired-end)")
    p.add_argument("-2", dest="mate2", help="mate-2 FASTQ (paired-end)")
    p.add_argument("-o", "--output", default="-",
                   help="output SAM (default stdout)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--max-read-len", type=int, default=128)
    p.add_argument("--seed-len", type=int, default=22)
    p.add_argument("--seed-stride", type=int, default=15)
    p.add_argument("--hits-per-seed", type=int, default=4)
    p.add_argument("--max-dist", type=int, default=15)
    p.add_argument("--mode", choices=["sw", "ed"], default="sw",
                   help="sw: quality-aware Gotoh (bowtie2-like, default); "
                        "ed: unit-cost edit distance (nvBowtie --ed)")
    p.add_argument("--local", action="store_true",
                   help="local alignment (soft-clipped ends, bowtie2 "
                        "--local scoring + local MAPQ)")
    p.add_argument("--config", help="option file: one key=value per line "
                                    "(overrides CLI parameter defaults)")
    p.add_argument("-I", "--minins", type=int, default=0)
    p.add_argument("-X", "--maxins", type=int, default=500)
    p.add_argument("--no-rescue", action="store_true")
    p.add_argument("--pe-policy", choices=["fr", "rf", "ff"], default="fr",
                   help="mate orientation (bowtie2 --fr/--rf/--ff)")
    p.add_argument("--no-discordant", action="store_true",
                   help="do not classify discordant pairs")
    p.add_argument("--max-reseed", type=int, default=1,
                   help="extra seeding passes for unaligned reads")
    p.add_argument("--reseed-frac", type=float, default=0.125,
                   help="reseed queue capacity as a fraction of the batch")
    p.add_argument("--no-1mm-seeding", action="store_true",
                   help="disable 1-mismatch seeding in reseed passes")
    p.add_argument("--all", action="store_true", dest="all_mode",
                   help="report ALL alignments above threshold "
                        "(secondary records), not just the best")
    p.set_defaults(func=run)
    return p


def reject_not_ported(argv: list[str]) -> None:
    """Raise SystemExit naming the first flag of ``nvbio_tpu map`` in
    ``argv`` whose path is not ported yet (checked before argparse, which
    would read ``-1`` as a negative number)."""
    for tok in argv:
        flag = tok.split("=", 1)[0]
        if flag in NOT_PORTED:
            raise SystemExit(f"nvbio_tpu_torch map: {flag} is not yet ported "
                             f"(q-gram mapping to SAM only)")


def _load_reference(path: str):
    from nvbio_tpu_torch.io.reference import Reference
    from nvbio_tpu_torch.qgram import QGramIndex

    if path.endswith((".fa", ".fasta", ".fa.gz", ".fasta.gz")):
        return Reference.from_fasta(path), None
    if not os.path.exists(path + ".ref.npz"):
        raise SystemExit(f"nvbio_tpu_torch map: {path}.ref.npz not found "
                         f"(.pac references are not yet ported)")
    ref = Reference.load(path + ".ref.npz")
    index = None
    if os.path.exists(path + ".qgram.npz"):
        index = QGramIndex.load(path + ".qgram.npz")
    return ref, index


def run(args):
    from nvbio_tpu_torch.alphabet import Alphabet
    from nvbio_tpu_torch.bowtie.paired import (
        check_paired_supported,
        map_pair_batch,
        map_pair_batch_all,
    )
    from nvbio_tpu_torch.bowtie.params import MapParams
    from nvbio_tpu_torch.bowtie.pipeline import ReadMapper, check_supported
    from nvbio_tpu_torch.io.fastq import fastq_batches
    from nvbio_tpu_torch.io.sam import SamWriter

    paired = args.mate1 is not None
    if paired and not args.mate2:
        raise SystemExit("paired-end needs both -1 and -2")
    if not paired and not args.reads:
        raise SystemExit("provide a reads file (or -1/-2 for paired-end)")
    if str(args.output).endswith(".bam"):
        raise SystemExit("nvbio_tpu_torch map: BAM output is not yet ported")
    common = dict(
        max_read_len=args.max_read_len,
        seed_len=args.seed_len,
        seed_stride=args.seed_stride,
        hits_per_seed=args.hits_per_seed,
        max_dist=args.max_dist,
        max_reseed=args.max_reseed,
        reseed_frac=args.reseed_frac,
        seeding_1mm=not args.no_1mm_seeding,
        minins=args.minins,
        maxins=args.maxins,
        mate_rescue=not args.no_rescue,
        pe_policy=args.pe_policy,
        pe_discordant=not args.no_discordant,
    )
    if args.local:
        params = MapParams.local(**common)
    elif args.mode == "ed":
        params = MapParams.edit_distance(**common)
    else:
        params = MapParams(**common)
    if args.config:
        from nvbio_tpu_torch.utils.options import Options, apply_to_params

        params = apply_to_params(Options.load(args.config), params)
    check_supported(params)
    if paired and not args.all_mode:  # --all pairs have no mate rescue
        check_paired_supported(params, args.max_read_len)
    t0 = time.time()
    ref, index = _load_reference(args.reference)
    mapper = ReadMapper.build(ref, params, index=index, device=args.device)
    print(f"[info] reference + index ready in {time.time() - t0:.1f}s "
          f"({ref.total_length:,} bp) on {mapper.device}", file=sys.stderr)

    lengths = (ref.offsets[1:] - ref.offsets[:-1]).tolist()
    n_reads = n_mapped = 0
    t0 = time.time()
    out = sys.stdout if args.output == "-" else args.output

    def batches(path):
        return fastq_batches(path, args.batch, args.max_read_len,
                             alphabet=Alphabet.DNA_N)

    if paired:
        map_pairs = map_pair_batch_all if args.all_mode else map_pair_batch
        record_lists = (map_pairs(mapper, b1, b2) for b1, b2 in
                        zip(batches(args.mate1), batches(args.mate2)))
    elif args.all_mode:
        record_lists = (mapper.map_batch_all(b) for b in batches(args.reads))
    else:
        record_lists = (mapper.map_batch(b) for b in batches(args.reads))
    with SamWriter(out, ref.names, lengths) as w:
        for recs in record_lists:
            for rec in recs:
                w.write(rec)
                if not rec.flag & 0x100:  # secondaries are not reads
                    n_reads += 1
                    n_mapped += 0 if rec.flag & 0x4 else 1
    dt = time.time() - t0
    print(f"[stats] {n_reads:,} reads in {dt:.1f}s "
          f"({n_reads / max(dt, 1e-9):,.0f} reads/s); {n_mapped:,} mapped "
          f"({100.0 * n_mapped / max(n_reads, 1):.2f}%)", file=sys.stderr)
    return 0
