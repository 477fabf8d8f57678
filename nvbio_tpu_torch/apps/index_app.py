"""`nvbio_tpu_torch index` — build reference index artifacts from FASTA.

    python -m nvbio_tpu_torch index ref.fa prefix [--fmi] [--no-qgram]
        [-q Q] [--sa-interval K] [--sa-backend auto|host|device]
        [--qgroup Q] [--pac] [--bwt] [--bwt-lz4] [--bwt-blockwise]
        [--device cpu]

Port of ``nvbio_tpu/apps/index_app.py`` (nvBWT + nvSSA): writes, next to
the prefix, the same artifacts as ``python -m nvbio_tpu index``:
  <prefix>.ref.npz     packed reference + contig metadata
  <prefix>.qgram.npz   q-gram index (unless --no-qgram)
  <prefix>.qgroup.npz  Q-Group index (with --qgroup Q)
  <prefix>.pac/.ann/.amb  BWA-compatible packed reference (with --pac)
  <prefix>.fmi.npz     FM index (with --fmi)
  <prefix>.bwt         nvBWT BWT (with --fmi --bwt, or --bwt-blockwise;
                       LZ4 frames with --bwt-lz4)
The FM index is built on the card (``index.device_sa``: the suffix sort
and every table) with ``--sa-backend device``, or with ``auto`` on a cuda
device for genomes of 2^22 bases or more; else by host SA-IS. The Q-Group
index is built from the packed genome on the app's device
(``qgram.build_qgroup_index_device``, in bounded memory), as the mapper
builds it; its file, as the ``.qgram.npz``, keeps the q-grams over an N,
as the JAX package's files do.
``--bwt-blockwise`` sorts the BWT block by block on the app's device
(``index.blockwise``: int64 positions, texts past the int32 FM index, up
to 2^32 - 17 bases). The app runs on cuda unless ``--device cpu`` is given
(the device sorts then run on the CPU) and raises where there is no card.
It logs each stage's seconds. Every flag of ``nvbio_tpu index`` is taken.
"""

from __future__ import annotations

import time

import numpy as np


def add_parser(sub):
    p = sub.add_parser("index", help="build reference index artifacts")
    p.add_argument("fasta", help="reference FASTA (.fa/.fa.gz)")
    p.add_argument("prefix", help="output artifact prefix")
    p.add_argument("--fmi", action="store_true",
                   help="also build the FM-index")
    p.add_argument("--no-qgram", action="store_true",
                   help="skip the q-gram table")
    p.add_argument("-q", type=int, default=12,
                   help="q-gram length (default 12)")
    p.add_argument("--sa-interval", type=int, default=8)
    p.add_argument("--sa-backend", choices=("auto", "host", "device"),
                   default="auto",
                   help="suffix-sort backend for --fmi: host SA-IS, the "
                        "device's prefix doubling, or auto (device on a "
                        "cuda device for genomes of 2^22 bases or more)")
    p.add_argument("--qgroup", type=int, metavar="Q", default=0,
                   help="also build a Q-Group index with this q "
                        "(compact for large q, e.g. 16)")
    p.add_argument("--pac", action="store_true",
                   help="also write BWA-compatible .pac/.ann/.amb")
    p.add_argument("--bwt", action="store_true",
                   help="with --fmi: also write the nvBWT-format .bwt file")
    p.add_argument("--bwt-lz4", action="store_true",
                   help="compress .bwt outputs with the native LZ4 codec")
    p.add_argument("--bwt-blockwise", action="store_true",
                   help="write the nvBWT .bwt via the blockwise device "
                        "suffix sorter (texts past the int32 FM index)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.set_defaults(func=run)
    return p


def _timed(stages: dict, name: str, t0: float) -> float:
    now = time.perf_counter()
    stages[name] = now - t0
    return now


def run(args):
    from nvbio_tpu_torch.device import resolve_device
    from nvbio_tpu_torch.io.reference import Reference
    from nvbio_tpu_torch.utils.console import log_info, log_stats

    dev = resolve_device(args.device)
    stages: dict = {}
    t = time.perf_counter()
    ref = Reference.from_fasta(args.fasta)
    ref.save(args.prefix + ".ref.npz")
    t = _timed(stages, "reference", t)
    log_info(f"loaded {len(ref.names)} contigs, {ref.total_length:,} bp "
             f"({stages['reference']:.2f}s)")

    if not args.no_qgram:
        from nvbio_tpu_torch.qgram import build_qgram_index

        build_qgram_index(ref.codes, args.q).save(args.prefix + ".qgram.npz")
        t = _timed(stages, "qgram", t)
        log_stats(f"q-gram index (q={args.q}) built in "
                  f"{stages['qgram']:.2f}s")

    if args.qgroup:
        from nvbio_tpu_torch import packed
        from nvbio_tpu_torch.qgram import build_qgroup_index_device

        words = packed.words_to_tensor(ref.packed_words(), dev)
        qg = build_qgroup_index_device(words, ref.total_length, args.qgroup)
        qg.save(args.prefix + ".qgroup.npz")
        t = _timed(stages, "qgroup", t)
        log_stats(f"Q-Group index (q={args.qgroup}, "
                  f"{qg.SS.shape[0] - 1:,} unique) built in "
                  f"{stages['qgroup']:.2f}s")

    if args.pac:
        from nvbio_tpu_torch.io.pac import save_reference_pac

        save_reference_pac(ref, args.prefix)
        t = _timed(stages, "pac", t)
        log_info(f"wrote {args.prefix}.pac/.ann/.amb (BWA-compatible)")

    if args.bwt_blockwise:
        t = _build_blockwise(args, ref, dev, stages, t)

    if args.fmi:
        t = _build_fmi(args, ref, dev, stages, t)
    log_stats("stages: " + ", ".join(
        f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in stages.items()))
    return 0


def _build_blockwise(args, ref, dev, stages: dict, t: float) -> float:
    from nvbio_tpu_torch.index.blockwise import blockwise_bwt
    from nvbio_tpu_torch.io.pac import save_bwt
    from nvbio_tpu_torch.utils.console import log_info, log_stats

    bwt, primary, st = blockwise_bwt(np.asarray(ref.codes), device=dev)
    stages.update({f"bw_{k}": st[k] for k in (
        "counting_s", "upload_s", "extract_s", "sb_sort_s", "block_sort_s",
        "deepen_s", "emit_fetch_s", "superblocks", "blocks",
        "deepen_rounds")})
    t = time.perf_counter()
    save_bwt(bwt, primary, args.prefix + ".bwt",
             compress="lz4" if args.bwt_lz4 else None)
    t = _timed(stages, "bw_save", t)
    log_stats(f"blockwise {dev.type} BWT built in {st['total_s']:.2f}s "
              f"({st['blocks']} blocks / {st['superblocks']} superblocks, "
              f"primary={primary})")
    log_info(f"wrote {args.prefix}.bwt (nvBWT format)")
    return t


def _build_fmi(args, ref, dev, stages: dict, t: float) -> float:
    from nvbio_tpu_torch.fmi.index import build_fmindex
    from nvbio_tpu_torch.index.device_sa import (
        build_fmindex_device,
        prefer_device_sa,
    )
    from nvbio_tpu_torch.utils.console import log_info, log_stats

    on_device = args.sa_backend == "device" or (
        args.sa_backend == "auto"
        and prefer_device_sa(ref.total_length, dev))
    if on_device:
        sort: dict = {}
        fmi = build_fmindex_device(ref.codes, args.sa_interval, dev, sort)
        stages.update({f"fm_{k}": v for k, v in sort.items()})
        t = time.perf_counter()
    else:
        fmi = build_fmindex(ref.codes, sa_interval=args.sa_interval)
        t = _timed(stages, "fm_host", t)
    arrays = fmi.arrays()
    t = _timed(stages, "fm_fetch", t)
    np.savez_compressed(args.prefix + ".fmi.npz", **arrays)
    t = _timed(stages, "fm_save", t)
    log_stats(f"FM-index built ({dev.type if on_device else 'host'} suffix "
              f"sort, primary={fmi.primary}, SA interval={fmi.sa_interval})")
    if args.bwt:
        from nvbio_tpu_torch import packed
        from nvbio_tpu_torch.io.pac import save_bwt

        codes = packed.unpack(arrays["bwt_words"], fmi.n, 2)
        save_bwt(codes, fmi.primary, args.prefix + ".bwt",
                 compress="lz4" if args.bwt_lz4 else None)
        t = _timed(stages, "bwt", t)
        log_info(f"wrote {args.prefix}.bwt (nvBWT format)")
    return t
