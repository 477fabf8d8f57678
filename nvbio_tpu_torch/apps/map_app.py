"""`nvbio_tpu_torch map` — Bowtie2-style read mapping to SAM or BAM.

    python -m nvbio_tpu_torch map <ref.fa | prefix> reads.fq -o out.sam|bam
    python -m nvbio_tpu_torch map <ref.fa | prefix> -1 r1.fq -2 r2.fq
        [-I MIN] [-X MAX] [--no-rescue] [--pe-policy fr|rf|ff]
        [--no-discordant] [--local] [--all] [--config FILE]
        [--mapq-filter Q] [--report FILE] [--debug-output FILE]
        [--profile DIR] [--device cpu]
        [--dist [--coordinator HOST:PORT --num-processes N --process-id R]]

Port of ``nvbio_tpu/apps/map_app.py``: single-end and paired-end,
end-to-end or local (``--local``), best-alignment or all-mapping
(``--all``: every locus above threshold, SE and PE, the others as secondary
records). ``--config FILE`` overlays ``key=value`` lines onto the
``MapParams`` fields after the presets (``select_mode=randomized`` picks
hits by SumTree draws). Seeding is by q-gram index (default) or FM index
(``--seeding fmi``, or ``seeding=fmi`` in the config). The reference is a
FASTA (index built on the fly), the prefix of either package's ``index``
artifacts (``<prefix>.ref.npz``, and ``<prefix>.qgram.npz`` or else
``<prefix>.qgroup.npz``, or ``<prefix>.fmi.npz`` when present, else built
on the fly), or a BWA-style ``<prefix>.pac/.ann/.amb`` set (index built on
the fly). The output is SAM, or BAM by the ``.bam`` extension. ``--mapq-filter
Q`` writes mapped primaries below Q as unmapped and drops filtered
secondaries; ``--report`` writes an HTML stats report (SE and PE, not
``--all``); ``--debug-output`` writes binary per-read diagnostics (SE, not
``--all``); ``--profile DIR`` writes a ``torch.profiler`` Chrome trace into
DIR. Under the profiler the mapper marks its stages as ``nvbio.*`` spans
(``utils.timers.span``): ``dispatch`` (args: the batch's ordinal) holds
``upload`` (the reads to the device), ``seed`` (index lookup or FM search
and locate, pass 0, the 1-mismatch loci), ``vote`` (the dedup), ``extend``
(candidate scoring), ``reseed`` (the reseed pass, its own seed, vote and
extend inside), ``finalize`` (traceback and MAPQ) and ``rescue`` (PE mate
rescue); ``fetch`` and ``wait`` (the copies to the host, the wait for
them) follow. It also counts ``cand_slots`` (the B x C candidate slots
scored), ``cand_valid`` (those holding a candidate), ``reseed_rows`` (the
reseed queue's rows) and ``reseed_needed`` (the reads that needed the
pass), logged after the run. Without ``--profile`` none of this is
recorded. The single-end loop dispatches batch i+1, with its copies to the host
enqueued behind it, before it formats batch i. Runs on the CUDA card unless
``--device cpu`` is given.

``--dist`` (or ``--coordinator``/``--num-processes``) makes the run one
process of several (``nvbio_tpu/apps/map_app.py:181-196``): each process
joins a gloo group (``parallel.dist.init_distributed``: the flags, else
torchrun's ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``), maps
the batches ``i % N == R`` of the input on its own device and writes
``<output>.shard<R>``; after a barrier process 0 merges the shards under one
header into ``<output>`` and removes them. The group carries only that
barrier, no tensors, so it is gloo on the card too, and several processes
may share one card. As in the JAX package, a shard is SAM text whatever the
output's extension, so ``-o out.bam`` ends as SAM text in ``out.bam``.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


def add_parser(sub):
    p = sub.add_parser("map", help="map reads (SE or PE) -> SAM/BAM")
    p.add_argument("reference", help="index prefix (from `index`), .pac "
                                     "prefix or FASTA")
    p.add_argument("reads", nargs="?", help="single-end FASTQ(.gz)")
    p.add_argument("-1", dest="mate1", help="mate-1 FASTQ (paired-end)")
    p.add_argument("-2", dest="mate2", help="mate-2 FASTQ (paired-end)")
    p.add_argument("-o", "--output", default="-",
                   help="output SAM/BAM by extension (default stdout SAM)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--max-read-len", type=int, default=128)
    p.add_argument("--seed-len", type=int, default=22)
    p.add_argument("--seed-stride", type=int, default=15)
    p.add_argument("--hits-per-seed", type=int, default=4)
    p.add_argument("--max-dist", type=int, default=15)
    p.add_argument("--seeding", choices=["qgram", "fmi"], default="qgram")
    p.add_argument("--mode", choices=["sw", "ed"], default="sw",
                   help="sw: quality-aware Gotoh (bowtie2-like, default); "
                        "ed: unit-cost edit distance (nvBowtie --ed)")
    p.add_argument("--local", action="store_true",
                   help="local alignment (soft-clipped ends, bowtie2 "
                        "--local scoring + local MAPQ)")
    p.add_argument("--report", help="write an HTML stats report")
    p.add_argument("--profile", metavar="DIR",
                   help="write a torch.profiler trace (Chrome trace JSON) "
                        "into DIR")
    p.add_argument("--mapq-filter", type=int, default=0, metavar="Q",
                   help="suppress alignments with MAPQ < Q (emitted as "
                        "unmapped; reference output mapq filter)")
    p.add_argument("--debug-output", metavar="FILE",
                   help="also dump binary per-read diagnostics "
                        "(DebugOutput, output_debug.h) — SE only")
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
    p.add_argument("--dist", action="store_true",
                   help="one process of a multi-process run: a gloo "
                        "process group (coordinator from --coordinator or "
                        "torchrun's MASTER_ADDR/MASTER_PORT), round-robin "
                        "input batches per process, per-process SAM shards "
                        "merged by process 0. The group carries only a "
                        "barrier, so processes may share a card; or launch "
                        "with torchrun --nproc-per-node N -m nvbio_tpu_torch "
                        "map ... --dist")
    p.add_argument("--coordinator", metavar="HOST:PORT",
                   help="process group rendezvous address (tcp://HOST:PORT)")
    p.add_argument("--num-processes", type=int,
                   help="processes in the run (else WORLD_SIZE)")
    p.add_argument("--process-id", type=int,
                   help="this process's rank, 0..N-1 (else RANK)")
    p.set_defaults(func=run)
    return p


def _load_reference(path: str, seeding: str = "qgram"):
    """(Reference, seeding index or None): a FASTA or ``.pac`` prefix has
    no index (the mapper builds one); a ``.ref.npz`` prefix brings the
    index either package's ``index`` app wrote beside it, where present:
    for q-gram seeding its ``.qgram.npz``, else its ``.qgroup.npz``; for
    FM seeding its ``.fmi.npz``."""
    from nvbio_tpu_torch.fmi.index import FMIndex
    from nvbio_tpu_torch.io.reference import Reference
    from nvbio_tpu_torch.qgram import QGramIndex, QGroupIndex

    if path.endswith((".fa", ".fasta", ".fa.gz", ".fasta.gz")):
        return Reference.from_fasta(path), None
    if os.path.exists(path + ".pac") and not os.path.exists(path + ".ref.npz"):
        from nvbio_tpu_torch.io.pac import load_reference_pac

        return load_reference_pac(path), None
    if not os.path.exists(path + ".ref.npz"):
        raise SystemExit(f"nvbio_tpu_torch map: neither {path}.ref.npz nor "
                         f"{path}.pac found")
    ref = Reference.load(path + ".ref.npz")
    index = None
    if seeding == "qgram" and os.path.exists(path + ".qgram.npz"):
        index = QGramIndex.load(path + ".qgram.npz")
    elif seeding == "qgram" and os.path.exists(path + ".qgroup.npz"):
        index = QGroupIndex.load(path + ".qgroup.npz")
    elif seeding == "fmi" and os.path.exists(path + ".fmi.npz"):
        index = FMIndex.load(path + ".fmi.npz")
    return ref, index


def gauge_batch_size(mapper, batch_size: int, max_len: int,
                     floor: int = 64) -> int:
    """Halve the batch size until one probe step fits device memory.

    The analogue of the reference's ComputeThread batch-size gauging
    (``nvBowtie/nvBowtie.cpp`` / ``compute_thread.cu:121-143``): rather than
    dying out of memory mid-run, probe once up front (a batch of
    zero-length reads) and back off, down to ``floor``. Any other error is
    raised.
    """
    from nvbio_tpu_torch.io.fastq import ReadBatch
    from nvbio_tpu_torch.utils.console import log_info

    while True:
        probe = ReadBatch(
            names=[""] * batch_size,
            codes=np.zeros((batch_size, max_len), np.uint8),
            quals=np.zeros((batch_size, max_len), np.uint8),
            lengths=np.zeros(batch_size, np.int32),
        )
        try:
            mapper.dispatch(probe)["mapped"][:1].cpu()
            return batch_size
        except RuntimeError as e:  # torch.cuda.OutOfMemoryError is one
            oom = (isinstance(e, torch.cuda.OutOfMemoryError)
                   or "out of memory" in str(e).lower())
            if not oom or batch_size <= floor:
                raise
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()
        batch_size //= 2
        log_info(f"device out of memory at batch {batch_size * 2}; "
                 f"halving to {batch_size}")


def dump_debug(dbg, mapper, res: dict) -> None:
    """One batch's host result arrays into ``DebugOutput``: each read's
    contig and 1-based position from its window and text start."""
    gpos = res["window_start"].astype(np.int64) + res["text_start"]
    cis = np.searchsorted(mapper.ref_offsets, gpos, side="right") - 1
    cis = np.clip(cis, 0, len(mapper.ref_names) - 1)
    local = gpos - mapper.ref_offsets[cis] + 1
    dbg.process_batch(res, cis, local)


def map_single_end(mapper, batches, emit, stats=None, dbg=None):
    """The single-end loop: batch i+1 is parsed and dispatched, and its
    copies to the host enqueued, before batch i is formatted, so the card
    works on i+1 while the host formats i. ``emit`` takes each record;
    ``stats`` and ``dbg`` take each batch's results. Returns the parse,
    dispatch and fetch+format ``StageStats`` (host seconds)."""
    from nvbio_tpu_torch.utils.timers import StageStats, Timer

    st_parse = StageStats("parse")
    st_dispatch = StageStats("dispatch")
    st_fmt = StageStats("fetch+format")
    it = iter(batches)
    pending = None
    while True:
        with Timer() as tp:
            batch = next(it, None)
        nxt = None
        if batch is not None:
            st_parse.add(tp.seconds, len(batch.names))
            with Timer() as td:
                nxt = (batch, mapper.fetch(mapper.dispatch(batch)))
            st_dispatch.add(td.seconds, len(batch.names))
        if pending is not None:
            pb, fetched = pending
            tf = Timer().start()
            host = fetched.wait()
            if stats is not None:
                stats.update_from_result(host, pb.lengths)
            if dbg is not None:
                dump_debug(dbg, mapper, host)
            for rec in mapper.format_fetched(pb, host):
                emit(rec)
            st_fmt.add(tf.stop(), len(pb.names))
        if nxt is None:
            return [st_parse, st_dispatch, st_fmt]
        pending = nxt


def _profiler(path: str | None, device: torch.device):
    if path is None:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


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
    from nvbio_tpu_torch.io.output import open_alignment_output
    from nvbio_tpu_torch.io.sam import SamRecord
    from nvbio_tpu_torch.utils.console import log_info, log_stats
    from nvbio_tpu_torch.utils.stats import AlignmentStats, html_report
    from nvbio_tpu_torch.utils.timers import counters, reset_counters

    paired = args.mate1 is not None
    if paired and not args.mate2:
        raise SystemExit("paired-end needs both -1 and -2")
    if not paired and not args.reads:
        raise SystemExit("provide a reads file (or -1/-2 for paired-end)")

    # multi-process: join the group, stripe the input by process and write
    # a per-process shard, merged below by process 0 (nvBowtie.cpp:644-699
    # is the reference's one-ComputeThread-per-GPU model)
    dist_on = joined = False
    out_path = args.output
    if args.dist or args.coordinator or args.num_processes:
        from nvbio_tpu_torch.parallel import dist as pdist

        try:
            joined = not torch.distributed.is_initialized() and \
                pdist.init_distributed(args.coordinator, args.num_processes,
                                       args.process_id)
        except ValueError as e:
            raise SystemExit(f"nvbio_tpu_torch map: {e}") from None
        dist_on = pdist.process_count() > 1
        if dist_on and args.output != "-":
            out_path = pdist.shard_path(args.output)
    common = dict(
        max_read_len=args.max_read_len,
        seed_len=args.seed_len,
        seed_stride=args.seed_stride,
        hits_per_seed=args.hits_per_seed,
        max_dist=args.max_dist,
        seeding=args.seeding,
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
    ref, index = _load_reference(args.reference, params.seeding)
    device = args.device
    if dist_on and device is None and torch.cuda.is_available():
        # one card a process where there are several (torchrun's
        # LOCAL_RANK); processes may share one
        from nvbio_tpu_torch.parallel.mesh import local_rank

        device = f"cuda:{local_rank() % torch.cuda.device_count()}"
    mapper = ReadMapper.build(ref, params, index=index, device=device)
    log_info(f"reference + index ready in {time.time() - t0:.1f}s "
             f"({ref.total_length:,} bp, seeding={params.seeding}) on "
             f"{mapper.device}")
    args.batch = gauge_batch_size(mapper, args.batch, args.max_read_len)

    lengths = (ref.offsets[1:] - ref.offsets[:-1]).tolist()
    n_reads = n_mapped = 0
    stats = AlignmentStats()
    stage_stats = []
    t0 = time.time()

    def emit(rec):
        nonlocal n_reads, n_mapped
        if args.mapq_filter and not rec.flag & 0x4:
            if rec.flag & 0x100:
                return  # filtered secondaries are dropped outright
            if rec.mapq < args.mapq_filter:
                # below-threshold alignments are reported unmapped
                # (the reference's output mapq filter)
                rec = SamRecord(
                    qname=rec.qname, flag=(rec.flag | 0x4) & ~0x912,
                    rname="*", pos=0, mapq=0, cigar="*",
                    seq=rec.seq, qual=rec.qual)
        w.write(rec)
        if not rec.flag & 0x100:  # secondaries are not reads
            n_reads += 1
            n_mapped += 0 if rec.flag & 0x4 else 1

    def batches(path):
        it = fastq_batches(path, args.batch, args.max_read_len,
                           alphabet=Alphabet.DNA_N)
        return pdist.host_stripe(it) if dist_on else it

    dbg = None
    if args.debug_output and not paired and not args.all_mode:
        from nvbio_tpu_torch.io.debug import DebugOutput

        dbg = DebugOutput(args.debug_output)
    prof = _profiler(args.profile, mapper.device)
    reset_counters()
    with prof, open_alignment_output(out_path, ref.names, lengths) as w:
        if paired:
            for b1, b2 in zip(batches(args.mate1), batches(args.mate2)):
                if args.all_mode:  # PE all-mapping: every concordant locus
                    recs = map_pair_batch_all(mapper, b1, b2)
                else:
                    recs = map_pair_batch(mapper, b1, b2, stats=stats)
                for rec in recs:
                    emit(rec)
        elif args.all_mode:
            for batch in batches(args.reads):
                for rec in mapper.map_batch_all(batch):
                    emit(rec)
        else:
            stage_stats = map_single_end(mapper, batches(args.reads), emit,
                                         stats, dbg)
    if dbg is not None:
        dbg.close()
        log_info(f"debug records written to {args.debug_output}")
    if dist_on and args.output != "-":
        # every process's shard is closed; process 0 merges them
        torch.distributed.barrier()
        if pdist.process_index() == 0:
            paths = [pdist.shard_path(args.output, p)
                     for p in range(pdist.process_count())]
            nrec = pdist.merge_sam_shards(paths, args.output, remove=True)
            log_info(f"merged {len(paths)} SAM shards -> {args.output} "
                     f"({nrec:,} records)")
    if joined:
        torch.distributed.destroy_process_group()
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, f"nvbio_tpu_torch.{os.getpid()}."
                                           f"{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(trace)
        log_info(f"profiler trace written to {trace}")
        log_info("counters: " + " ".join(
            f"{k}={v}" for k, v in sorted(counters().items())))
    dt = time.time() - t0
    log_stats(f"{n_reads:,} reads in {dt:.1f}s "
              f"({n_reads / max(dt, 1e-9):,.0f} reads/s); {n_mapped:,} mapped "
              f"({100.0 * n_mapped / max(n_reads, 1):.2f}%)")
    if args.report:
        stats.wall_s = dt
        for st in stage_stats:
            log_stats(st.summary())
        with open(args.report, "w") as f:
            f.write(html_report(stats, stage_stats=stage_stats))
        log_info(f"HTML report written to {args.report}")
    return 0
