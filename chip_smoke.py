"""On-card check of the PyTorch/CUDA port (nvbio_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:
  1. card: name and power limit (nvidia-smi);
  2. build: every CUDA kernel compiled by nvcc for sm_90a, and K1, K2, K3
     and K5 once more at band 21 (max_dist 10) and at band 33 (mem's
     max_dist 16), outside the precompiled bands — one nvcc per library,
     all in parallel — build seconds and ptxas registers;
  3. kernels: each kernel against its plain torch version on the card, at
     its path's shapes, bit for bit on every output (integer DPs: no
     tolerance), timed with CUDA events (median of 7 single calls, and
     per call of 10 queued back to back, median of 3; the plain version
     on its comparison call), with its bound and
     its instantiation's ptxas registers: K1 candidate scoring B=32768,
     C=24, L=100, W=31, 256 of the reads with penalties past the packed
     path's guard (rescored in int32), and its LOCAL instantiation (the
     local path's candidates) on the same windows, beside the local stage
     it replaced (torch.where + extract_window + K3-LOCAL over B*C flat
     rows: time, peak device memory, equal scores); K2 traceback and
     K2-LOCAL B=32768,
     L=100, W=31 under the lanes per read that k2_group picks (1), and K2
     beside it at the other group size (4) and at B=4096 under both; K3
     (rescue rescore) B=32768, M=100, W=31, in the contract form and
     through its packed-window entry (the mapping path's; with the penalty
     plane, the scalar mismatch, and LOCAL); K3-LOCAL, the flat scorer the
     local candidates no longer take, at its old shape B*C=786432, M=100,
     W=31; K4 (mate locate) B=32768, M=100, T=531, in the contract form
     and through its packed-window entry, both at M=150, 256 and 512 on
     4096 mates, and the contract form over 5 symbols; K2-WIDE and
     K2-WIDE-LOCAL (full-matrix mate traceback) B=32768, M=100, W=230 on
     left-padded windows (directions in shared memory), and K2-WIDE at
     W=1054, M=512 on 256 reads (the global-scratch route); K5
     (register-tiled scorer) G=4096 blocks, L=100, W=31 and 17 with
     bench.py's flags (every pair of alignments must take its packed
     loop), G=64 with every flag off and ragged lengths, and G=64 ragged
     with pairs its packed guard refuses (penalties past int8 or past the
     limit, text codes 65536 apart or negative; the share of pairs on the
     packed loop equal to what kernels.k5_packed_pairs admits);
     K2 at the --all shape B*C=786432, W=31; K2-WIDE at K2's shape (W=31)
     beside K2; K1, K2, K3 (both entries) and K5 at band 21;
  4. main path (single-end): a seeded uniform 100 Mbp genome, its q-gram
     index built on the host, ReadMapper.build(...) on cuda, 4 batches of
     32768 reads of 100 bp with 1% substitutions through dispatch +
     format_batch; launch counters +2 (K1) and +1 (K2) per batch,
     sensitivity (mapped within 2*max_dist of the truth on the right
     strand) >= 0.95;
  5. paired-end path: 2 batches of 32768 FR pairs (fragments 200-500,
     -X 500), 5% with a seedless mate 2; launch counters +2 each for K1,
     K2 and the packed-window entries of K3 and K4 (the rescue reads its
     windows from the packed genome) per batch, +0 for their contract
     forms; per-mate sensitivity >= 0.95, proper share >= 0.90, seedless
     mates placed >= 0.90; then single-end at max_dist 10 (band 21): 1
     batch of 32768 reads, K1 +2 and K2 +1 through the band-21 libraries,
     sensitivity >= 0.95; and paired-end with 150-base mates and rescue
     on (K4 over 5 words): 1 batch of 32768 pairs, as the paired-end path;
  6. FM seeding: the genome's FM index built twice, by host SA-IS (then
     BWT, checkpoints, sampled SA at interval 8 and the rank and SSA rows
     on the host: the cpu index) and on the card ([index-device]:
     build_fmindex_device, prefix doubling over torch.sort and every table
     on the card; seconds by stage, rows tied after the 26-symbol
     bootstrap, doubling rounds, peak device memory, M suffixes/s; every
     table equal to the host build's; one build profiled), its k = 11
     table built there; each part's seconds and the bytes on the card;
     [fmi-search]: 8192 seeds of 22 bases through backward search (the table's start), locate of 6 rows each and the
     1-mismatch top-K search on cuda, equal to the same calls on the cpu
     index (no table); ms a call, device ops, a bytes bound for search and
     locate (32-byte rank rows, 8-byte SSA rows); [fmi]: 2 batches of 32768
     reads with seeding="fmi" (pass 0 on, the reseed pass's 1-mismatch
     search), K1 +2 and K2 +1 a batch, sensitivity >= 0.95, one batch
     profiled and its FM stage alone (ms, device ops, share of the batch's
     device busy, peak memory); [paired-fmi]: 1 batch of FR pairs as the
     paired-end path's (K1, K2, K3 and K4 +2; proper >= 0.90, seedless
     mates placed >= 0.90);
  6b. [index-device]: the repeat-planted genome of phase 9 built on the
     card against its host SA-IS build (every table equal; host seconds
     from the same run), and one build of 390 Mbp of random bases checked
     by locating 8192 seeds drawn from the text at their positions;
     [blockwise]: blockwise_bwt of the 100 Mbp genome and of the
     repeat-planted copy with knobs forcing >= 3 superblocks and >= 8
     blocks (BWT and primary equal to the one-shot device builds'), then
     of 2.5 Gbp of random bases (n > 2^31) with the defaults: seconds by
     stage, superblocks, blocks, deepening rounds, host tie rows, peak
     device memory, M suffixes/s; its symbol counts equal to the text's
     and an LF walk over int64 checkpoints built on the card (every 2^16
     rows) spelling the text's last 4096 symbols; [setbwt]: BwteDevice on
     4 M reads of 100 bp (1% copies) in blocks of 500 k (seconds a block,
     M symbols/s, peak memory; the read set's symbol counts and each
     read's '$' tag once), and on its first 250 k reads equal to the
     native engine's BWT (mse_bwt_incremental(method="native"), timed);
     [randomized]: select_mode="randomized" on 1 batch of 32768 SE reads
     (q-gram), 1 batch FM-seeded and 1 batch of FR pairs: reads/s
     (pairs/s), sensitivity >= 0.95, launches as their stratified paths',
     one profiled batch each, GPU = CPU records on 1024 reads and pairs;
  7. local path: 2 batches of 32768 reads under --local, a third with a
     random 15-base genome-right tail; K1 (LOCAL) +2 (first pass and
     reseed), K2-LOCAL +1, K3 +0 per batch; sensitivity >= 0.95, tailed
     reads soft-clipped >= 0.8; the peak device memory of one batch;
  8. paired-full: 1 batch of the paired-end pairs with
     pe_full_traceback=True (K2-WIDE +2, K2 +0, K1 +2, K3 +2, K4 +2,
     packed entries), and 1 batch under --local (K2-WIDE-LOCAL +2, K1
     (LOCAL) +2, K3 +2, K4 +2);
     per-mate sensitivity >= 0.95, proper share >= 0.90, every mapped
     CIGAR's query length equal to len(SEQ);
  9. all: the genome again with 2 Mbp of it pasted, exactly, over other
     loci (its own q-gram index), so reads from those segments have two
     loci; 1 batch of 32768 of its reads through map_batch_all (--all; K1
     +1, K2 +1), primaries placed >= 0.95, some record at the truth >=
     0.95, secondaries per read > 0;
 10. paired-all: 1 batch of 32768 pairs of that genome, with no seedless
     mate, through map_pair_batch_all (K1 +2, K2 +2), per-mate primaries
     placed >= 0.95, secondary records > 0;
 11. gcups: K5 at W=31 and 17 as bench.py's GCUPS leg runs it (G=4096,
     three passes of 10 launches, median), its GCUPS and launch count;
 12. cli: the app (``map``) in this process, on cuda, against the genome
     written as g.pac/.ann/.amb (the app builds its q-gram index): 2
     batches of 32768 single-end reads with -o se.bam --report
     --debug-output --mapq-filter 10 (K1 +2, K2 +1 a batch, plus the batch
     gauge's probe, one single-end dispatch), then 1 batch of 32768 FR
     pairs (5% seedless mates 2) with -o pe.bam --report (K1, K2, K3 and
     K4 +2, plus the probe); the BAMs decoded: one primary a read,
     sensitivity >= 0.95 from the truth in the read names, no mapped
     primary below MAPQ 10, the reports' counts equal the BAMs', 65536
     debug records; the BAM written again from its records (equal bytes,
     timed); 1024 reads and 1024 pairs of the genome's first 8 Mbp (its
     own .pac) through the app on cuda (with --profile: a trace written)
     and on cpu, identical BAM records, debug bytes and report counts; the
     app's overlapped single-end loop against a map_batch loop over the
     same 2 batches, A B B A, equal records; and the first 8 Mbp as
     a .ref.npz prefix with the port's .fmi.npz beside it: 1024 reads with
     --seeding fmi to SAM on cuda (K1 +2, K2 +1, plus the probe) and on
     cpu, identical records; then the index app (``index``) in this
     process on cuda: the 100 Mbp genome as a FASTA with --fmi --no-qgram
     (the suffix sort on the card; .ref.npz and .fmi.npz equal to the
     in-process builds, stage seconds from its log), its first 8 Mbp with
     --fmi --bwt --bwt-lz4 --pac --no-qgram (.fmi.npz, .ref.npz, .bwt and
     .pac equal to the in-process builds), the 8 Mbp FASTA with
     --bwt-blockwise --bwt-lz4 (.bwt bytes equal to the --fmi --bwt
     run's), its first 1 Mbp with --qgroup 16 --no-qgram (.qgroup.npz and
     .ref.npz equal to the in-process builds) and map from that prefix
     (Q-Group seeding, q = 16) of 1024 reads on cuda and on cpu,
     identical records; then the setbwt app on 65536 reads of 100 bp with
     --incremental 65536 --method device --txt --lz4 on cuda and on cpu,
     identical files;
 12b. mem: the MemMapper at the app's defaults (batch 1024, max_read_len
     256, -k 19, -T 30, max_dist 16: band 33, built at first use) on the
     100 Mbp genome, the reversed genome's FM index built on the card:
     8 batches of 1024 reads of 150 bp (1% substitutions, a third ending
     in 20 random bases); K2-LOCAL launched exactly once a batch and no
     other kernel; sensitivity (primary within max_dist of the truth on
     the right strand) >= 0.95, tailed reads soft-clipped >= 0.8; reads/s,
     host formatting's share of the wall, the SMEM stage alone (ms,
     device ops, share of the batch's device busy), peak memory; K2-LOCAL
     at this shape (4096 lanes, M = 256, W = 33) bit for bit against its
     plain version, with its bound and registers (the kernel entry
     banded_traceback_mem); secondaries per read on the repeat-planted
     genome (> 0, with XA); GPU = CPU SAM records of 128 reads on the
     first 8 Mbp (the cpu index by host SA-IS);
 12c. correct: the three Lighter passes on the card over 1.38 M reads of
     100 bp (a seeded 4.6 Mbp genome at 30x, 1% substitutions), batches of
     4096, k = 17, with the app's 2^24-bit filters and with 2^27-bit ones:
     seconds a pass, reads/s, both filters' occupancy, substituted bases
     before and after (fewer after required with 2^27 bits) and newly
     broken, device ops of one correct batch; the app on 10 k reads over
     50 kbp on cuda and on cpu: identical FASTQ bytes;
 12d. sort: the single-end records of phase 4's first two batches
     (65536) coordinate-sorted
     SAM to SAM in one run and in 8 spilled runs with the k-way merge, on
     cuda and on cpu: records/s, the device sorts' ms, identical files,
     (ref, pos) order with unmapped records last;
 12e. cli: mem (1024 reads on a FASTA of the first 8 Mbp, to BAM; one
     K2-LOCAL launch, sensitivity >= 0.95), sort of that BAM on cuda and
     on cpu (equal, ordered), extract --rc (the reverse complements),
     aln-diff --json of the BAM against itself (every record agrees) and
     serve on a thread over a .ref.npz/.fmi.npz prefix (PING, LIST, GET;
     FMClient.get's FMIndex equal to the .fmi.npz's);
 13. profile: one batch's dispatch of each mapping path under
     torch.profiler — device busy share and the largest device-time
     consumers; the peak device memory of one single-end and one local
     batch;
 14. GPU = CPU: 1024 reads or pairs of each of the ten mapping paths
     mapped on cuda and on cpu must give identical SAM records (those of
     the two --all paths including secondaries; the FM paths' cpu index
     has no k-mer table).
 12f. assemble: a seeded 100 kbp contig and a second haplotype of it with
     a SNP about every 400 bp; 100-base reads at 30x, half from each
     haplotype (1% substitutions, Phred 20-40) mapped by the map app on
     cuda, coordinate-sorted by the sort app, then ``assemble --regions
     256 --region-size 200 --support`` on cuda and on cpu: identical FASTA
     bytes; rows, nodes, edges, cyclic regions, haplotypes, the seconds of
     each stage (load, graph, k-best, support) and the k-mer scan's ms on
     the card; of the SNPs at least k = 15 bases inside a region, >= 90%
     with both the reference and the variant haplotype emitted;
 12g. fm-library: on the 100 Mbp FM index, search_1mm over 1024 seeds of
     22 bases, search_1mm_hybrid and search_kmm (k = 2, 32 states) over
     8192, extend_backward and extend_forward of the 8192 seeds with the
     reversed genome's index built on the card (each equal to a plain
     backward search on its side), a SuffixTrie of the first 256 kbp at
     depth 10, a QGramSetIndex of 65536 reads (q = 15, stride 5) and a
     protein FM index of 4 Mi residues (8192 queries of 9; 64 against a
     numpy scan); ms and device ops of each; every result equal on cuda
     and on cpu (a subset of the seeds on the cpu index);
 12k. surface: every package-level name (the names the JAX package's
     __init__ files re-export) imported through its package in this
     process, each the same object as its defining module's;
     packed.gather_symbols on the 100 Mbp genome's words on the card at
     1 M seeded positions (the last symbol among them) against numpy's
     unpack of the same words and gather_symbols on their cpu copy, and a
     PackedArray of them through .to("cuda") and to_codes; fmi.rank.rank2
     on the card's FM rank rows at 1 M seeded (c, lo <= hi) triples
     against two rank calls on the card and rank2 on the cpu index's rows
     (equality only: no path of the port calls these host-API helpers, so
     they are not timed);
 12h. scan: extension="scan" (the aligner library's engine: the banded
     scan scorer over the B*C extracted windows, the scan traceback and,
     for mate rescue, the full-matrix wavefront over the 531-wide window),
     one batch of 32768 of each of single-end, paired-end (5% seedless
     mates), local, paired-full and --all (the repeat copy) on cuda through
     the kernel route's phases and sensitivity limits, no kernel launched;
     per batch the seconds, device ops and busy ms, peak device memory;
     the reads whose records differ from the kernel route's on the same
     batch (reported: the JAX package's two engines differ by design);
     GPU = CPU SAM records on 512 reads or pairs of each;
 12i. aligner: the aligner library on the card — ED, SW and Gotoh x
     GLOBAL, SEMI_GLOBAL, LOCAL full-matrix over 32768 pairs of 100 x 531,
     the banded Gotoh score (three types) and traceback (SEMI_GLOBAL,
     LOCAL) at W = 31 over 32768 x (100, 130), the XLA Myers over 32768 x
     (100, 531), Gotoh LOCAL + BLOSUM62 over 4096 pairs of 256 x 512
     residues (gaps -5/-3): ms, device ops and busy ms, GCUPS (cells/s)
     and cuda = cpu on 256 lanes of each call;
 12j. dist: multi-GPU mapping over a NCCL group of this process (world 1:
     D = 2 and 4 need more cards, ``--dist-cards`` below) — a batch of
     32768 through the sharded single-end step with shard_qgram_index and
     with shard_fmindex(method="device", resident=True), and through the
     replicated paired (32768 pairs) and --all steps: seconds, launches a
     rank (the unsharded path's: K1 x2 + K2 x1, the PE set), peak memory;
     records equal to the unsharded ReadMapper's on the same batch (the
     sharded steps: every read the first pass maps; the reads the reseed
     pass maps differently are counted); dryrun_multichip; GPU = CPU on
     1024 reads through a gloo group of the same rank; map --dist with 2
     processes on the card over gloo, 2 batches, the merged SAM equal to
     the single-process records in stripe order;
Each phase's start (seconds since the script started) is printed as
[time] and kept in the JSON line ("phase_starts").
Prints one JSON line of kernels before the card's line and the last line,
which is {"ok": true, "device": {...}}. Imports nothing of JAX or
nvbio_tpu.

    python3 chip_smoke.py --dist-cards 2 4

runs only [dist]'s step legs at each world size as spawned ranks, one
card each (a machine with at least that many cards).
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

GENOME_LEN = 100_000_000
B, L, MAX_DIST = 32768, 100, 15
W = 2 * MAX_DIST + 1
N_BATCHES = 4
N_BATCHES_PE = N_BATCHES_LOCAL = 2
N_CMP = 1024
W_FULL = (L + W - 1) + L        # the full-matrix traceback's band T + M
G_K5 = 4096                     # bench.py's GCUPS leg: 4096 blocks of 1024
MAXINS = 500                    # bowtie2 -X default: mate rescue window
RW = MAXINS + W                 # K4's text length
SEED = 20261016
N_REPEATS, REPEAT_LEN = 400, 5000  # the --all phases' planted repeats
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
# Issue ceiling of a Hopper SM: 4 warp schedulers, each issuing one warp
# instruction (32 threads) per clock; no mix of integer instructions retires
# faster (nvbio_tpu_torch/tools/int32_rate.py measures this on the card).
ISSUE_LANES_PER_SM = 128
# Least instructions per band cell of the SEMI_GLOBAL recurrence, with the
# sm_90 DPX add-max (max(a + b, c) in one instruction):
#   K1: sub = compare + select (2); H0 = max(H + sub, E') (1); E' = add-max
#       over H + po (2); F = add-max over H0 + to (2); H = max(H0, F) (1).
#   K2: the same recurrence with diag, E+pe, H+po, F+te and H0+to kept
#       apart for the direction bits (sub 2, diag 1, E' 3, H0 1, F 3, H 1),
#       plus e_ext, f_ext and two hdir compares (4), the byte's packing and
#       its store (2): 17; each walk step: two address computations and
#       loads (4), the op and its entry (4), its store and the cursor (2),
#       nm, i, k and the state (4): 14.
#   K3: K1's sub (2), H0 (1) and E' (2), then the lazy F of the flat
#       scorer: g = add-max over H0 + (to - te*k) (1) and H = add-max
#       max(H0, g + te*(k-1)) (1): 7. LOCAL adds the floor of H0 at 0
#       (1; H + sub, E' and 0 need an add and a three-input max) and the
#       running max of the in-range cells (1): 9.
#   K2-LOCAL: K2's 17, its H0 = max(diag, E) becoming the three-input
#       max(diag, E, 0) (+0), plus the zero-cell direction (compare +
#       select, 2) and the sink (one predicated compare, two selects, 3):
#       22 per cell; each walk step adds the zero-stop test: 15.
#   K2-WIDE, K2-WIDE-LOCAL: K2's and K2-LOCAL's recurrence, walk and
#       counts (17 and 14, 22 and 15); its shuffles, the F scan across
#       lanes and the warp reductions are the warp layout's cost, not the
#       function's.
#   K5: K1's recurrence (8), with the sequential F of bench.py's flags;
#       its packed loop scores two alignments a register as K1's does
#       (the substitution of both halves one PRMT over two per-half byte
#       tables, as K1's one PRMT over one), so it counts
#       K1_OPS_PER_CELL_PACKED.
#   K4: per 32-bit word and text step: the Eq select over 4 symbols (3),
#       Eq & PV and the add with carry (2), D0 (2 three-input LOPs), Hp
#       and Hn (2), the two shifts with carry-in (2), PV and MV (2), the
#       last-word selects of Hp and Hn (2): 15; per text step: the text
#       load and its address (2), the two score bits and the score (4),
#       the best/bend compare and selects (3): 9.
K1_OPS_PER_CELL = 8
# K1's packed path retires two cells per instruction (16-bit halves, DPX
# u16x2): its bound counts 4 per cell; the int32 count stays beside it.
K1_OPS_PER_CELL_PACKED = 4
# K1's LOCAL packed path: per pair of cells K1's 8 with H = max(H0, F) made
# the three-input max(H0, F, 0) (+0) and the running max FIN = max(FIN,
# H0, F) (1): 9, so 4.5 per cell; its int32 count is K3-LOCAL's 9.
K1L_OPS_PER_CELL_PACKED = 4.5
N_GUARD_FAIL = 256   # K1's reads with penalties past the packed guard
B_SMALL = 4096       # K2 beside the main shape at a batch that cannot fill
                     # the card
K2_OPS_PER_CELL = 17
K2_OPS_PER_STEP = 14
K3_OPS_PER_CELL = 7
K3L_OPS_PER_CELL = 9
K2L_OPS_PER_CELL = 22
K2L_OPS_PER_STEP = 15
K4_OPS_PER_WORD_STEP = 15
K4_OPS_PER_STEP = 9
#   K4's packed entry: its text symbol from the stream word a step, a shift
#       and a mask (2), and one word load per 16 steps (not counted).
K4W_OPS_PER_STEP = K4_OPS_PER_STEP + 2
MAX_DIST_2 = 10                 # the any-band phases: max_dist 10, band 21
W2 = 2 * MAX_DIST_2 + 1
L_PE2 = 150                     # the wide-rescue phase's read length
K4_WIDTHS = (150, 256, 512)     # K4 beside the main shape, both entries
B_K4_WIDE = 4096
G_K5_2 = 1024                   # K5 at band 21


T_START = time.time()
STAMPS = {}     # phase name -> seconds since the script started


def stamp(name: str) -> None:
    """Record and print when the phase ``name`` starts."""
    STAMPS[name] = round(time.time() - T_START, 1)
    print(f"[time] {name} starts at {STAMPS[name]} s", flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_entries(log: str) -> dict:
    """{'kernel<template args>': (registers, spill bytes)} for each entry
    function in nvcc's -Xptxas -v output (names read from the mangled
    symbol: _Z..name_kernelILi8ELb0E.. -> name_kernel<8,0>)."""
    out, entry, spill = {}, "?", "?"
    for ln in log.splitlines():
        m = re.search(r"entry function '(\S+)'", ln)
        if m:
            nm = re.search(r"\d([A-Za-z_]+_kernel)I(.*?)EEv", m.group(1))
            entry = (f"{nm.group(1)}<"
                     f"{','.join(re.findall(r'L[ib](\d+)', nm.group(2)))}>"
                     if nm else m.group(1)[:40])
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[entry] = (int(m.group(1)), spill)
    return out


def ptxas_summary(log: str) -> list[str]:
    return [f"{e}: {r} regs, {sp} B spill"
            for e, (r, sp) in ptxas_entries(log).items()]


def cuda_ms(fn, reps: int = 7, warm: bool = True) -> float:
    """Median wall time of ``fn`` on the card, CUDA events, after a warm-up
    call (none with ``warm=False``: the caller has just run ``fn``)."""
    if warm:
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def cuda_ms_queued(fn, calls: int = 10, reps: int = 3) -> float:
    """Per-call time of ``calls`` calls of ``fn`` queued back to back
    between two CUDA events (median of ``reps``): the card's time per call
    once the host enqueues faster than the card runs, where ``cuda_ms``
    also counts the host's work before each launch."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def issue_per_s() -> float:
    """Instruction issue ceiling of this card in thread-instructions per
    second: SMs x 128 x max SM clock (nvidia-smi clocks.max.sm, MHz)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(smi("clocks.max.sm").split()[0])
    return sms * ISSUE_LANES_PER_SM * mhz * 1e6


def make_reads(genome, n, rng):
    """n reads of L bp at known starts: a third carry a 1 bp deletion, a
    third a 1 bp insertion, all ~1% substitutions. Returns genome-oriented
    patterns (B, L) int32 and starts."""
    starts = rng.integers(MAX_DIST, len(genome) - 2 * L, size=n)
    win = genome[starts[:, None] + np.arange(L + 1)].astype(np.int32)
    kind = rng.integers(0, 3, size=n)
    cut = rng.integers(10, L - 10, size=n)
    j = np.arange(L)[None, :]
    dele = np.where(j < cut[:, None], win[:, :L], win[:, 1:L + 1])
    ins_sym = rng.integers(0, 4, size=(n, 1))
    ins = np.where(j < cut[:, None], win[:, :L],
                   np.where(j == cut[:, None], ins_sym,
                            np.take_along_axis(win, np.maximum(j - 1, 0), 1)))
    pats = np.where((kind == 1)[:, None], dele,
                    np.where((kind == 2)[:, None], ins, win[:, :L]))
    sub = rng.random((n, L)) < 0.01
    pats = np.where(sub, (pats + rng.integers(1, 4, size=(n, L))) % 4, pats)
    return pats.astype(np.int32), starts


def phase_kernels(genome, words, dev, rng, regs):
    from nvbio_tpu_torch.align import kernels as K
    from nvbio_tpu_torch.bowtie.params import MapParams
    from nvbio_tpu_torch.packed import extract_window
    from nvbio_tpu_torch.tools.k5_operands import guard_operands

    sc = MapParams().scoring
    n = len(genome)
    TW = L + W - 1
    C, NCH = 24, 12
    pats, starts = make_reads(genome, B, rng)
    is_rc = rng.random(B) < 0.5
    reads = np.where(is_rc[:, None], (3 - pats)[:, ::-1], pats)
    rc = (3 - reads)[:, ::-1]
    quals = rng.integers(2, 41, size=(B, L))
    mm = -(2 + (4 * quals) // 40).astype(np.int32)
    # a block of reads whose penalties fail the packed path's guard (past
    # int8): K1 rescores their candidates in int32
    mm_k1 = mm.copy()
    mm_k1[:N_GUARD_FAIL] = -rng.integers(130, 250, size=(N_GUARD_FAIL, L))
    mm_rc = mm[:, ::-1]
    # candidates: slot 0 of the read's strand half is the true window,
    # slot 1 a jittered copy, the rest random loci; a few near the end
    true_w0 = starts - MAX_DIST
    w0 = rng.integers(0, n - 1, size=(B, C))
    half = np.where(is_rc, NCH, 0)
    rows = np.arange(B)
    w0[rows, half] = true_w0
    w0[rows, half + 1] = np.clip(true_w0 + rng.integers(-12, 13, size=B),
                                 0, n - 1)
    w0[:64, 5] = n - rng.integers(1, TW + 5, size=64)
    w0 = np.clip(w0, 0, n - 1)
    wlens = np.minimum(n - w0, TW)
    lens = np.full(B, L, np.int32)

    t = lambda a, dt=torch.int32: torch.from_numpy(
        np.ascontiguousarray(a)).to(dt).to(dev)
    k1_args = (t(reads), t(rc), t(lens), t(w0, torch.int64), t(wlens),
               words, sc, W, NCH, t(mm_k1), t(mm_k1[:, ::-1]))
    k1 = check_kernel("banded_score_cands", K.banded_score_cands,
                      K.banded_score_cands_plain, k1_args)
    best = k1["out"][0].max(dim=1).values
    print(f"[kernels] banded_score_cands: median best score="
          f"{float(best.float().median()):.1f}; packed guard limit "
          f"{K.k1_packed_limit(sc, W)}, {N_GUARD_FAIL * C} candidates of "
          f"{N_GUARD_FAIL} reads past it", flush=True)
    # K1's LOCAL instantiation on the same windows (the local path's
    # candidates), and the stage it replaced: the flat route over B*C rows
    lsc = MapParams.local().scoring
    k1l_args = (*k1_args[:6], lsc, W, NCH, *k1_args[9:])
    k1l = check_kernel("banded_score_cands_local", K.banded_score_cands,
                       K.banded_score_cands_plain, k1l_args, local=True)
    stage = local_stage(K, k1l_args, k1l["out"], extract_window)
    del k1l["out"]

    # traceback: genome-oriented read against its true window
    tw0 = t(true_w0, torch.int64)
    texts = extract_window(words, tw0, TW)
    tlens = t(np.minimum(n - true_w0, TW))
    tb_mm = np.where(is_rc[:, None], mm_rc, mm)
    k2_args = (t(pats), t(lens), texts, tlens, sc, W, t(tb_mm))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    groups = {"se": K.k2_group(B, sms), "all": K.k2_group(B * C, sms)}
    print(f"[kernels] K2 lanes per read: {groups['se']} at B={B}, "
          f"{groups['all']} at B*C={B * C} ({sms} SMs)", flush=True)
    k2 = check_kernel("banded_traceback", K.banded_traceback,
                      K.banded_traceback_plain, k2_args)
    # K2 at the SE shape under the other group sizes, beside the chosen one
    k2g = {}
    for g in K.K2_GROUPS:
        if g != groups["se"]:
            k2g[g] = check_kernel(f"banded_traceback group={g}",
                                  K.banded_traceback,
                                  K.banded_traceback_plain, k2_args,
                                  kernel_kw={"group": g})
            del k2g[g]["out"]
    # and at a batch too small to fill the card, under both group sizes:
    # where k2_group's choice of 4 lanes per read comes from
    small = tuple(x[:B_SMALL].contiguous() if torch.is_tensor(x) else x
                  for x in k2_args)
    k2s = {}
    for g in K.K2_GROUPS:
        k2s[g] = check_kernel(f"banded_traceback B={B_SMALL} group={g}",
                              K.banded_traceback, K.banded_traceback_plain,
                              small, kernel_kw={"group": g})
        del k2s[g]["out"]
    n_ops_sum = int(k2["out"][3].long().sum())
    small_steps = int(k2["out"][3][:B_SMALL].long().sum())
    print(f"[kernels] banded_traceback: mean n_ops={n_ops_sum / B:.2f} "
          f"mean nm={float(k2['out'][5].float().mean()):.3f}", flush=True)

    # K3 at the mate-rescue shapes: each mate against the window at its
    # locus (SEMI_GLOBAL, bowtie2 end-to-end scoring)
    k3 = check_kernel("banded_score", K.banded_score, K.banded_score_plain,
                      k2_args)
    # K3-LOCAL at the shapes the local path gave it before K1 took its
    # candidates: every (read, candidate slot) of K1's inputs, flattened;
    # K2 on the same rows is the --all traceback (align_batch_all)
    slot_rc = (np.arange(C) >= NCH)[None, :, None]
    flat_pats = t(np.where(slot_rc, rc[:, None], reads[:, None]).reshape(
        B * C, L))
    flat_mm = t(np.where(slot_rc, mm_rc[:, None], mm[:, None]).reshape(
        B * C, L))
    flat_w0 = t(w0.reshape(-1), torch.int64)
    flat = (flat_pats, t(np.full(B * C, L)),
            extract_window(words, flat_w0, TW), t(wlens.reshape(-1)))
    k3l = check_kernel("banded_score_local", K.banded_score,
                       K.banded_score_plain, (*flat, lsc, W, flat_mm),
                       local=True)
    k2a = check_kernel("banded_traceback (--all shape)", K.banded_traceback,
                       K.banded_traceback_plain, (*flat, sc, W, flat_mm))
    k2a_steps = int(k2a["out"][3].long().sum())
    del flat_pats, flat_mm, flat, k2a["out"]
    torch.cuda.empty_cache()
    # K2-LOCAL: every other read ends in 15 random bases, so its walk
    # stops at the clip
    tailed = pats.copy()
    tailed[::2, L - 15:] = rng.integers(0, 4, size=(B // 2, 15))
    k2l_args = (t(tailed), t(lens), texts, tlens, lsc, W, t(tb_mm))
    k2l = check_kernel("banded_traceback_local", K.banded_traceback,
                       K.banded_traceback_plain, k2l_args, local=True)
    k2l_steps = int(k2l["out"][3].long().sum())
    # K3's packed entry, the mapping path's rescue rescore: each mate
    # against the window at its locus read from the packed genome, with the
    # penalty plane, with the scalar mismatch (no plane) and LOCAL
    k3w_args = (t(pats), t(lens), words, tw0, tlens, sc, W, t(tb_mm))
    k3w = check_kernel("banded_score_windows", K.banded_score_windows,
                       K.banded_score_windows_plain, k3w_args)
    k3w_np = check_kernel("banded_score_windows (no plane)",
                          K.banded_score_windows,
                          K.banded_score_windows_plain,
                          (*k3w_args[:7], None))
    k3w_l = check_kernel("banded_score_windows local",
                         K.banded_score_windows,
                         K.banded_score_windows_plain,
                         (t(tailed), *k3w_args[1:5], lsc, W, t(tb_mm)),
                         local=True)
    k3_rows = int(np.minimum(lens, L).sum())
    # K2-WIDE at the full-matrix traceback's band T+M = 230: each read's
    # window of T = L+W-1 left-padded by M never-match symbols, as
    # traceback.batch_traceback_full builds it
    pad8 = torch.full((B, L), 8, dtype=torch.int32, device=dev)
    full_texts = torch.cat([pad8, texts], dim=1)
    full_tlens = tlens + L
    k2w = check_kernel("banded_traceback_wide", K.banded_traceback_wide,
                       K.banded_traceback_wide_plain,
                       (t(pats), t(lens), full_texts, full_tlens, sc, W_FULL,
                        t(tb_mm)))
    k2w_steps = int(k2w["out"][3].long().sum())
    k2wl = check_kernel("banded_traceback_wide_local",
                        K.banded_traceback_wide,
                        K.banded_traceback_wide_plain,
                        (t(tailed), t(lens), full_texts, full_tlens, lsc,
                         W_FULL, t(tb_mm)), local=True)
    k2wl_steps = int(k2wl["out"][3].long().sum())
    # K2-WIDE at a 512-base read's band T+M = 1054: its directions (276 KB
    # a read) take the global-scratch route
    nw, ml = 256, 512
    wl, tl = 2 * ml + W - 1, ml + W - 1
    require(K.wide_route(ml, wl) == "global",
            f"K2-WIDE at M={ml}, W={wl} does not take the global route")
    ws = rng.integers(MAX_DIST, n - tl - 2, size=nw)
    cut = rng.integers(20, ml - 20, size=nw)[:, None]
    j = np.arange(ml)[None, :]
    # every other read lacks one base of its window (a deletion)
    src = ws[:, None] + j + ((j >= cut) & (np.arange(nw) % 2 == 1)[:, None])
    wp = genome[src].astype(np.int32)
    wp = np.where(rng.random((nw, ml)) < 0.01, (wp + 1) % 4, wp)
    wt = genome[(ws - MAX_DIST)[:, None] + np.arange(tl)].astype(np.int32)
    w512 = (t(wp), t(np.full(nw, ml)),
            torch.cat([torch.full((nw, ml), 8, dtype=torch.int32,
                                  device=dev), t(wt)], dim=1),
            t(np.full(nw, tl + ml)), sc, wl,
            t(-rng.integers(2, 7, size=(nw, ml))))
    k2w512 = check_kernel(f"banded_traceback_wide W={wl} M={ml} (global "
                          f"route)", K.banded_traceback_wide,
                          K.banded_traceback_wide_plain, w512)
    k2w512_steps = int(k2w512["out"][3].long().sum())
    del k2w512["out"]
    # K2-WIDE at K2's own shape: what K2 would cost if K2-WIDE replaced it
    k2w31 = check_kernel("banded_traceback_wide W=31 (K2's shape)",
                         K.banded_traceback_wide,
                         K.banded_traceback_wide_plain, k2_args)
    del k2w31["out"]
    print(f"[kernels] K2-WIDE mean walk {k2w_steps / B:.2f} steps, "
          f"K2-WIDE-LOCAL {k2wl_steps / B:.2f}", flush=True)
    # K5 as bench.py's GCUPS leg runs it, then every flag off on a ragged
    # batch with a per-row mismatch plane
    k5 = {}
    for wk in (W, 17):
        ops5 = k5_operands(wk, G_K5, dev)
        k5[wk] = check_kernel(
            f"regtile_score_blocked W={wk}", K.regtile_score_blocked,
            K.regtile_score_blocked_plain, ops5,
            **k5_bench_flags(sc, wk))
        k5[wk]["packed_share"] = k5_packed_share(K, ops5,
                                                 k5_bench_flags(sc, wk))
        require(k5[wk]["packed_share"] == 1.0,
                f"K5 W={wk}: a pair of bench.py's operands left the packed "
                f"loop")
        del ops5, k5[wk]["out"]
        torch.cuda.empty_cache()
    g64 = 64
    lp, twp = (L + 7) // 8 * 8, (L + 7) // 8 * 8 + W
    ops64 = (t(rng.integers(0, 5, (g64, lp, 8, 128))),
             t(rng.integers(L // 2, L + 3, (g64, 1, 8, 128))),
             t(rng.integers(0, 4, (g64, twp, 8, 128))),
             t(rng.integers(0, twp + 1, (g64, 1, 8, 128))),
             t(-rng.integers(2, 7, (g64, lp, 8, 128))))
    k5r = check_kernel("regtile_score_blocked G=64 ragged",
                       K.regtile_score_blocked, K.regtile_score_blocked_plain,
                       ops64, scoring=sc, band=W, length=L, seq_f=False)
    k5r["packed_share"] = k5_packed_share(
        K, ops64, dict(scoring=sc, band=W, length=L, seq_f=False))
    ops_g = tuple(t(x) for x in guard_operands(rng, g64, L, W))
    kw_g = dict(scoring=sc, band=W, length=L)
    k5g = check_kernel("regtile_score_blocked G=64 ragged, guard refusals",
                       K.regtile_score_blocked, K.regtile_score_blocked_plain,
                       ops_g, **kw_g)
    k5g["packed_share"] = k5_packed_share(K, ops_g, kw_g)
    require(0.0 < k5g["packed_share"] < 1.0,
            "K5's guard case does not mix packed and int32 pairs")
    del k5r["out"], k5g["out"], ops64, ops_g
    # K4 at the mate-locate shapes: each mate in a window of maxins + band
    # = 531 bases that holds it; 64 empty patterns, 64 short windows
    wstart = np.clip(starts - rng.integers(0, RW - L, size=B), 0, n - RW)
    mplens = np.full(B, L)
    mplens[:64] = 0
    mtlens = np.full(B, RW)
    mtlens[64:128] = rng.integers(0, RW, size=64)
    k4_args = (t(pats), t(mplens),
               extract_window(words, t(wstart, torch.int64), RW),
               t(mtlens))
    k4 = check_kernel("myers_semiglobal", K.myers_semiglobal,
                      K.myers_semiglobal_plain, k4_args)
    # its packed entry, the mapping path's: the same mates and windows, the
    # text read from the packed genome
    k4w_args = (t(pats), t(mplens), words, t(wstart, torch.int64),
                t(mtlens), RW)
    k4w = check_kernel("myers_semiglobal_windows",
                       K.myers_semiglobal_windows,
                       K.myers_semiglobal_windows_plain, k4w_args)
    k4_steps = int(np.minimum(mtlens, RW).sum())   # the loop's own length
    k4x = k4_widths(K, genome, words, rng, starts, k4_args, t)
    k4_found = float((k4["out"][0][128:] <= 3).float().mean())
    print(f"[kernels] K2-LOCAL mean walk {k2l_steps / B:.2f} steps; K4 "
          f"share of mates found at distance <= 3: {k4_found:.4f}",
          flush=True)

    # least time for the same work: the larger of integer instructions over
    # the card's issue ceiling and bytes (inputs read once, outputs written
    # once) over HBM
    rate = issue_per_s()
    k1_cells = B * C * L * W
    k1_bytes = (4 * B * L * 4 + B * 4 + B * C * (8 + 4)
                + B * C * ((TW + 15) // 16 + 1) * 4 + 2 * B * C * 4)
    k1_ops = K1_OPS_PER_CELL_PACKED * k1_cells
    k1_ops_int32 = K1_OPS_PER_CELL * k1_cells
    MAXS = (L + W + 7) // 8 * 8
    k2_cells = B * L * W
    k2_ops = K2_OPS_PER_CELL * k2_cells + K2_OPS_PER_STEP * n_ops_sum
    k2_bytes = (2 * B * L * 4 + B * TW * 4 + 2 * B * 4 + 7 * B * 4
                + B * MAXS * 4)
    k2l_ops = K2L_OPS_PER_CELL * k2_cells + K2L_OPS_PER_STEP * k2l_steps
    k3_ops = K3_OPS_PER_CELL * k2_cells
    k3_bytes = 2 * B * L * 4 + B * TW * 4 + 4 * B * 4
    k3l_ops = K3L_OPS_PER_CELL * B * C * L * W
    k3l_bytes = C * k3_bytes
    k1l_ops = K1L_OPS_PER_CELL_PACKED * k1_cells
    k4_word_steps = k4_steps * ((L + 31) // 32)
    k4_ops = K4_OPS_PER_WORD_STEP * k4_word_steps + K4_OPS_PER_STEP * k4_steps
    k4_bytes = B * L * 4 + B * RW * 4 + 4 * B * 4
    k4w_ops = (K4_OPS_PER_WORD_STEP * k4_word_steps
               + K4W_OPS_PER_STEP * k4_steps)
    # patterns, lengths, starts and outputs, and the words of each window
    k4w_bytes = B * L * 4 + B * (3 * 4 + 8) + B * (RW // 16 + 2) * 4
    k3w_ops = K3_OPS_PER_CELL * k3_rows * W
    k3w_bytes = 2 * B * L * 4 + B * (4 * 4 + 8) + B * (TW // 16 + 2) * 4
    k2a_cells = B * C * L * W
    k2a_ops = K2_OPS_PER_CELL * k2a_cells + K2_OPS_PER_STEP * k2a_steps
    k2a_bytes = C * k2_bytes
    MAXS_F = (L + W_FULL + 7) // 8 * 8
    TW_F = L + W_FULL - 1
    k2w_cells = B * L * W_FULL
    k2w_ops = K2_OPS_PER_CELL * k2w_cells + K2_OPS_PER_STEP * k2w_steps
    k2wl_ops = K2L_OPS_PER_CELL * k2w_cells + K2L_OPS_PER_STEP * k2wl_steps
    k2w_bytes = (2 * B * L * 4 + B * TW_F * 4 + 2 * B * 4 + 7 * B * 4
                 + B * MAXS_F * 4)
    k2w512_ops = (K2_OPS_PER_CELL * nw * ml * wl
                  + K2_OPS_PER_STEP * k2w512_steps)
    k2w512_bytes = nw * (2 * ml * 4 + (ml + wl - 1) * 4 + 9 * 4
                         + (ml + wl + 7) // 8 * 8 * 4)
    n5 = G_K5 * 1024

    def bound(ops, nbytes):
        t_ops, t_bytes = ops / rate, nbytes / HBM_BYTES_PER_S
        return (1e3 * max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes")

    def k4_cost(mw, steps, form):
        # K4 at M = mw ("n5": M = L over 5 symbols) on B_K4_WIDE mates
        m = L if mw == "n5" else mw
        per_step = K4W_OPS_PER_STEP if form == "windows" else K4_OPS_PER_STEP
        nbytes = B_K4_WIDE * (m * 4 + 24 + (RW // 16 + 2) * 4 if form ==
                              "windows" else m * 4 + RW * 4 + 16)
        return (K4_OPS_PER_WORD_STEP * steps * ((m + 31) // 32)
                + per_step * steps, nbytes)

    band21 = band_checks(K, genome, words, rng, dev, k1_args, true_w0,
                         k2_args, t)

    print(f"[kernels] issue ceiling {rate:.4g} op/s; K1 {k1_ops:.4g} ops "
          f"packed ({k1_ops_int32:.4g} int32) "
          f"{k1_bytes:.4g} B; K2 {k2_ops:.4g} ops {k2_bytes:.4g} B; "
          f"K2-LOCAL {k2l_ops:.4g} ops; K3 {k3_ops:.4g} ops {k3_bytes:.4g} B; "
          f"K3-LOCAL {k3l_ops:.4g} ops {k3l_bytes:.4g} B; K4 {k4_ops:.4g} "
          f"ops ({k4_word_steps:.4g} word-steps) {k4_bytes:.4g} B",
          flush=True)
    base = "nvbio_tpu/align/pallas_kernels.py"
    csrc = "nvbio_tpu_torch/csrc"
    gs, ga = groups["se"], groups["all"]
    rows = [
        ("banded_score_cands", "banded_score_cands.cu", 963, k1, k1_ops,
         k1_bytes, f"B={B} C={C} L={L} W={W}",
         f"banded_score_cands_kernel<{W},1,0>"),
        ("banded_score_cands_local", "banded_score_cands.cu", 133, k1l,
         k1l_ops, k1_bytes, f"B={B} C={C} L={L} W={W} local",
         f"banded_score_cands_kernel<{W},1,1>"),
        ("banded_traceback", "banded_traceback.cu", 568, k2, k2_ops,
         k2_bytes, f"B={B} L={L} W={W} group={gs}",
         f"banded_traceback_kernel<{W},{gs},0>"),
        ("banded_traceback_local", "banded_traceback.cu", 568, k2l,
         k2l_ops, k2_bytes, f"B={B} L={L} W={W} local group={gs}",
         f"banded_traceback_kernel<{W},{gs},1>"),
        ("banded_score_windows", "banded_score.cu", 133, k3w, k3w_ops,
         k3w_bytes, f"B={B} M={L} W={W} (rescue rescore, packed windows)",
         f"banded_score_windows_kernel<{W},0>"),
        ("myers_semiglobal_windows", "myers_semiglobal.cu", 1132, k4w,
         k4w_ops, k4w_bytes, f"B={B} M={L} T={RW} (mate locate, packed "
         f"windows)", "myers_regs_windows_kernel<4>"),
        ("banded_traceback_wide", "banded_traceback_wide.cu", 568, k2w,
         k2w_ops, k2w_bytes, f"B={B} M={L} W={W_FULL} (T+M)",
         f"banded_traceback_wide_kernel<8,{W_FULL},0,1>"),
        ("banded_traceback_wide_local", "banded_traceback_wide.cu", 568,
         k2wl, k2wl_ops, k2w_bytes, f"B={B} M={L} W={W_FULL} (T+M) local",
         f"banded_traceback_wide_kernel<8,{W_FULL},1,1>"),
        ("regtile_score_blocked", "regtile_score_blocked.cu", 839, k5[W],
         *k5_cost(W, n5, **K5_BENCH_PLANES), f"G={G_K5} L={L} W={W} seq_f "
         f"full_text uniform_plen",
         f"regtile_score_blocked_kernel<{W},1,1,1>"),
    ]
    rows += band21["rows"]
    out = []
    for name, src, line, res, ops, nbytes, shape, inst in rows:
        bms, by = bound(ops, nbytes)
        out.append(dict(
            name=name, route="cuda", source=f"{csrc}/{src}",
            replaces=f"{base}:{line}", equal=res["equal"],
            max_abs_err=res["max_abs_err"], ms=res["ms"],
            ms_queued=res["ms_queued"], plain_ms=res["plain_ms"],
            bound_ms=bms, bound_by=by,
            library_ms=None, shape=shape, instantiation=inst,
            registers=regs[inst][0]))
    out[0]["bound_int32_ms"] = bound(k1_ops_int32, k1_bytes)[0]
    out[1]["bound_int32_ms"] = bound(k3l_ops, k1_bytes)[0]
    k5e = next(e for e in out if e["name"] == "regtile_score_blocked")
    k5e["bound_int32_ms"] = bound(*k5_cost(W, n5, **K5_BENCH_PLANES,
                                           per_cell=K1_OPS_PER_CELL))[0]
    k5e["packed_share"] = k5[W]["packed_share"]
    # measured beside the nine entries: K5 at W=17 and on a ragged batch,
    # K2 at the --all shape, K2 at the other group size, K2-WIDE at K2's
    # shape and at W=1054 (global route), the flat K3-LOCAL at its old
    # shape and the old local stage around it
    extra = []
    s_ops = K2_OPS_PER_CELL * B_SMALL * L * W + K2_OPS_PER_STEP * small_steps
    for name, res, (ops, nbytes), shape, inst in [(
            "banded_traceback", k2g[g], (k2_ops, k2_bytes),
            f"B={B} L={L} W={W} group={g}",
            f"banded_traceback_kernel<{W},{g},0>") for g in k2g] + [(
            "banded_traceback", k2s[g], (s_ops, k2_bytes * B_SMALL // B),
            f"B={B_SMALL} L={L} W={W} group={g}",
            f"banded_traceback_kernel<{W},{g},0>") for g in k2s] + [
            ("regtile_score_blocked", k5[17],
             k5_cost(17, n5, **K5_BENCH_PLANES),
             f"G={G_K5} L={L} W=17 seq_f full_text uniform_plen",
             "regtile_score_blocked_kernel<17,1,1,1>"),
            ("regtile_score_blocked", k5r,
             k5_cost(W, g64 * 1024, uniform_plen=False, full_text=False),
             f"G={g64} L={L} W={W} no flags, ragged",
             f"regtile_score_blocked_kernel<{W},0,0,0>"),
            ("regtile_score_blocked", k5g,
             k5_cost(W, g64 * 1024, uniform_plen=False, full_text=False),
             f"G={g64} L={L} W={W} seq_f, ragged, guard refusals",
             f"regtile_score_blocked_kernel<{W},1,0,0>"),
            ("banded_traceback", k2a, (k2a_ops, k2a_bytes),
             f"B*C={B * C} L={L} W={W} (--all) group={ga}",
             f"banded_traceback_kernel<{W},{ga},0>"),
            ("banded_traceback_wide", k2w31, (k2_ops, k2_bytes),
             f"B={B} L={L} W={W} (K2's shape; K2 {k2['ms']:.3f} ms)",
             "banded_traceback_wide_kernel<8,0,0,1>"),
            ("banded_traceback_wide", k2w512, (k2w512_ops, k2w512_bytes),
             f"B={nw} M={ml} W={wl} (T+M; global route)",
             f"banded_traceback_wide_kernel<36,{wl},0,0>"),
            ("banded_score_local", k3l, (k3l_ops, k3l_bytes),
             f"B*C={B * C} M={L} W={W} local (flat; the local path's "
             f"candidates before K1 took them)",
             f"banded_score_kernel<{W},1>"),
            ("local stage, flat route", stage, (k3l_ops, k3l_bytes),
             f"B={B} C={C}: torch.where + extract_window + K3-LOCAL",
             f"banded_score_kernel<{W},1>"),
            ("banded_score", k3, (k3_ops, k3_bytes),
             f"B={B} M={L} W={W} (contract form, extracted windows)",
             f"banded_score_kernel<{W},0>"),
            ("myers_semiglobal", k4, (k4_ops, k4_bytes),
             f"B={B} M={L} T={RW} (contract form, extracted windows)",
             "myers_regs_kernel<4>"),
            ("banded_score_windows", k3w_np, (k3w_ops, k3w_bytes - B * L * 4),
             f"B={B} M={L} W={W} (no plane: the scalar mismatch)",
             f"banded_score_windows_kernel<{W},0>"),
            ("banded_score_windows", k3w_l,
             (K3L_OPS_PER_CELL * k3_rows * W, k3w_bytes),
             f"B={B} M={L} W={W} local", f"banded_score_windows_kernel<{W},1>"),
    ] + [(f"myers_semiglobal{'_windows' if form == 'windows' else ''}", res,
          k4_cost(mw, steps, form),
          f"B={B_K4_WIDE} M={L if mw == 'n5' else mw} T={RW}"
          + (" n_symbols=5 (generic)" if mw == "n5" else ""), inst)
         for (mw, form), (res, steps, inst) in k4x.items()
         ] + band21["extra"]:
        bms, by = bound(ops, nbytes)
        extra.append(dict(name=name, equal=res["equal"],
                          max_abs_err=res["max_abs_err"], ms=res["ms"],
                          ms_queued=res["ms_queued"],
                          plain_ms=res["plain_ms"], bound_ms=bms,
                          bound_by=by, shape=shape, instantiation=inst,
                          registers=regs[inst][0],
                          **{k: res[k] for k in ("peak_bytes",
                                                 "cands_peak_bytes",
                                                 "packed_share")
                             if k in res}))
    k5o, k5b = k5_cost(W, n5, **K5_BENCH_PLANES)
    k5o17, k5b17 = k5_cost(17, n5, **K5_BENCH_PLANES)
    print(f"[kernels] K2-WIDE {k2w_ops:.4g} ops {k2w_bytes:.4g} B "
          f"(directions in shared memory); K2-WIDE-LOCAL "
          f"{k2wl_ops:.4g} ops; K5 W={W} {k5o:.4g} ops {k5b:.4g} B, W=17 "
          f"{k5o17:.4g} ops {k5b17:.4g} B; K2 at --all {k2a_ops:.4g} ops "
          f"{k2a_bytes:.4g} B", flush=True)
    for e in out + extra:
        print(f"[kernels] {e['name']} {e['shape']}: {e['ms']:.3f} ms "
              f"(queued {e['ms_queued']:.3f}), bound "
              f"{e['bound_ms']:.3f} ms ({e['bound_by']}), "
              f"{e['instantiation']} {e['registers']} registers", flush=True)
    print(f"[kernels] K1 bound {out[0]['bound_ms']:.3f} ms packed, "
          f"{out[0]['bound_int32_ms']:.3f} ms int32; K1-LOCAL "
          f"{out[1]['bound_ms']:.3f} ms packed, "
          f"{out[1]['bound_int32_ms']:.3f} ms int32", flush=True)
    # K5: the larger of its packed instructions and its bytes, and the
    # share of that bound it reached (single call and queued)
    k5_17 = next(e for e in extra if e["instantiation"]
                 == "regtile_score_blocked_kernel<17,1,1,1>")
    for wk, e, i32 in ((W, k5e, k5e["bound_int32_ms"]),
                       (17, k5_17, bound(*k5_cost(
                           17, n5, **K5_BENCH_PLANES,
                           per_cell=K1_OPS_PER_CELL))[0])):
        print(f"[kernels] K5 W={wk} bound {e['bound_ms']:.3f} ms "
              f"({e['bound_by']}; int32 {i32:.3f} ms): "
              f"{100 * e['bound_ms'] / e['ms']:.1f}% reached in "
              f"{e['ms']:.3f} ms, {100 * e['bound_ms'] / e['ms_queued']:.1f}%"
              f" queued ({e['ms_queued']:.3f} ms); pairs on the packed loop "
              f"{e['packed_share']:.4f}", flush=True)
    return out, extra


def k5_packed_share(K, ops, kw) -> float:
    """The share of K5's pairs of alignments that its packed loop scored
    (one more launch with a counter), required to equal what
    ``kernels.k5_packed_pairs`` admits."""
    cnt = torch.zeros(1, dtype=torch.int32, device=ops[0].device)
    K.regtile_score_blocked(*ops, packed_count=cnt, **kw)
    guard = {k: v for k, v in kw.items() if k not in ("seq_f", "unroll")}
    admitted = int(K.k5_packed_pairs(*ops, **guard).sum())
    n_pairs = ops[0].shape[0] * 512
    require(int(cnt) == admitted,
            f"K5's packed loop took {int(cnt)} pairs, its guard admits "
            f"{admitted}")
    print(f"[kernels] K5 G={ops[0].shape[0]} W={kw['band']}: pairs on the "
          f"packed loop {int(cnt)} of {n_pairs}", flush=True)
    return int(cnt) / n_pairs


def k4_widths(K, genome, words, rng, starts, k4_args, t):
    """K4 at 5, 8 and 16 words (M = 150, 256, 512) on B_K4_WIDE mates in
    windows of RW that hold them, both entries, and the contract form over
    a 5-symbol alphabet (the generic instantiation). Returns {(M, form):
    (check, text steps run, instantiation)}."""
    from nvbio_tpu_torch.packed import extract_window

    n = len(genome)
    nb = B_K4_WIDE
    out = {}
    for mw in K4_WIDTHS:
        st = np.clip(starts[:nb], 0, n - mw - 1)
        ws = np.clip(st - rng.integers(0, RW - mw, size=nb), 0, n - RW)
        wp = genome[st[:, None] + np.arange(mw)].astype(np.int32)
        wp = np.where(rng.random(wp.shape) < 0.02, (wp + 1) % 4, wp)
        plens = np.full(nb, mw)
        plens[:8] = rng.integers(0, mw, size=8)
        tlens = np.full(nb, RW)
        tlens[8:16] = rng.integers(0, RW, size=8)
        wst = t(ws, torch.int64)
        args = (t(wp), t(plens), extract_window(words, wst, RW), t(tlens))
        steps = int(np.minimum(tlens, RW).sum())
        nw = (mw + 31) // 32
        out[(mw, "rows")] = (check_kernel(
            f"myers_semiglobal M={mw} B={nb}", K.myers_semiglobal,
            K.myers_semiglobal_plain, args, time_plain=False), steps,
            f"myers_regs_kernel<{nw}>")
        out[(mw, "windows")] = (check_kernel(
            f"myers_semiglobal_windows M={mw} B={nb}",
            K.myers_semiglobal_windows, K.myers_semiglobal_windows_plain,
            (args[0], args[1], words, wst, args[3], RW), time_plain=False),
            steps, f"myers_regs_windows_kernel<{nw}>")
    # 5 symbols: code 4 (N) now matches itself, in patterns and texts
    pats, plens, texts, tlens = (x[:nb].contiguous() for x in k4_args)
    pats = torch.where(torch.rand(pats.shape, device=pats.device) < 0.05,
                       4, pats).to(torch.int32)
    texts = torch.where(torch.rand(texts.shape, device=texts.device) < 0.05,
                        4, texts).to(torch.int32)
    out[("n5", "rows")] = (check_kernel(
        f"myers_semiglobal n_symbols=5 B={nb}", K.myers_semiglobal,
        K.myers_semiglobal_plain, (pats, plens, texts, tlens),
        time_plain=False, n_symbols=5), int(tlens.clamp(max=RW).long().sum()),
        "myers_generic_kernel<0>")
    for v in out.values():
        del v[0]["out"]
    return out


def band_checks(K, genome, words, rng, dev, k1_args, true_w0, k2_args, t):
    """K1, K2, K3 (both entries) and K5 at band W2 = 21 (max_dist 10, a
    library built beside the precompiled ones) against their plain
    versions: K1 on K1's reads and candidates with windows moved to the
    band's start, K2 and K3 on each read's window at its truth, K5 as the
    GCUPS leg runs it on G_K5_2 blocks. Returns {"rows": kernel rows of
    the single-end band-21 path (K1, K2), "extra": the others}, as
    phase_kernels lays them out, with their costs."""
    from nvbio_tpu_torch.packed import extract_window

    n = len(genome)
    sc = k1_args[6]
    TW2 = L + W2 - 1
    shift = MAX_DIST - MAX_DIST_2
    reads, rc, lens, w0, wlens, _, _, _, nch, mm, mm_rc = k1_args
    C = w0.shape[1]
    w0_2 = (w0 + shift).clamp(max=n - 1)
    wl2 = (n - w0_2).clamp(max=TW2).to(torch.int32)
    k1 = check_kernel(f"banded_score_cands W={W2}", K.banded_score_cands,
                      K.banded_score_cands_plain,
                      (reads, rc, lens, w0_2, wl2, words, sc, W2, nch, mm,
                       mm_rc))
    tw0 = t(np.minimum(true_w0 + shift, n - 1), torch.int64)
    texts = extract_window(words, tw0, TW2)
    tl = (n - tw0).clamp(max=TW2).to(torch.int32)
    pats, plens, mmv = k2_args[0], k2_args[1], k2_args[6]
    k2 = check_kernel(f"banded_traceback W={W2}", K.banded_traceback,
                      K.banded_traceback_plain,
                      (pats, plens, texts, tl, sc, W2, mmv))
    k2_steps = int(k2["out"][3].long().sum())
    del k1["out"], k2["out"]
    k3 = check_kernel(f"banded_score W={W2}", K.banded_score,
                      K.banded_score_plain,
                      (pats, plens, texts, tl, sc, W2, mmv))
    k3w = check_kernel(f"banded_score_windows W={W2}",
                       K.banded_score_windows, K.banded_score_windows_plain,
                       (pats, plens, words, tw0, tl, sc, W2, mmv))
    k5 = check_kernel(f"regtile_score_blocked W={W2} G={G_K5_2}",
                      K.regtile_score_blocked, K.regtile_score_blocked_plain,
                      k5_operands(W2, G_K5_2, dev),
                      **k5_bench_flags(sc, W2))
    for r in (k3, k3w, k5):
        del r["out"]
    nr = reads.shape[0]
    cells = nr * L * W2
    k1_bytes = (4 * nr * L * 4 + nr * 4 + nr * C * (8 + 4)
                + nr * C * ((TW2 + 15) // 16 + 1) * 4 + 2 * nr * C * 4)
    maxs = (L + W2 + 7) // 8 * 8
    k2_bytes = (2 * nr * L * 4 + nr * TW2 * 4 + 2 * nr * 4 + 7 * nr * 4
                + nr * maxs * 4)
    k3_bytes = 2 * nr * L * 4 + nr * TW2 * 4 + 4 * nr * 4
    k3w_bytes = 2 * nr * L * 4 + nr * (4 * 4 + 8) + nr * (TW2 // 16 + 2) * 4
    n5 = G_K5_2 * 1024
    src = "nvbio_tpu_torch/csrc"
    return dict(rows=[
        ("banded_score_cands_w21", "banded_score_cands.cu", 963, k1,
         K1_OPS_PER_CELL_PACKED * cells * C, k1_bytes,
         f"B={nr} C={C} L={L} W={W2} (max_dist {MAX_DIST_2})",
         f"banded_score_cands_kernel<{W2},1,0>"),
        ("banded_traceback_w21", "banded_traceback.cu", 568, k2,
         K2_OPS_PER_CELL * cells + K2_OPS_PER_STEP * k2_steps, k2_bytes,
         f"B={nr} L={L} W={W2} (max_dist {MAX_DIST_2}) group=1",
         f"banded_traceback_kernel<{W2},1,0>")], extra=[
        ("banded_score", k3, (K3_OPS_PER_CELL * cells, k3_bytes),
         f"B={nr} M={L} W={W2} (contract form; {src}/banded_score.cu)",
         f"banded_score_kernel<{W2},0>"),
        ("banded_score_windows", k3w, (K3_OPS_PER_CELL * cells, k3w_bytes),
         f"B={nr} M={L} W={W2} (packed windows)",
         f"banded_score_windows_kernel<{W2},0>"),
        ("regtile_score_blocked", k5,
         k5_cost(W2, n5, **K5_BENCH_PLANES),
         f"G={G_K5_2} L={L} W={W2} seq_f full_text uniform_plen",
         f"regtile_score_blocked_kernel<{W2},1,1,1>")])


def local_stage(K, args, want, extract_window):
    """The local candidate stage as read_candidates built it before K1
    took it: (B*C, L) patterns and penalties by torch.where, (B*C, L+W-1)
    windows by extract_window, the flat K3-LOCAL. Its outputs against K1's
    LOCAL ones (``want``), its time and the peak device memory of it and
    of K1-LOCAL above what was allocated before."""
    reads, rc, lens, w0, wlens, words, sc, band, nch, mm, mm_rc = args
    C = w0.shape[1]
    TW = L + band - 1

    def flat():
        flip = (torch.arange(C, device=reads.device) >= nch)[None, :, None]
        pats = torch.where(flip, rc[:, None, :], reads[:, None, :])
        pens = torch.where(flip, mm_rc[:, None, :], mm[:, None, :])
        win = extract_window(words, w0.reshape(B * C), TW)
        s, k = K.banded_score(pats.reshape(B * C, L),
                              lens[:, None].expand(B, C).reshape(B * C),
                              win, wlens.reshape(B * C), sc, band,
                              pens.reshape(B * C, L), local=True)
        return s.reshape(B, C), k.reshape(B, C)

    def peak(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base, got

    flat_peak, got = peak(flat)
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    err = max(int((a.long() - b.long()).abs().max())
              for a, b in zip(got, want))
    del got
    cands_peak, _ = peak(lambda: K.banded_score_cands(*args, local=True))
    ms, ms_queued = cuda_ms(flat), cuda_ms_queued(flat)
    print(f"[kernels] local stage, flat route: equal to K1-LOCAL={equal} "
          f"ms={ms:.3f} queued {ms_queued:.3f}; peak device memory "
          f"{flat_peak / 1e6:.1f} MB (K1-LOCAL {cands_peak / 1e6:.1f} MB)",
          flush=True)
    require(equal, "the flat local stage differs from K1-LOCAL")
    return dict(equal=equal, max_abs_err=err, ms=ms, ms_queued=ms_queued,
                plain_ms=None, peak_bytes=flat_peak,
                cands_peak_bytes=cands_peak)


def k5_operands(wk: int, g: int, dev):
    """bench.py's GCUPS operands on g blocks (``tools.k5_operands``)."""
    from nvbio_tpu_torch.bowtie.params import MapParams
    from nvbio_tpu_torch.tools.k5_operands import bench_operands

    return bench_operands(wk, dev, MapParams().scoring.mismatch, G=g,
                          length=L)


# the length planes bench.py's flags leave unread (k5_cost)
K5_BENCH_PLANES = dict(uniform_plen=True, full_text=True)


def k5_cost(wk: int, n: int, *, uniform_plen: bool, full_text: bool,
            per_cell: int = K1_OPS_PER_CELL_PACKED):
    """(operations, bytes) of K5 on n alignments at band wk: the rows the
    function reads (L of patterns and penalties, L+W-1 of texts), the plen
    plane unless uniform_plen, the tlen plane unless full_text, and its two
    outputs."""
    planes = 2 + (not uniform_plen) + (not full_text)
    return (per_cell * n * L * wk, n * (2 * L + L + wk - 1) * 4
            + planes * n * 4)


def k5_bench_flags(scoring, wk: int) -> dict:
    """bench.py's regtile_score_blocked keywords (bench.py:446-450, 466-467):
    unroll 10 at the production band, 4 at W=17."""
    return dict(scoring=scoring, band=wk, length=L, seq_f=True,
                full_text=True, uniform_plen=True,
                unroll=10 if wk == W else 4)


def check_kernel(name, kernel, plain, args, time_plain=True, kernel_kw=None,
                 **kw):
    """One kernel against its plain version on the same inputs (every
    output bit for bit), then both timed: the kernel by ``cuda_ms`` and
    ``cuda_ms_queued``, the plain version on its comparison call, with CUDA
    events (not at all with ``time_plain=False``: plain_ms None); fails
    the run on a difference. ``kernel_kw`` goes to the kernel's wrapper
    only."""
    kkw = {**kw, **(kernel_kw or {})}
    got = kernel(*args, **kkw)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    want = plain(*args, **kw)
    b.record()
    torch.cuda.synchronize()
    plain_ms = a.elapsed_time(b) if time_plain else None
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    err = max(int((a.long() - b.long()).abs().max()) for a, b in
              zip(got, want))
    del want
    ms = cuda_ms(lambda: kernel(*args, **kkw))
    ms_queued = cuda_ms_queued(lambda: kernel(*args, **kkw))
    print(f"[kernels] {name}: equal={equal} max_abs_err={err} ms={ms:.3f} "
          f"queued {ms_queued:.3f} plain_ms={plain_ms}", flush=True)
    require(equal, f"{name} differs from its plain version")
    return dict(equal=equal, max_abs_err=err, ms=ms, ms_queued=ms_queued,
                plain_ms=plain_ms, out=got)


def read_batch(genome, seed):
    from nvbio_tpu_torch.io.fastq import ReadBatch
    from nvbio_tpu_torch.utils.simgenome import sample_reads

    reads, starts, is_rc = sample_reads(genome, B, L, seed=seed,
                                        subst_rate=0.01)
    rng = np.random.default_rng(seed + 1)
    quals = rng.integers(20, 41, size=(B, L)).astype(np.uint8)
    names = [f"r{seed}_{i}" for i in range(B)]
    batch = ReadBatch(names, reads.astype(np.uint8), quals,
                      np.full(B, L, np.int32))
    return batch, starts, is_rc


SE_LAUNCHES = {"banded_score_cands": 2, "banded_traceback": 1}


def phase_main_path(genome, ref, index, params, card, label="main",
                    n_batches=N_BATCHES, seed=SEED + 100, records=None,
                    per_batch=SE_LAUNCHES):
    """``n_batches`` batches of B single-end reads through dispatch +
    format_batch: launch counts (``per_batch``: K1 x2 with the reseed pass,
    K2 x1 a batch) and sensitivity. The SAM records are appended to
    ``records`` where it is given."""
    from nvbio_tpu_torch.bowtie.pipeline import ReadMapper

    t0 = time.time()
    mapper = ReadMapper.build(ref, params, index=index, device="cuda")
    torch.cuda.synchronize()
    print(f"[{label}] mapper on cuda in {time.time() - t0:.2f} s "
          f"(max_dist {params.max_dist}, band {params.band})", flush=True)
    batches = [read_batch(genome, seed + i) for i in range(n_batches)]

    out, t_dev, t_fmt, wall, launches = run_batches(
        mapper.dispatch, mapper.format_batch, [(b,) for b, _, _ in batches])
    n_reads = n_mapped = n_ok = 0
    for recs, (_, starts, is_rc) in zip(out, batches):
        require(len(recs) == B, f"{len(recs)} records for {B} reads")
        for rec, s, rc in zip(recs, starts.tolist(), is_rc.tolist()):
            n_reads += 1
            if rec.flag & 0x4:
                continue
            n_mapped += 1
            if bool(rec.flag & 0x10) == rc and \
                    abs(rec.pos - 1 - s) <= 2 * params.max_dist:
                n_ok += 1
    if records is not None:
        records.extend(r for recs in out for r in recs)
    k1_launches = launches["banded_score_cands"]
    k2_launches = launches["banded_traceback"]
    sens = n_ok / n_reads
    print(f"[{label}] {n_reads} reads in {wall:.3f} s = {n_reads / wall:.1f} "
          f"reads/s; per batch dispatch+sync s: "
          f"{', '.join(f'{x:.3f}' for x in t_dev)}; format_batch s: "
          f"{', '.join(f'{x:.3f}' for x in t_fmt)}; mapped "
          f"{n_mapped / n_reads:.5f}; sensitivity {sens:.5f}; launches "
          f"banded_score_cands={k1_launches} banded_traceback={k2_launches}"
          f"; card {card}", flush=True)
    require_launches(label, launches, per_batch, n_batches)
    require(sens >= 0.95, f"{label} sensitivity {sens:.4f} < 0.95")
    stats = dict(reads=n_reads, seconds=wall, reads_per_s=n_reads / wall,
                 mapped=n_mapped / n_reads, sensitivity=sens,
                 dispatch_s=sum(t_dev), format_s=sum(t_fmt))
    return mapper, batches[0][0], launches, stats


def pair_batches(genome, seed, rl=L):
    """B FR pairs of rl bp (fragments 200-500, 1% substitutions); in 5% of
    them mate 2 also carries a substitution at 9, 24, 39, ...: one in the
    12-base q-gram key of every 22-mer seed on either strand, so only mate
    rescue can place it. Returns the two batches, each mate's truth starts
    and strands, and the seedless mask."""
    from nvbio_tpu_torch.io.fastq import ReadBatch
    from nvbio_tpu_torch.utils.simgenome import sample_pairs

    r1, r2, s1, s2, rc1, rc2 = sample_pairs(genome, B, rl, 200, MAXINS,
                                            seed=seed, subst_rate=0.01)
    rng = np.random.default_rng(seed + 1)
    seedless = rng.random(B) < 0.05
    cut = np.ix_(seedless, np.arange(9, rl, 15))
    r2[cut] = (r2[cut] + 1) % 4
    names = [f"p{seed}_{i}" for i in range(B)]
    batches = [ReadBatch(names, r.astype(np.uint8),
                         rng.integers(20, 41, size=(B, rl)).astype(np.uint8),
                         np.full(B, rl, np.int32)) for r in (r1, r2)]
    return batches, (s1, s2), (rc1, rc2), seedless


def local_batch(genome, seed):
    """B reads of L bp with 1% substitutions; in a third of them the
    genome-right 15 bases are random (replaced before any reverse
    complement, so POS stays the window start on both strands)."""
    from nvbio_tpu_torch.io.fastq import ReadBatch
    from nvbio_tpu_torch.utils.simgenome import sample_reads

    reads, starts, _ = sample_reads(genome, B, L, seed=seed, subst_rate=0.01,
                                    rc_frac=0.0)
    rng = np.random.default_rng(seed + 1)
    tailed = np.arange(B) % 3 == 0
    reads[tailed, L - 15:] = rng.integers(0, 4, size=(int(tailed.sum()), 15))
    is_rc = rng.random(B) < 0.5
    reads = np.where(is_rc[:, None], (3 - reads)[:, ::-1], reads)
    quals = rng.integers(20, 41, size=(B, L)).astype(np.uint8)
    batch = ReadBatch([f"l{seed}_{i}" for i in range(B)],
                      reads.astype(np.uint8), quals, np.full(B, L, np.int32))
    return batch, starts, is_rc, tailed


def wrappers():
    from nvbio_tpu_torch.align import kernels as K

    return (K.banded_score_cands, K.banded_traceback, K.banded_score,
            K.myers_semiglobal, K.banded_traceback_wide,
            K.regtile_score_blocked, K.banded_score_windows,
            K.myers_semiglobal_windows)


def reset_launches():
    for fn in wrappers():
        fn.launches = 0


def read_launches() -> dict:
    return {fn.__name__: fn.launches for fn in wrappers()}


def run_batches(dispatch, fmt, inputs):
    """Map each batch: ``dispatch(*args)`` then a synchronize, and
    ``fmt(*args, res)``, timed apart. The launch counters are set to 0 just
    before the first batch and read just after the last. Returns (outputs,
    dispatch + sync s per batch, format s per batch, wall s, launches)."""
    reset_launches()
    t_dev, t_fmt, outs = [], [], []
    t_all = time.time()
    for args in inputs:
        t0 = time.time()
        res = dispatch(*args)
        torch.cuda.synchronize()
        t1 = time.time()
        outs.append(fmt(*args, res))
        t_dev.append(t1 - t0)
        t_fmt.append(time.time() - t1)
    wall = time.time() - t_all
    return outs, t_dev, t_fmt, wall, read_launches()


def require_launches(path, got, per_batch, n_batches):
    """Each wrapper's launches in a path's run: ``per_batch`` times the
    batches for the ones named, none for the others."""
    for name in got:
        want = per_batch.get(name, 0) * n_batches
        require(got[name] == want, f"{path}: {name} launched {got[name]} "
                                   f"times, expected {want}")


def placed(rec, start, rc, max_dist) -> bool:
    return (not rec.flag & 0x4 and bool(rec.flag & 0x10) == bool(rc)
            and abs(rec.pos - 1 - int(start)) <= 2 * max_dist)


# a paired-end batch's kernels: K1 per mate, the rescue (K4 and K3 through
# their packed-window entries, one per mate each), K2 per mate
PE_LAUNCHES = {"banded_score_cands": 2, "banded_traceback": 2,
               "banded_score_windows": 2, "myers_semiglobal_windows": 2}


def phase_paired(genome, mapper, card, label="paired",
                 n_batches=N_BATCHES_PE, rl=L, seed=SEED + 200,
                 per_batch=PE_LAUNCHES, records=None):
    """``n_batches`` batches of B FR pairs of rl bp (5% seedless mates 2)
    through dispatch_pair_batch + format_pair_batch: launch counts
    (``per_batch``), per-mate sensitivity, proper share, seedless mates
    placed. The SAM records are appended to ``records`` where given."""
    from nvbio_tpu_torch.bowtie.paired import (
        dispatch_pair_batch,
        format_pair_batch,
    )

    md = mapper.params.max_dist
    batches = [pair_batches(genome, seed + i, rl) for i in range(n_batches)]
    outs, t_dev, t_fmt, wall, launches = run_batches(
        lambda b1, b2: dispatch_pair_batch(mapper, b1, b2),
        lambda b1, b2, res: format_pair_batch(mapper, b1, b2, res),
        [pair for pair, _, _, _ in batches])
    n_ok = n_proper = n_seedless = n_seedless_ok = 0
    for recs, (_, starts, rcs, seedless) in zip(outs, batches):
        require(len(recs) == 2 * B, f"{len(recs)} records for {B} pairs")
        for i in range(B):
            ok = [placed(recs[2 * i + m], starts[m][i], rcs[m][i], md)
                  for m in (0, 1)]
            n_ok += ok[0] + ok[1]
            n_proper += bool(recs[2 * i].flag & 0x2)
            if seedless[i]:
                n_seedless += 1
                n_seedless_ok += ok[1]
    n_pairs = n_batches * B
    sens = n_ok / (2 * n_pairs)
    proper = n_proper / n_pairs
    rescued = n_seedless_ok / max(n_seedless, 1)
    print(f"[{label}] {rl} bp mates, {n_pairs} pairs in {wall:.3f} s = "
          f"{n_pairs / wall:.1f} pairs/s; per batch dispatch+sync s: "
          f"{', '.join(f'{x:.3f}' for x in t_dev)} "
          f"({n_pairs / sum(t_dev):.1f} pairs/s on the device path); "
          f"format s: {', '.join(f'{x:.3f}' for x in t_fmt)}; per-mate "
          f"sensitivity {sens:.5f}; proper {proper:.5f}; seedless mates "
          f"placed {n_seedless_ok}/{n_seedless} = {rescued:.5f}; launches "
          f"{launches}; card {card}", flush=True)
    require_launches(label, launches, per_batch, n_batches)
    if records is not None:
        records.extend(r for recs in outs for r in recs)
    require(sens >= 0.95, f"{label} per-mate sensitivity {sens:.4f} < 0.95")
    require(proper >= 0.90, f"{label} proper-pair share {proper:.4f} < 0.90")
    require(rescued >= 0.90,
            f"{label} seedless mates placed {rescued:.4f} < 0.90")
    stats = dict(pairs=n_pairs, seconds=wall, pairs_per_s=n_pairs / wall,
                 dispatch_s=sum(t_dev), format_s=sum(t_fmt),
                 sensitivity=sens, proper=proper, seedless=n_seedless,
                 seedless_placed=rescued)
    return batches[0][0], launches, stats


def phase_local(genome, mapper, card, label="local",
                n_batches=N_BATCHES_LOCAL, per_batch=SE_LAUNCHES,
                records=None):
    """``n_batches`` batches of B local reads (a third tailed) through
    dispatch + format_batch: launch counts (``per_batch``), sensitivity,
    tailed reads soft-clipped. The SAM records are appended to
    ``records`` where given."""
    md = mapper.params.max_dist
    batches = [local_batch(genome, SEED + 300 + i)
               for i in range(n_batches)]
    outs, t_dev, t_fmt, wall, launches = run_batches(
        mapper.dispatch, mapper.format_batch,
        [(b,) for b, _, _, _ in batches])
    n_ok = n_tailed = n_clipped = 0
    for recs, (_, starts, is_rc, tailed) in zip(outs, batches):
        require(len(recs) == B, f"{len(recs)} records for {B} reads")
        for rec, s, rc, tl in zip(recs, starts, is_rc, tailed):
            n_ok += placed(rec, s, rc, md)
            if tl:
                n_tailed += 1
                n_clipped += "S" in rec.cigar
    n_reads = n_batches * B
    sens = n_ok / n_reads
    clipped = n_clipped / n_tailed
    print(f"[{label}] {n_reads} reads in {wall:.3f} s = {n_reads / wall:.1f} "
          f"reads/s; per batch dispatch+sync s: "
          f"{', '.join(f'{x:.3f}' for x in t_dev)}; format_batch s: "
          f"{', '.join(f'{x:.3f}' for x in t_fmt)}; sensitivity "
          f"{sens:.5f}; tailed reads soft-clipped {clipped:.5f}; launches "
          f"{launches}; card {card}", flush=True)
    require_launches(label, launches, per_batch, n_batches)
    require(sens >= 0.95, f"{label} sensitivity {sens:.4f} < 0.95")
    require(clipped >= 0.8,
            f"{label} tailed reads soft-clipped {clipped:.4f} < 0.8")
    if records is not None:
        records.extend(r for recs in outs for r in recs)
    stats = dict(reads=n_reads, seconds=wall, reads_per_s=n_reads / wall,
                 dispatch_s=sum(t_dev), format_s=sum(t_fmt),
                 sensitivity=sens, tailed_soft_clipped=clipped)
    return batches[0][0], launches, stats


def cigar_query_len(cigar: str) -> int:
    return sum(int(n) for n, op in re.findall(r"(\d+)([MIS=X])", cigar))


def phase_paired_full(genome, mapper, label, seed, per_batch, card,
                      records=None):
    """One batch of the paired-end pairs with the full-matrix mate
    traceback (``pe_full_traceback=True``): launch counts, per-mate
    sensitivity, proper share, and every mapped CIGAR spanning its SEQ.
    The SAM records are appended to ``records`` where given."""
    from nvbio_tpu_torch.bowtie.paired import (
        dispatch_pair_batch,
        format_pair_batch,
    )

    md = mapper.params.max_dist
    pair, starts, rcs, _ = pair_batches(genome, seed)
    outs, t_dev, t_fmt, wall, launches = run_batches(
        lambda b1, b2: dispatch_pair_batch(mapper, b1, b2),
        lambda b1, b2, res: format_pair_batch(mapper, b1, b2, res), [pair])
    recs = outs[0]
    require(len(recs) == 2 * B, f"{len(recs)} records for {B} pairs")
    n_ok = n_proper = n_span_bad = n_gapped = 0
    for i in range(B):
        for m in (0, 1):
            rec = recs[2 * i + m]
            n_ok += placed(rec, starts[m][i], rcs[m][i], md)
            if rec.cigar != "*":
                n_span_bad += cigar_query_len(rec.cigar) != len(rec.seq)
                n_gapped += "I" in rec.cigar or "D" in rec.cigar
        n_proper += bool(recs[2 * i].flag & 0x2)
    sens = n_ok / (2 * B)
    proper = n_proper / B
    print(f"[{label}] {B} pairs in {wall:.3f} s = {B / wall:.1f} pairs/s; "
          f"dispatch+sync {t_dev[0]:.3f} s, format {t_fmt[0]:.3f} s; "
          f"per-mate sensitivity {sens:.5f}; proper {proper:.5f}; gapped "
          f"CIGARs {n_gapped}; CIGARs not spanning SEQ {n_span_bad}; "
          f"launches {launches}; card {card}", flush=True)
    require_launches(label, launches, per_batch, 1)
    require(sens >= 0.95, f"{label} per-mate sensitivity {sens:.4f} < 0.95")
    require(proper >= 0.90, f"{label} proper share {proper:.4f} < 0.90")
    require(n_span_bad == 0, f"{label}: {n_span_bad} CIGARs do not span "
                             f"their SEQ")
    if records is not None:
        records.extend(recs)
    return pair, launches, dict(pairs=B, seconds=wall, pairs_per_s=B / wall,
                                dispatch_s=t_dev[0], format_s=t_fmt[0],
                                sensitivity=sens, proper=proper)


def plant_repeats(genome, rng):
    """A copy of ``genome`` with N_REPEATS segments of REPEAT_LEN bases each
    pasted, exactly, over another random locus (2 Mbp of 100): a read or
    pair from either copy has two loci of equal score, so --all writes a
    secondary record for it."""
    g = genome.copy()
    n = len(g) - REPEAT_LEN
    for src, dst in zip(rng.integers(0, n, N_REPEATS).tolist(),
                        rng.integers(0, n, N_REPEATS).tolist()):
        g[dst:dst + REPEAT_LEN] = g[src:src + REPEAT_LEN]
    return g


def by_read(recs):
    """SAM records grouped by read name, in order."""
    out = {}
    for r in recs:
        out.setdefault(r.qname, []).append(r)
    return out


ALL_LAUNCHES = {"banded_score_cands": 1, "banded_traceback": 1}


def phase_all(genome, mapper, card, label="all", per_batch=ALL_LAUNCHES,
              records=None):
    """One batch of single-end reads of the repeat-planted genome through
    --all (map_batch_all): the primary of each read placed at its truth,
    some record of each read at its truth, secondaries per read. The SAM
    records are appended to ``records`` where given."""
    batch, starts, is_rc = read_batch(genome, SEED + 400)
    md = mapper.params.max_dist
    outs, t_dev, t_fmt, wall, launches = run_batches(
        mapper.dispatch_all, mapper.format_batch_all, [(batch,)])
    recs = by_read(outs[0])
    require(len(recs) == B, f"records of {len(recs)} reads for {B}")
    n_ok = n_any = n_sec = 0
    for name, s, rc in zip(batch.names, starts, is_rc):
        rs = recs[name]
        require(not rs[0].flag & 0x100 and
                 all(r.flag & 0x100 for r in rs[1:]),
                 f"{name}: the primary is not the one first record")
        n_ok += placed(rs[0], s, rc, md)
        n_any += any(placed(r, s, rc, md) for r in rs)
        n_sec += len(rs) - 1
    sens, found = n_ok / B, n_any / B
    print(f"[{label}] {B} reads in {wall:.3f} s = {B / wall:.1f} reads/s; "
          f"dispatch+sync {t_dev[0]:.3f} s, format {t_fmt[0]:.3f} s; "
          f"primaries placed {sens:.5f}; some record at the truth "
          f"{found:.5f}; {n_sec} secondary records ({n_sec / B:.4f} per "
          f"read); launches {launches}; card {card}", flush=True)
    require_launches(label, launches, per_batch, 1)
    require(sens >= 0.95, f"{label} primaries placed {sens:.4f} < 0.95")
    require(found >= 0.95, f"{label} truth among the records {found:.4f} "
                           f"< 0.95")
    require(n_sec > 0, f"{label} wrote no secondary record on the repeats")
    if records is not None:
        records.extend(outs[0])
    return batch, launches, dict(reads=B, seconds=wall, reads_per_s=B / wall,
                                 dispatch_s=t_dev[0], format_s=t_fmt[0],
                                 sensitivity=sens, truth_found=found,
                                 secondaries=n_sec,
                                 secondaries_per_read=n_sec / B)


def phase_paired_all(genome, mapper, card):
    """One batch of pairs of the repeat-planted genome (no seedless mate:
    this path has no rescue) through map_pair_batch_all: each mate's
    primary placed at its truth, secondary pair records."""
    from nvbio_tpu_torch.bowtie.paired import (
        dispatch_pair_batch_all,
        format_pair_batch_all,
    )
    from nvbio_tpu_torch.io.fastq import ReadBatch
    from nvbio_tpu_torch.utils.simgenome import sample_pairs

    seed = SEED + 500
    r1, r2, s1, s2, rc1, rc2 = sample_pairs(genome, B, L, 200, MAXINS,
                                            seed=seed, subst_rate=0.01)
    rng = np.random.default_rng(seed + 1)
    names = [f"a{seed}_{i}" for i in range(B)]
    pair = [ReadBatch(names, r.astype(np.uint8),
                      rng.integers(20, 41, size=(B, L)).astype(np.uint8),
                      np.full(B, L, np.int32)) for r in (r1, r2)]
    md = mapper.params.max_dist
    outs, t_dev, t_fmt, wall, launches = run_batches(
        lambda b1, b2: dispatch_pair_batch_all(mapper, b1, b2),
        lambda b1, b2, res: format_pair_batch_all(mapper, b1, b2, res),
        [pair])
    recs = outs[0]
    prim = [r for r in recs if not r.flag & 0x100]
    require(len(prim) == 2 * B, f"{len(prim)} primary records for {B} "
                                f"pairs")
    n_ok = sum(placed(prim[2 * i + m], (s1, s2)[m][i], (rc1, rc2)[m][i], md)
               for i in range(B) for m in (0, 1))
    sens = n_ok / (2 * B)
    n_sec = len(recs) - len(prim)
    print(f"[paired-all] {B} pairs in {wall:.3f} s = {B / wall:.1f} "
          f"pairs/s; dispatch+sync {t_dev[0]:.3f} s, format {t_fmt[0]:.3f} "
          f"s; per-mate primaries placed {sens:.5f}; {n_sec} secondary "
          f"records ({n_sec / (2 * B):.4f} per read); launches {launches}; "
          f"card {card}", flush=True)
    require_launches("paired-all", launches, {"banded_score_cands": 2,
                                              "banded_traceback": 2}, 1)
    require(sens >= 0.95, f"paired --all primaries placed {sens:.4f} < 0.95")
    require(n_sec > 0, "paired --all wrote no secondary record on the "
                       "repeats")
    return pair, launches, dict(pairs=B, seconds=wall, pairs_per_s=B / wall,
                                dispatch_s=t_dev[0], format_s=t_fmt[0],
                                sensitivity=sens, secondaries=n_sec)


def phase_gcups(card):
    """K5 as bench.py's GCUPS leg runs it (bench.py:423-467): operands on
    the card, three passes of 10 launches, the median pass; GCUPS =
    alignments * L * W / time. Launch counts read around the leg."""
    from nvbio_tpu_torch.align import kernels as K
    from nvbio_tpu_torch.bowtie.params import MapParams

    dev = torch.device("cuda")
    sc = MapParams().scoring
    out = {}
    reset_launches()
    for wk in (W, 17):
        ops = k5_operands(wk, G_K5, dev)
        kw = k5_bench_flags(sc, wk)
        K.regtile_score_blocked(*ops, **kw)
        torch.cuda.synchronize()
        passes = []
        for _ in range(3):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(10):
                K.regtile_score_blocked(*ops, **kw)
            b.record()
            torch.cuda.synchronize()
            passes.append(a.elapsed_time(b) / 10)
        ms = sorted(passes)[1]
        out[f"gcups_w{wk}"] = G_K5 * 1024 * L * wk / (ms * 1e-3) / 1e9
        out[f"ms_w{wk}"] = ms
        del ops
        torch.cuda.empty_cache()
    launches = read_launches()
    print(f"[gcups] K5 G={G_K5} L={L}: W={W} {out[f'ms_w{W}']:.3f} ms = "
          f"{out[f'gcups_w{W}']:.2f} GCUPS; W=17 {out['ms_w17']:.3f} ms = "
          f"{out['gcups_w17']:.2f} GCUPS; launches {launches}; card {card}",
          flush=True)
    require_launches("gcups", launches, {"regtile_score_blocked": 31}, 2)
    return launches, out


# ---------------------------------------------------------------------------
# FM-index seeding: the index of the 100 Mbp genome, its search on the card
# against the CPU ([fmi-search]), the FM-seeded single-end ([fmi]) and
# paired-end ([paired-fmi]) paths
# ---------------------------------------------------------------------------

FTAB_K = 11                 # the k-mer table the mapper attaches on cuda
N_FM_SEEDS = 8192           # [fmi-search]: seeds of the operating point
N_BATCHES_FM = 2
RANK_ROW_BYTES = 32         # one rank query: one 32-byte rank row
SSA_ROW_BYTES = 8           # one locate step's (marks word, popcount) row
SSA_VAL_BYTES = 4


def host_fm(genome) -> tuple:
    """The FM index by host SA-IS, then BWT, checkpoints, sampled SA and
    the rank and SSA rows on the host: (index, SA-IS s, tables s)."""
    from nvbio_tpu_torch.fmi.index import build_fmindex
    from nvbio_tpu_torch.index.sa import suffix_array

    t0 = time.time()
    sa = suffix_array(genome, method="native")
    t_sa = time.time() - t0
    t0 = time.time()
    host = build_fmindex(genome, sa=sa)
    return host, t_sa, time.time() - t0


def build_fm(genome):
    """The FM index of the genome twice: by host SA-IS and tables on the
    host (the CPU's index), and on the card (``build_fmindex_device``,
    equal to the host's: ``[index-device]``), where the k = 11 table is
    added. Returns (host index, card index, build stats)."""
    from nvbio_tpu_torch.fmi.index import attach_ftab
    from nvbio_tpu_torch.index.device_sa import build_fmindex_device

    t = {}
    host, t["sa_s"], t["tables_s"] = host_fm(genome)
    t["device"] = device_build(genome, "uniform", host)
    print(f"[index-device] uniform: host SA-IS {t['sa_s']:.2f} s + tables "
          f"{t['tables_s']:.2f} s in the same run", flush=True)
    gpu = t["device"].pop("index")
    t["device"]["profile"] = phase_profile(
        "index-device uniform", lambda: build_fmindex_device(genome,
                                                             device="cuda"))
    t0 = time.time()
    gpu = attach_ftab(gpu, FTAB_K)
    torch.cuda.synchronize()
    t["ftab_s"] = time.time() - t0
    t["bytes_on_card"] = gpu.nbytes()
    t["table_bytes"] = {
        k: getattr(gpu, k).numel() * getattr(gpu, k).element_size()
        for k in ("rank_rows", "bwt_words", "occ", "ssa_vals", "ssa_rows",
                  "ssa_marks", "ssa_cum", "ftab_lo", "ftab_hi")}
    parts = ", ".join(f"{k} {v / 1e6:.1f}"
                      for k, v in t["table_bytes"].items())
    print(f"[index] FM over {len(genome)} bp: host SA-IS {t['sa_s']:.2f} s, "
          f"BWT + checkpoints + SSA + rank/SSA rows {t['tables_s']:.2f} s; "
          f"on the card {t['device']['total_s']:.3f} s (equal tables), k="
          f"{FTAB_K} table on the card {t['ftab_s']:.2f} s; "
          f"{t['bytes_on_card'] / 1e6:.1f} MB on the card ({parts} MB)",
          flush=True)
    return host, gpu, t


# ---------------------------------------------------------------------------
# [index-device]: the FM index built on the card (index.device_sa: suffix
# sort by prefix doubling over torch.sort, then every table), held equal to
# the host SA-IS build
# ---------------------------------------------------------------------------

FM_TABLES = ("bwt_words", "occ", "count", "ssa_marks", "ssa_cum", "ssa_vals",
             "rank_rows", "ssa_rows")
BIG_GENOME = 390_000_000   # the reach device_sa.py:22-24 states for a chip
N_LOCATE_SEEDS = 8192


def device_build(codes, label, host=None) -> dict:
    """``build_fmindex_device`` of ``codes`` on the card, after a warm-up
    build of 1 Mbp: seconds by stage, tied rows and rounds, peak device
    memory above what was held, M suffixes/s; every table equal to
    ``host``'s where given. Returns the stats with the index under
    "index"."""
    from nvbio_tpu_torch.index.device_sa import build_fmindex_device

    build_fmindex_device(codes[:1_000_000], device="cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    st = {}
    t0 = time.time()
    index = build_fmindex_device(codes, device="cuda", stats=st)
    torch.cuda.synchronize()
    st["total_s"] = time.time() - t0
    st["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    st["held_bytes"] = index.nbytes()
    m = len(codes) + 1
    st["sort_msuffixes_per_s"] = m / (st["bootstrap_s"] + st["tie_s"]) / 1e6
    st["build_msuffixes_per_s"] = m / st["total_s"] / 1e6
    stages = ", ".join(f"{k[:-2]} {st[k]:.3f}" for k in
                       ("upload_s", "bootstrap_s", "tie_s", "planes_s",
                        "rows_s"))
    same = None
    if host is not None:
        t0 = time.time()
        differ = [f for f in FM_TABLES
                  if not torch.equal(getattr(index, f).cpu(),
                                     getattr(host, f))]
        same = not differ and index.primary == host.primary
        require(same, f"index-device {label}: tables {differ} (primary "
                      f"{index.primary} against {host.primary}) differ "
                      f"from the host build")
        st["compare_s"] = time.time() - t0
    print(f"[index-device] {label}, {len(codes)} bp: {st['total_s']:.3f} s "
          f"on the card (s by stage: {stages}); {st['tied_rows']} rows "
          f"tied after the 26-symbol bootstrap, {st['rounds']} doubling "
          f"rounds; sort {st['sort_msuffixes_per_s']:.1f} M suffixes/s, "
          f"build {st['build_msuffixes_per_s']:.1f} M suffixes/s; peak "
          f"{st['peak_bytes'] / 1e9:.3f} GB above the "
          f"{base / 1e9:.3f} GB held, tables {st['held_bytes'] / 1e6:.1f} "
          f"MB"
          + ("" if same is None else
             "; every table (rank and SSA rows included) equal to the host "
             "SA-IS build's")
          + f"; card {smi('name,power.limit')}", flush=True)
    st["index"] = index
    return st


def locate_seeds(index, text, rng) -> dict:
    """N_LOCATE_SEEDS seeds of 22 bases drawn from ``text``, searched and
    their first 8 rows located on the card: each seed's position must be
    among its interval's located rows (intervals of at most 8 rows)."""
    from nvbio_tpu_torch.fmi import search as S

    pos = rng.integers(0, len(text) - 22, N_LOCATE_SEEDS)
    q = torch.from_numpy(text[pos[:, None] + np.arange(22)].astype(
        np.int32)).cuda()
    ql = torch.full((N_LOCATE_SEEDS,), 22, dtype=torch.int32, device="cuda")
    lo, hi = S.backward_search_core(index, q, ql)
    k = torch.arange(8, device="cuda")
    got, _ = S.locate_core(index, (lo[:, None] + k).clamp(max=index.n)
                           .reshape(-1))
    size = hi - lo
    want = torch.from_numpy(pos).cuda()
    found = ((got.reshape(-1, 8) == want[:, None])
             & (k[None, :] < size[:, None])).any(dim=1)
    narrow = size <= 8
    n_found = int((found & narrow).sum())
    require(n_found == int(narrow.sum()) and n_found > 0,
            f"index-device: {n_found} of {int(narrow.sum())} seeds located "
            f"at their positions")
    return dict(seeds=N_LOCATE_SEEDS, located=n_found,
                wide=int((~narrow).sum()), multi=int((size > 1).sum()))


def phase_index_device(rep_genome, card) -> tuple[dict, tuple]:
    """[index-device] beyond the uniform genome's build (``build_fm``): the
    repeat-planted genome on the card against its host SA-IS build, then
    one build of BIG_GENOME random bases checked by locating seeds.
    Returns (stats, the repeats build's (BWT words on the host, primary))."""
    out = {}
    host, t_sa, t_tables = host_fm(rep_genome)
    out["repeats"] = device_build(rep_genome, "repeats", host)
    out["repeats"].update(host_sa_s=t_sa, host_tables_s=t_tables)
    print(f"[index-device] repeats: host SA-IS {t_sa:.2f} s + tables "
          f"{t_tables:.2f} s in the same run", flush=True)
    rep = out["repeats"].pop("index")
    rep_bwt = (rep.bwt_words.cpu(), rep.primary)
    del host, rep
    rng = np.random.default_rng(SEED + 2000)
    t0 = time.time()
    big = rng.integers(0, 4, size=BIG_GENOME, dtype=np.uint8)
    t_gen = time.time() - t0
    out["big"] = device_build(big, "big")
    loc = locate_seeds(out["big"].pop("index"), big, rng)
    out["big"].update(loc, genome_s=t_gen)
    print(f"[index-device] big: {loc['located']} of {loc['seeds']} seeds "
          f"located at their positions ({loc['multi']} intervals of more "
          f"than one row, {loc['wide']} of more than 8); card {card}",
          flush=True)
    del big
    torch.cuda.empty_cache()
    return out, rep_bwt


# ---------------------------------------------------------------------------
# [blockwise]: the blockwise BWT (index.blockwise) on the card, held equal to
# the one-shot device build; one text past 2^31 positions checked by its
# symbol counts and an LF walk
# ---------------------------------------------------------------------------

# 100 Mbp through >= 3 superblocks and >= 8 blocks
BW_KNOBS = dict(chunk=1 << 26, sb_cap=1 << 25, blk=1 << 23)
BW_GENOME = 2_500_000_000   # past 2^31 positions and the one-shot build
LF_INTERVAL = 1 << 16       # the LF check's checkpoint interval (rows)
LF_CHECK = 4096             # symbols the LF walk spells


def blockwise_build(codes, **knobs):
    """``blockwise_bwt`` on the card: (bwt, primary, stats with the peak
    device memory above what was held)."""
    from nvbio_tpu_torch.index.blockwise import blockwise_bwt

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    bwt, primary, st = blockwise_bwt(codes, device="cuda", **knobs)
    torch.cuda.synchronize()
    st["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    st["held_bytes"] = base
    return bwt, primary, st


def bw_stages(st) -> str:
    return ", ".join(f"{k[:-2]} {st[k]:.3f}" for k in (
        "counting_s", "upload_s", "extract_s", "sb_sort_s", "block_sort_s",
        "deepen_s", "emit_fetch_s"))


def blockwise_equal(codes, label, fm_words, fm_primary, card) -> dict:
    """``codes`` built blockwise with BW_KNOBS: BWT and primary equal to the
    one-shot device build's (``fm_words``: its packed BWT)."""
    from nvbio_tpu_torch import packed

    bwt, primary, st = blockwise_build(codes, **BW_KNOBS)
    t0 = time.time()
    words = torch.from_numpy(packed.pack(bwt, 2).view(np.int32))
    same = primary == fm_primary and torch.equal(words, fm_words.cpu())
    st["compare_s"] = time.time() - t0
    print(f"[blockwise] {label}, {len(codes)} bp, knobs {BW_KNOBS}: "
          f"{st['total_s']:.3f} s ({bw_stages(st)}); {st['superblocks']} "
          f"superblocks, {st['blocks']} blocks, {st['deepen_rounds']} "
          f"deepening rounds, {st['host_tie_small']} rows by the host "
          f"tiny-tie path, {st['host_tie_fallbacks']} by the host fallback; "
          f"{st['msuffixes_per_s']:.1f} M suffixes/s; peak "
          f"{st['peak_bytes'] / 1e9:.3f} GB; BWT and primary "
          f"{'equal to' if same else 'DIFFERENT from'} the one-shot device "
          f"build's; card {card}", flush=True)
    require(st["superblocks"] >= 3 and st["blocks"] >= 8,
            f"blockwise {label}: {st['superblocks']} superblocks, "
            f"{st['blocks']} blocks")
    require(same, f"blockwise {label}: BWT or primary ({primary} against "
                  f"{fm_primary}) differs from the one-shot device build")
    return st


def lf_spell(bwt: torch.Tensor, primary: int, count: list, k: int):
    """The last ``k`` symbols of the text, spelled by an LF walk over the
    BWT (``bwt``: n symbols on the card, the primary row dropped) from the
    sentinel's row 0, with int64 checkpoints every LF_INTERVAL rows built
    on the card. Returns (symbols, checkpoint seconds, walk seconds)."""
    t0 = time.time()
    n = bwt.shape[0]
    full = n // LF_INTERVAL * LF_INTERVAL
    blocks = bwt[:full].view(-1, LF_INTERVAL)
    per = torch.stack([(blocks == c).sum(dim=1) for c in range(4)], dim=1)
    ckpt = torch.zeros((per.shape[0] + 1, 4), dtype=torch.int64,
                       device=bwt.device)
    ckpt[1:] = torch.cumsum(per, dim=0)
    del per
    C = torch.tensor([1 + sum(count[:c]) for c in range(4)],
                     dtype=torch.int64, device=bwt.device)
    torch.cuda.synchronize()
    t_ckpt = time.time() - t0
    t0 = time.time()
    ar = torch.arange(LF_INTERVAL, dtype=torch.int64, device=bwt.device)
    r = torch.zeros((), dtype=torch.int64, device=bwt.device)
    out = torch.empty(k, dtype=torch.int64, device=bwt.device)
    for i in range(k):
        rp = r - (r > primary).to(torch.int64)   # row in the dropped plane
        c = bwt[rp].to(torch.int64)
        b = rp // LF_INTERVAL
        win = bwt[(b * LF_INTERVAL + ar).clamp(max=n - 1)]
        part = ((win == c) & (ar < rp - b * LF_INTERVAL)).sum()
        r = C[c] + ckpt[b, c] + part
        out[i] = c
    spelled = out.cpu().numpy()[::-1].astype(np.uint8)
    return spelled, t_ckpt, time.time() - t0


def phase_blockwise(genome, fm_gpu, rep_genome, rep_bwt, card) -> dict:
    """[blockwise]: the 100 Mbp genome and its repeat-planted copy through
    >= 3 superblocks and >= 8 blocks (BWT and primary equal to the one-shot
    device builds'), then BW_GENOME random bases with the defaults: the
    symbol counts of the BWT equal to the text's, and an LF walk over int64
    checkpoints built on the card spelling the text's last LF_CHECK
    symbols."""
    from nvbio_tpu_torch.index.blockwise import blockwise_bwt

    blockwise_bwt(genome[:1_000_000], device="cuda", **BW_KNOBS)  # warm-up
    out = {"uniform": blockwise_equal(genome, "uniform", fm_gpu.bwt_words,
                                      fm_gpu.primary, card),
           "repeats": blockwise_equal(rep_genome, "repeats", *rep_bwt,
                                      card)}
    rng = np.random.default_rng(SEED + 3000)
    t0 = time.time()
    text = rng.integers(0, 4, size=BW_GENOME, dtype=np.uint8)
    t_gen = time.time() - t0
    bwt, primary, st = blockwise_build(text)
    t0 = time.time()
    # on the card: np.bincount widens 2.5 G symbols to int64 on the host
    dev_text = torch.from_numpy(text).cuda()
    count = [int((dev_text == c).sum()) for c in range(4)]
    del dev_text
    t_count = time.time() - t0
    t0 = time.time()
    dev_bwt = torch.from_numpy(bwt).cuda()
    del bwt
    bwt_count = [int((dev_bwt == c).sum()) for c in range(4)]
    t_up = time.time() - t0
    spelled, t_ckpt, t_walk = lf_spell(dev_bwt, primary, count, LF_CHECK)
    del dev_bwt
    torch.cuda.empty_cache()
    lf_ok = np.array_equal(spelled, text[-LF_CHECK:])
    st.update(genome_s=t_gen, text_count_s=t_count, bwt_upload_count_s=t_up,
              lf_checkpoint_s=t_ckpt, lf_walk_s=t_walk, symbols=count)
    print(f"[blockwise] big, {BW_GENOME} bp (n > 2^31) with the default "
          f"knobs: {st['total_s']:.3f} s ({bw_stages(st)}); "
          f"{st['superblocks']} superblocks, {st['blocks']} blocks "
          f"(superblock sizes {st['sb_sizes']}), {st['deepen_rounds']} "
          f"deepening rounds, {st['host_tie_small']} rows by the host "
          f"tiny-tie path, {st['host_tie_fallbacks']} by the host fallback; "
          f"{st['msuffixes_per_s']:.1f} M suffixes/s; peak "
          f"{st['peak_bytes'] / 1e9:.3f} GB above the "
          f"{st['held_bytes'] / 1e9:.3f} GB held; text generated in "
          f"{t_gen:.2f} s; symbol counts {bwt_count} (text {count}); LF "
          f"walk of {LF_CHECK} steps {t_walk:.2f} s over checkpoints built "
          f"in {t_ckpt:.2f} s: {'spells' if lf_ok else 'does NOT spell'} "
          f"the text's last {LF_CHECK} symbols; card {card}", flush=True)
    require(bwt_count == count, f"blockwise big: BWT symbol counts "
                                f"{bwt_count} differ from the text's {count}")
    require(lf_ok, "blockwise big: the LF walk does not spell the text's end")
    out["big"] = st
    del text
    return out


# ---------------------------------------------------------------------------
# [setbwt]: the card's BWTE engine (index.bwte_device) on a read set
# ---------------------------------------------------------------------------

N_SETBWT_READS = 4_000_000
SETBWT_L = 100
SETBWT_BLOCK = 500_000
N_SETBWT_NATIVE = 250_000   # the subset the native engine also builds


def setbwt_reads(n, seed):
    """``n`` reads of SETBWT_L random bases, 1% of them copies of others."""
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 4, size=(n, SETBWT_L), dtype=np.uint8)
    dup = rng.choice(n, n // 100, replace=False)
    reads[dup] = reads[rng.integers(0, n, n // 100)]
    return reads


def bwte_run(reads, block):
    """``BwteDevice`` on the card over ``reads`` in blocks of ``block``:
    (bwt, tags, seconds a block, peak device memory)."""
    from nvbio_tpu_torch.index.bwte_device import BwteDevice

    m, L = reads.shape
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = BwteDevice(capacity=m * (L + 1), n_strings=m, device="cuda")
    secs = []
    for i in range(0, m, block):
        t0 = time.time()
        eng.add_block(reads[i:i + block])
        eng.sync()
        secs.append(time.time() - t0)
    peak = torch.cuda.max_memory_allocated() - base
    bwt, tags = eng.finalize()
    return bwt, tags, secs, peak


def phase_setbwt(card) -> dict:
    """[setbwt]: BwteDevice on N_SETBWT_READS reads of SETBWT_L bases in
    blocks of SETBWT_BLOCK (seconds a block, M symbols/s); the result has
    the read set's symbol counts and one '$' a read, each read's tag once;
    its first N_SETBWT_NATIVE reads, built again on the card in 4 blocks,
    give the native engine's BWT (timed in this run)."""
    from nvbio_tpu_torch.index.setbwt import mse_bwt_incremental

    t0 = time.time()
    reads = setbwt_reads(N_SETBWT_READS, SEED + 3100)
    t_gen = time.time() - t0
    bwte_run(reads[:8192], 4096)                              # warm-up
    sub = reads[:N_SETBWT_NATIVE]
    sblock = N_SETBWT_NATIVE // 4
    sbwt, _, ssecs, _ = bwte_run(sub, sblock)
    t0 = time.time()
    nbwt = mse_bwt_incremental(sub, sblock, method="native")
    t_native = time.time() - t0
    sub_ok = np.array_equal(sbwt, nbwt)
    bwt, tags, secs, peak = bwte_run(reads, SETBWT_BLOCK)
    n_sym = N_SETBWT_READS * (SETBWT_L + 1)
    t0 = time.time()
    counts = np.bincount(bwt, minlength=5).tolist()
    want = [N_SETBWT_READS] + (np.bincount(reads.reshape(-1), minlength=4)
                               ).tolist()
    tags_ok = np.array_equal(np.sort(tags[bwt == 0]),
                             np.arange(N_SETBWT_READS))
    t_check = time.time() - t0
    st = dict(reads=N_SETBWT_READS, read_len=SETBWT_L, block=SETBWT_BLOCK,
              symbols=n_sym, block_s=secs, total_s=sum(secs),
              msymbols_per_s=n_sym / sum(secs) / 1e6, peak_bytes=peak,
              reads_s=t_gen, check_s=t_check,
              subset=dict(reads=N_SETBWT_NATIVE, block=sblock,
                          device_s=sum(ssecs), native_s=t_native,
                          native_msymbols_per_s=len(nbwt) / t_native / 1e6,
                          equal=sub_ok))
    print(f"[setbwt] BwteDevice, {N_SETBWT_READS} reads of {SETBWT_L} bp "
          f"(1% duplicated) in blocks of {SETBWT_BLOCK}: {sum(secs):.3f} s, "
          f"{st['msymbols_per_s']:.1f} M symbols/s, s a block "
          f"{[round(x, 3) for x in secs]}, peak {peak / 1e9:.3f} GB; symbol "
          f"counts {counts} (read set {want}), every tag once: {tags_ok}; "
          f"first {N_SETBWT_NATIVE} reads in blocks of {sblock}: card "
          f"{sum(ssecs):.3f} s, native engine {t_native:.2f} s "
          f"({st['subset']['native_msymbols_per_s']:.2f} M symbols/s), "
          f"{'equal' if sub_ok else 'DIFFERENT'} BWTs; card {card}",
          flush=True)
    require(sub_ok, "setbwt: the card's BWT of the subset differs from the "
                    "native engine's")
    require(counts == want and tags_ok,
            f"setbwt: symbol counts {counts} against {want}, tags once: "
            f"{tags_ok}")
    return st


# ---------------------------------------------------------------------------
# [randomized]: select_mode="randomized" (SumTree draws from the port's
# threefry) on the SE q-gram, SE FM and PE paths
# ---------------------------------------------------------------------------

def phase_randomized(genome, ref, index, fm_gpu, fm_cpu, params, card):
    """One batch of B single-end reads with the q-gram index, one with the
    FM index and one batch of B pairs, all under select_mode="randomized":
    reads/s, sensitivity >= 0.95, launches as their stratified paths', one
    profiled batch each (device ops and busy), and GPU = CPU records on
    N_CMP reads and pairs."""
    from nvbio_tpu_torch.bowtie.paired import dispatch_pair_batch
    from nvbio_tpu_torch.bowtie.paired import map_pair_batch
    from nvbio_tpu_torch.bowtie.pipeline import ReadMapper

    rp = dataclasses.replace(params, select_mode="randomized")
    fp = dataclasses.replace(rp, seeding="fmi")
    out, launches = {}, {}
    mq, bq, launches["randomized_qgram"], out["qgram"] = phase_main_path(
        genome, ref, index, rp, card, label="randomized-qgram",
        n_batches=1, seed=SEED + 1700)
    mf, bf, launches["randomized_fmi"], out["fmi"] = phase_main_path(
        genome, ref, fm_gpu, fp, card, label="randomized-fmi", n_batches=1,
        seed=SEED + 1800)
    pair0, launches["randomized_paired"], out["paired"] = phase_paired(
        genome, mq, card, label="randomized-paired", n_batches=1,
        seed=SEED + 1900)
    out["qgram"]["profile"] = phase_profile("randomized-qgram",
                                            lambda: mq.dispatch(bq))
    out["fmi"]["profile"] = phase_profile("randomized-fmi",
                                          lambda: mf.dispatch(bf))
    out["paired"]["profile"] = phase_profile(
        "randomized-paired", lambda: dispatch_pair_batch(mq, *pair0))
    cq = ReadMapper.build(ref, rp, index=index.to("cpu"), device="cpu")
    cf = ReadMapper.build(ref, fp, index=fm_cpu, device="cpu")
    sq, sf = head(bq), head(bf)
    phase_gpu_equals_cpu("randomized-qgram", lambda: mq.map_batch(sq),
                         lambda: cq.map_batch(sq), N_CMP)
    phase_gpu_equals_cpu("randomized-fmi", lambda: mf.map_batch(sf),
                         lambda: cf.map_batch(sf), N_CMP)
    p1, p2 = head(pair0[0]), head(pair0[1])
    phase_gpu_equals_cpu("randomized-paired",
                         lambda: map_pair_batch(mq, p1, p2),
                         lambda: map_pair_batch(cq, p1, p2), 2 * N_CMP)
    return out, launches


def device_ops(fn) -> tuple[int, float]:
    """(device ops, device busy ms) of one call of ``fn`` (torch.profiler,
    after a warm-up call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    return sum(r[1] for r in rows), sum(r[0] for r in rows) / 1e3


def torch_ops(fn):
    """(result, torch ops) of one call of ``fn``: the ATen operator calls
    it dispatches (each one or more kernel launches on the card), counted
    by a dispatch mode. Cheaper than torch.profiler per op, which costs
    about half a millisecond a kernel to record and sort (on an H100
    machine, 55 s for one paired-end scan-route batch of 88363 kernels)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with Count() as count:
        res = fn()
    return res, count.n


def fm_active_lanes(index, q, ql, k: int) -> int:
    """Lane-steps of ``backward_search_core`` with a k-symbol table that
    this data needs: the steps past the first k at which a lane's query is
    not yet consumed and its interval not yet empty (counted on the CPU
    index; the table's intervals are the first k steps')."""
    from nvbio_tpu_torch.fmi.search import step_backward

    L = q.shape[1]
    ql = ql.to(torch.int64)
    lo = torch.zeros(q.shape[0], dtype=torch.int64)
    hi = torch.full_like(lo, index.n + 1)
    n_active = 0
    for s in range(L):
        active = (s < ql) & (hi > lo)
        n_active += int(active.sum()) if s >= k else 0
        c = torch.gather(q, 1, (ql - 1 - s).clamp(0, L - 1)[:, None])[:, 0]
        nlo, nhi = step_backward(index, c, lo, hi)
        lo, hi = torch.where(active, nlo, lo), torch.where(active, nhi, hi)
    return n_active


def phase_fmi_search(genome, cpu_index, gpu_index, params, card):
    """Backward search (k-mer table start), locate and the 1-mismatch top-K
    search over N_FM_SEEDS seeds of the operating point on the card,
    against the same calls on the CPU index (no table): equal intervals
    (empty ones compared as empty), positions and top-K intervals. Each
    call's ms (CUDA events, median of 7), device ops (torch.profiler) and,
    for search and locate, a bytes bound: the 32-byte rank rows, 8-byte SSA
    rows and 4-byte sampled values this data needs, plus inputs and
    outputs, over the HBM rate."""
    from nvbio_tpu_torch.bowtie.pipeline import reverse_strand, seed_grid
    from nvbio_tpu_torch.fmi import search as S

    batch, _, _ = read_batch(genome, SEED + 1600)
    n_reads = -(-N_FM_SEEDS // (2 * params.seeds_per_strand))
    reads = torch.from_numpy(batch.codes[:n_reads].astype(np.int32))
    lens = torch.from_numpy(batch.lengths[:n_reads])
    _, seeds, _ = seed_grid(reads, reverse_strand(reads, lens), lens, params)
    q = seeds.reshape(-1, params.seed_len)[:N_FM_SEEDS].contiguous()
    ql = torch.full((N_FM_SEEDS,), params.seed_len, dtype=torch.int32)
    qg, qlg = q.cuda(), ql.cuda()
    H = params.hits_per_seed
    A = (params.seed_len + 1) // 2
    out = {}

    lo, hi = S.backward_search_core(gpu_index, qg, qlg)
    wlo, whi = S.backward_search_core(cpu_index, q, ql)
    ne = whi > wlo
    require(torch.equal((hi > lo).cpu(), ne)
            and torch.equal(lo.cpu()[ne], wlo[ne])
            and torch.equal(hi.cpu()[ne], whi[ne]),
            "fmi-search: intervals on cuda (k-mer table) differ from cpu")
    nlo, nhi = S.backward_search_core(gpu_index.without_ftab(), qg, qlg)
    require(torch.equal(nlo.cpu(), wlo) and torch.equal(nhi.cpu(), whi),
            "fmi-search: intervals on cuda (no table) differ from cpu")
    rows = (wlo[:, None] + torch.arange(H)).clamp(0, cpu_index.n).reshape(-1)
    rows_g = rows.cuda()
    pos, done = S.locate_core(gpu_index, rows_g)
    wpos, wdone = S.locate_core(cpu_index, rows)
    require(torch.equal(pos.cpu(), wpos) and torch.equal(done.cpu(), wdone)
            and bool(wdone.all()),
            "fmi-search: located positions differ between cuda and cpu")
    got = S.search_1mm_hybrid_topk(gpu_index, qg, qlg, A, K=8)
    want = S.search_1mm_hybrid_topk(cpu_index, q, ql, A, K=8)
    require(all(torch.equal(a.cpu(), b) for a, b in zip(got, want)),
            "fmi-search: 1-mismatch top-K intervals differ between cuda "
            "and cpu")

    n_active = fm_active_lanes(cpu_index, q, ql, gpu_index.ftab_k)
    io_bytes = (q.numel() * q.element_size() + ql.numel() * 4
                + 2 * N_FM_SEEDS * 8)
    bs_bytes = (2 * n_active * RANK_ROW_BYTES
                + N_FM_SEEDS * 2 * gpu_index.ftab_lo.element_size()
                + io_bytes)
    tpos = wpos % cpu_index.sa_interval     # LF steps each walk needs
    R = rows.numel()
    loc_bytes = (int((tpos + 1).sum()) * SSA_ROW_BYTES
                 + int(tpos.sum()) * RANK_ROW_BYTES + R * SSA_VAL_BYTES
                 + R * (8 + 8 + 1))
    nnz = int((got[3] > got[2]).sum())
    calls = {
        "backward_search": (lambda: S.backward_search_core(gpu_index, qg,
                                                           qlg), bs_bytes),
        "locate": (lambda: S.locate_core(gpu_index, rows_g), loc_bytes),
        "search_1mm_hybrid_topk": (
            lambda: S.search_1mm_hybrid_topk(gpu_index, qg, qlg, A, K=8),
            None),
    }
    for name, (fn, nbytes) in calls.items():
        ms = cuda_ms(fn)
        ops, busy = device_ops(fn)
        bound = None if nbytes is None else nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = dict(ms=ms, device_ops=ops, device_busy_ms=busy,
                         bound_ms=bound, bound_bytes=nbytes)
        print(f"[fmi-search] {name}: {ms:.3f} ms a call, {ops} device ops, "
              f"device busy {busy:.3f} ms"
              + ("" if bound is None else
                 f"; bytes bound {bound:.4f} ms ({nbytes / 1e6:.2f} MB)")
              + f"; card {card}", flush=True)
    print(f"[fmi-search] {N_FM_SEEDS} seeds of {params.seed_len}: "
          f"{int(ne.sum())} nonempty intervals, {n_active} lane-steps past "
          f"the k={gpu_index.ftab_k} table, {R} rows located "
          f"({float(tpos.float().mean()):.3f} LF steps a row), {nnz} "
          f"nonempty 1-mismatch branches; cuda = cpu", flush=True)
    out.update(seeds=N_FM_SEEDS, nonempty=int(ne.sum()),
               lane_steps=n_active, rows=R,
               lf_steps_per_row=float(tpos.float().mean()),
               mm_branches=nnz)
    return out


def fm_stage(mapper, batch):
    """The FM seeding work of one single-end batch, alone: seeds of both
    strands searched and H rows each located, pass 0 (whole reads), and
    the reseed pass's seeds (B2 reads, shifted grid) with their 1-mismatch
    search — what ``align_batch_core`` runs between the reads and K1."""
    from nvbio_tpu_torch.bowtie.pipeline import (
        fm_seed_hits,
        fm_seed_hits_1mm,
        fm_whole_read,
        reverse_strand,
        seed_grid,
    )

    P, index = mapper.params, mapper.index
    reads, lens, _ = mapper.batch_tensors(batch)
    B2 = max(8, min(B, int(round(B * P.reseed_frac / 8)) * 8))
    phase = P.seed_stride // (P.max_reseed + 1)

    def run():
        rc = reverse_strand(reads, lens)
        _, seeds, valid = seed_grid(reads, rc, lens, P)
        out = [fm_seed_hits(index, seeds, valid, P.hits_per_seed),
               fm_whole_read(index, reads, rc, lens)]
        _, seeds2, valid2 = seed_grid(reads[:B2], rc[:B2], lens[:B2], P,
                                      phase)
        out += [fm_seed_hits(index, seeds2, valid2, P.hits_per_seed),
                fm_seed_hits_1mm(index, seeds2)]
        return out

    run.b2 = B2
    return run


def phase_fmi(genome, ref, gpu_index, params, card):
    """[fmi]: N_BATCHES_FM batches of B single-end reads, FM-seeded (the
    card index with its k-mer table), through phase_main_path (K1 x2, K2 x1
    a batch, sensitivity >= 0.95); one batch profiled, and its FM stage
    alone: ms, device ops, device busy and its share of the batch's, peak
    device memory."""
    mapper, batch0, launches, stats = phase_main_path(
        genome, ref, gpu_index, params, card, label="fmi",
        n_batches=N_BATCHES_FM, seed=SEED + 1400)
    stats["profile"] = phase_profile("fmi", lambda: mapper.dispatch(batch0))
    stage = fm_stage(mapper, batch0)
    ms = cuda_ms(stage)
    ops, busy = device_ops(stage)
    peak = peak_memory("fmi stage", stage)
    share = (None if stats["profile"] is None
             else busy / stats["profile"]["device_busy_ms"])
    print(f"[fmi] FM stage of one batch ({B} reads, reseed pass "
          f"{stage.b2}): "
          f"{ms:.3f} ms, {ops} device ops, device busy {busy:.3f} ms"
          + ("" if share is None else
             f" = {100 * share:.1f}% of the batch's device busy")
          + f"; peak {peak / 1e6:.1f} MB; card {card}", flush=True)
    stats["fm_stage"] = dict(ms=ms, device_ops=ops, device_busy_ms=busy,
                             share_of_batch_busy=share, peak_bytes=peak)
    stats["peak_bytes"] = peak_memory("fmi",
                                      lambda: mapper.dispatch(batch0))
    return mapper, batch0, launches, stats


# ---------------------------------------------------------------------------
# [cli]: the app itself (python -m nvbio_tpu_torch map), in-process so the
# launch counters can be read, on a .pac reference, with BAM output, a
# report, debug records, the MAPQ filter and a profile
# ---------------------------------------------------------------------------

N_CLI_SE_BATCHES = 2
CLI_MAPQ_FILTER = 10
# GPU = CPU through the app maps 1024 reads and pairs on the genome's first
# 8 Mbp (its own .pac prefix): the app builds its q-gram index on the fly,
# and over 100 Mbp that takes ~10 s a run on the host
CLI_CMP_GENOME = 8_000_000
N_AB = 2             # runs of each loop in the overlap A/B, A B B A
CLI_FLAGS = ("--batch", str(B), "--max-read-len", str(L), "--hits-per-seed",
             "6", "--max-dist", str(MAX_DIST))
# the device of the app's runs on the card: its default (cuda)
CLI_GPU_ARGS: tuple = ()
# the gauge probe (one single-end dispatch of zero-length reads) before each
# run's batches
PROBE_LAUNCHES = {"banded_score_cands": 2, "banded_traceback": 1}


def run_cli(argv, command="map") -> tuple[float, str]:
    """``python -m nvbio_tpu_torch <command> *argv`` in this process:
    (seconds, the app's log, which is also echoed). Fails unless it exits
    0."""
    import contextlib
    import io

    from nvbio_tpu_torch.__main__ import main

    log = io.StringIO()
    t0 = time.time()
    try:
        with contextlib.redirect_stderr(log):
            rc = main([command, *argv])
    finally:
        for line in log.getvalue().splitlines():
            print(f"[cli]   {line}", flush=True)
    require(rc == 0, f"{command} {' '.join(argv)} exited {rc}")
    return time.time() - t0, log.getvalue()


_ROW = re.compile(r"<tr><td>([a-zA-Z ]+?) ?(\d*)</td><td>([\d,]+)</td>")


def report_counts(path) -> dict:
    """{(metric, bin): count} of an HTML report's mapping table and its
    MAPQ ("mapq", q) and NM histogram rows."""
    with open(path) as f:
        return {(k, b): int(n.replace(",", ""))
                for k, b, n in _ROW.findall(f.read())}


def stage_seconds(log: str) -> dict:
    """The app's per-stage host seconds and calls (its StageStats lines)."""
    return {m[0]: dict(seconds=float(m[1]), calls=int(m[2])) for m in
            re.findall(r"\] (\S+)\s+([\d.]+)s\s+(\d+) calls", log)}


def cli_launches(path, got, per_batch, n_batches):
    """A run's launches: the gauge probe's plus ``per_batch`` a batch."""
    want = {k: PROBE_LAUNCHES.get(k, 0) + per_batch.get(k, 0) * n_batches
            for k in got}
    require(got == want, f"{path}: launches {got}, expected {want}")


def by_name(recs) -> dict:
    return {r[0]: r for r in recs if not int(r[1]) & 0x100}


def phase_cli(genome, mapper, card):
    """The app through its command line on the card. Writes the genome as
    g.pac/.ann/.amb (the q-gram index is built by the app), FASTQs with
    the truth in each name, and runs: single-end (2 batches, BAM, report,
    debug records, --mapq-filter 10), paired-end (1 batch, 5% seedless
    mates 2, BAM, report), 1024 reads and 1024 pairs of the first 8 Mbp
    (h.pac) on cuda (with a profile) and on cpu; then the app's overlapped
    single-end loop against a plain map_batch loop over the same 2 batches
    (A B B A)."""
    import io
    import os
    import tempfile

    from nvbio_tpu_torch.apps.map_app import map_single_end
    from nvbio_tpu_torch.io.bam import BamReader, BamWriter, read_bam
    from nvbio_tpu_torch.io.bgzf import BgzfWriter
    from nvbio_tpu_torch.io.debug import read_debug
    from nvbio_tpu_torch.io.fastq import fastq_batches
    from nvbio_tpu_torch.io.pac import save_reference_pac
    from nvbio_tpu_torch.io.reference import Reference
    from nvbio_tpu_torch.utils.simgenome import write_fastq

    tmp = tempfile.TemporaryDirectory()
    d = tmp.name
    out = {}

    def p(name):
        return f"{d}/{name}"

    t0 = time.time()
    save_reference_pac(Reference(["sim100M"], np.array([0, len(genome)],
                                                       np.int64), genome),
                       p("g"))
    se = [read_batch(genome, SEED + 1000 + i)
          for i in range(N_CLI_SE_BATCHES)]
    codes, quals, starts, is_rc = (np.concatenate([x[0].codes for x in se]),
                                   np.concatenate([x[0].quals for x in se]),
                                   np.concatenate([x[1] for x in se]),
                                   np.concatenate([x[2] for x in se]))
    names = [f"s{j}_{s}_{int(rc)}" for j, (s, rc) in
             enumerate(zip(starts.tolist(), is_rc.tolist()))]
    se_truth = dict(zip(names, zip(starts.tolist(), is_rc.tolist())))
    write_fastq(p("se.fq"), names, codes, quals)
    (b1, b2), (s1, s2), (rc1, rc2), seedless = pair_batches(genome,
                                                             SEED + 1100)
    names = [f"p{j}_{a}_{int(ra)}_{c}_{int(rb)}" for j, (a, ra, c, rb) in
             enumerate(zip(s1.tolist(), rc1.tolist(), s2.tolist(),
                           rc2.tolist()))]
    for mate, bm in (("1", b1), ("2", b2)):
        write_fastq(p(f"r{mate}.fq"), names, bm.codes, bm.quals)
    small = genome[:CLI_CMP_GENOME]
    save_reference_pac(Reference(["sim8M"], np.array([0, len(small)],
                                                     np.int64), small),
                       p("h"))
    sb = head(read_batch(small, SEED + 1200)[0])
    write_fastq(p("ses.fq"), sb.names, sb.codes, sb.quals)
    for mate, bm in zip("12", pair_batches(small, SEED + 1300)[0]):
        bm = head(bm)
        write_fastq(p(f"r{mate}s.fq"), bm.names, bm.codes, bm.quals)
    out["inputs_s"] = time.time() - t0
    print(f"[cli] inputs: {len(genome)} bp as g.pac/.ann/.amb, "
          f"{len(se_truth)} SE reads, {B} pairs in {out['inputs_s']:.2f} s; "
          f"BAM compressor: {BgzfWriter(io.BytesIO()).compressor}", flush=True)

    # --- single-end: 2 batches, BAM + report + debug + MAPQ filter -------
    reset_launches()
    se_s, se_log = run_cli([p("g"), p("se.fq"), "-o", p("se.bam"),
                            "--report", p("se.html"), "--debug-output",
                            p("se.dbg"), "--mapq-filter",
                            str(CLI_MAPQ_FILTER), *CLI_FLAGS, *CLI_GPU_ARGS])
    se_launches = read_launches()
    cli_launches("cli single-end", se_launches,
                 {"banded_score_cands": 2, "banded_traceback": 1},
                 N_CLI_SE_BATCHES)
    t0 = time.time()
    _, recs = read_bam(p("se.bam"))
    t_decode = time.time() - t0
    prim = by_name(recs)
    n = len(se_truth)
    require(len(recs) == len(prim) == n and set(prim) == set(se_truth),
            f"se.bam: {len(recs)} records, {len(prim)} primaries for {n} "
            f"reads")
    mapped = [r for r in prim.values() if not int(r[1]) & 4]
    n_ok = sum(bool(int(r[1]) & 0x10) == bool(se_truth[r[0]][1])
               and abs(int(r[3]) - 1 - se_truth[r[0]][0]) <= 2 * MAX_DIST
               for r in mapped)
    sens = n_ok / n
    low = sum(int(r[4]) < CLI_MAPQ_FILTER for r in mapped)
    rep = report_counts(p("se.html"))
    rep_kept = sum(v for (k, q), v in rep.items()
                   if k == "mapq" and int(q) >= CLI_MAPQ_FILTER)
    n_dbg = len(read_debug(p("se.dbg")))
    stages = stage_seconds(se_log)
    per_batch = ", ".join(f"{k} {v['seconds'] / v['calls']:.3f}"
                          for k, v in stages.items())
    print(f"[cli] single-end: {n} reads in {se_s:.3f} s end to end "
          f"({n / se_s:.1f} reads/s, reference load + index + gauge "
          f"included); host s a batch: {per_batch}; sensitivity from the BAM "
          f"{sens:.5f}; mapped {len(mapped)}, report mapped "
          f"{rep[('mapped', '')]} of which MAPQ >= {CLI_MAPQ_FILTER}: "
          f"{rep_kept}; mapped below the filter {low}; debug records "
          f"{n_dbg}; BAM decode {t_decode:.2f} s; launches {se_launches}; "
          f"card {card}", flush=True)
    require(sens >= 0.95, f"cli single-end sensitivity {sens:.4f} < 0.95")
    require(low == 0, f"{low} mapped primaries below MAPQ {CLI_MAPQ_FILTER}")
    require(rep[("reads", "")] == n and rep_kept == len(mapped)
            and sum(v for (k, _), v in rep.items() if k == "mapq")
            == rep[("mapped", "")],
            "se report counts differ from the BAM's")
    require(n_dbg == n, f"{n_dbg} debug records for {n} reads")
    out["single_end"] = dict(reads=n, seconds=se_s, stages=stages,
                             sensitivity=sens, mapped=len(mapped),
                             report_mapped=rep[("mapped", "")],
                             launches=se_launches)

    # the BAM write alone: the same records through BamWriter again (equal
    # bytes: the blocks are cut at the same stream offsets)
    with BamReader(p("se.bam")) as r:
        sam_recs = list(r)
        ref_names, ref_lengths = r.ref_names, r.ref_lengths
    t0 = time.time()
    with BamWriter(p("again.bam"), ref_names, ref_lengths) as w:
        for rec in sam_recs:
            w.write(rec)
    t_bam = time.time() - t0
    with open(p("se.bam"), "rb") as f, open(p("again.bam"), "rb") as g:
        require(f.read() == g.read(), "se.bam differs from its records "
                                      "written again")
    print(f"[cli] BAM write of {len(sam_recs)} records: {t_bam:.3f} s "
          f"({len(sam_recs) / t_bam:.0f} records/s); card {card}",
          flush=True)
    out["bam_write_s"] = t_bam

    # --- paired-end: 1 batch, BAM + report --------------------------------
    reset_launches()
    pe_s, pe_log = run_cli([p("g"), "-1", p("r1.fq"), "-2", p("r2.fq"),
                            "-o", p("pe.bam"), "--report", p("pe.html"),
                            *CLI_FLAGS, *CLI_GPU_ARGS])
    pe_launches = read_launches()
    cli_launches("cli paired-end", pe_launches, PE_LAUNCHES, 1)
    _, recs = read_bam(p("pe.bam"))
    require(len(recs) == 2 * B, f"pe.bam: {len(recs)} records for {B} "
                                f"pairs")
    n_ok = n_proper = 0
    for i in range(B):
        for m in (0, 1):
            r = recs[2 * i + m]
            f = int(r[1])
            _, a, ra, c, rb = r[0].split("_")
            s, rc = (int(a), ra == "1") if m == 0 else (int(c), rb == "1")
            n_ok += (not f & 4 and bool(f & 0x10) == rc
                     and abs(int(r[3]) - 1 - s) <= 2 * MAX_DIST)
        n_proper += bool(int(recs[2 * i][1]) & 0x2)
    sens = n_ok / (2 * B)
    rep = report_counts(p("pe.html"))
    print(f"[cli] paired-end: {B} pairs in {pe_s:.3f} s end to end "
          f"({B / pe_s:.1f} pairs/s, reference load + index + gauge "
          f"included); per-mate sensitivity from the BAM {sens:.5f}; proper "
          f"pairs {n_proper}, report {rep[('proper pairs', '')]}; launches "
          f"{pe_launches}; card {card}", flush=True)
    require(sens >= 0.95, f"cli paired-end sensitivity {sens:.4f} < 0.95")
    require(rep[("proper pairs", "")] == n_proper
            and rep[("reads", "")] == 2 * B,
            "pe report counts differ from the BAM's")
    out["paired_end"] = dict(pairs=B, seconds=pe_s, sensitivity=sens,
                             proper=n_proper, launches=pe_launches)

    # --- GPU = CPU through the app (on the genome's first 8 Mbp); the cuda
    # runs write a profile each ---
    for label, reads, flags in (
            ("single-end", [p("ses.fq")],
             ["--debug-output", "{}.dbg", "--mapq-filter",
              str(CLI_MAPQ_FILTER)]),
            ("paired-end", ["-1", p("r1s.fq"), "-2", p("r2s.fq")], [])):
        got = {}
        for dev, dev_args in (("cuda", [*CLI_GPU_ARGS, "--profile",
                                        p("prof")]),
                              ("cpu", ["--device", "cpu"])):
            tag = p(f"{label}_{dev}")
            secs, _ = run_cli([p("h"), *reads, "-o", f"{tag}.bam",
                               "--report", f"{tag}.html",
                               *(a.format(tag) for a in flags), *CLI_FLAGS,
                               "--batch", str(N_CMP), *dev_args])
            got[dev] = (read_bam(f"{tag}.bam")[1], report_counts(
                f"{tag}.html"), (open(f"{tag}.dbg", "rb").read()
                                 if flags else b""), secs)
        g, c = got["cuda"], got["cpu"]
        diff = sum(a != b for a, b in zip(g[0], c[0]))
        print(f"[gpu=cpu] cli {label}: {len(g[0])} BAM records, {diff} "
              f"differ; report counts equal {g[1] == c[1]}; debug bytes "
              f"equal {g[2] == c[2]} ({len(g[2])} B); cuda {g[3]:.2f} s, "
              f"cpu {c[3]:.2f} s", flush=True)
        require(len(g[0]) == len(c[0]) > 0 and diff == 0,
                f"cli {label}: BAM records differ between cuda and cpu")
        require(g[1] == c[1], f"cli {label}: report counts differ")
        require(g[2] == c[2], f"cli {label}: debug records differ")
    traces = sorted(os.listdir(p("prof")))
    require(len(traces) == 2, f"profile: {traces}")
    with open(p(f"prof/{traces[0]}")) as f:
        events = json.load(f)["traceEvents"]
    n_kernels = sum(ev.get("cat") == "kernel" for ev in events)
    print(f"[cli] --profile: {traces}, {len(events)} trace events, "
          f"{n_kernels} device kernels", flush=True)
    out["profile_kernel_events"] = n_kernels

    # --- FM seeding through the app: a .ref.npz prefix with the port's own
    # .fmi.npz beside it, one batch to SAM on cuda and on cpu ---
    from nvbio_tpu_torch.fmi.index import build_fmindex

    t0 = time.time()
    Reference(["sim8M"], np.array([0, len(small)], np.int64), small).save(
        p("hf.ref.npz"))
    build_fmindex(small).save(p("hf.fmi.npz"))
    t_save = time.time() - t0
    fm = {}
    for run, dev_args in (("card", list(CLI_GPU_ARGS)),
                          ("host", ["--device", "cpu"])):
        reset_launches()
        secs, _ = run_cli([p("hf"), p("ses.fq"), "--seeding", "fmi", "-o",
                           p(f"fmi_{run}.sam"), *CLI_FLAGS, "--batch",
                           str(N_CMP), *dev_args])
        if run == "card":
            cli_launches("cli fmi", read_launches(),
                         {"banded_score_cands": 2, "banded_traceback": 1}, 1)
        with open(p(f"fmi_{run}.sam")) as f:
            fm[run] = ([ln for ln in f if not ln.startswith("@PG")], secs)
    (g, g_s), (c, c_s) = fm["card"], fm["host"]
    diff = sum(a != b for a, b in zip(g, c))
    n_rec = sum(not ln.startswith("@") for ln in g)
    print(f"[gpu=cpu] cli fmi: {n_rec} SAM records, {diff} differ; index "
          f"built and saved in {t_save:.2f} s; cuda {g_s:.2f} s, cpu "
          f"{c_s:.2f} s", flush=True)
    require(n_rec == N_CMP and len(g) == len(c) and diff == 0,
            "cli fmi: SAM records differ between cuda and cpu")
    out["fmi"] = dict(records=n_rec, cuda_s=g_s, cpu_s=c_s, index_s=t_save)

    # --- the overlapped single-end loop against a map_batch loop ----------
    batches = list(fastq_batches(p("se.fq"), B, L))

    def overlapped():
        recs = []
        map_single_end(mapper, batches, recs.append)
        return recs

    def plain():
        return [r for b in batches for r in mapper.map_batch(b)]

    times = {"overlapped": [], "map_batch": []}
    lines = {}
    for name, fn in [("overlapped", overlapped), ("map_batch", plain),
                     ("map_batch", plain), ("overlapped", overlapped)] * (
                         N_AB // 2):
        torch.cuda.synchronize()
        t0 = time.time()
        recs = fn()
        times[name].append(time.time() - t0)
        lines[name] = [r.line() for r in recs]
    n = sum(len(b.names) for b in batches)
    med = {k: float(np.median(v)) for k, v in times.items()}
    print(f"[cli] overlap, {len(batches)} batches of {B} (A B B A x "
          f"{N_AB // 2}): overlapped loop "
          f"{', '.join(f'{t:.3f}' for t in times['overlapped'])} s, "
          f"map_batch loop {', '.join(f'{t:.3f}' for t in times['map_batch'])}"
          f" s; medians {med['overlapped']:.3f} against "
          f"{med['map_batch']:.3f} s ({n / med['overlapped']:.1f} against "
          f"{n / med['map_batch']:.1f} reads/s); records equal "
          f"{lines['overlapped'] == lines['map_batch']}; card {card}",
          flush=True)
    require(lines["overlapped"] == lines["map_batch"],
            "the overlapped loop's records differ from map_batch's")
    out["overlap_s"] = times
    tmp.cleanup()
    return out


# ---------------------------------------------------------------------------
# [cli] index: python -m nvbio_tpu_torch index in this process, on the card
# ---------------------------------------------------------------------------

QGROUP_Q = 16
# the --qgroup 16 leg's genome: its 4^16-key planes cost the same at any
# size, the sort, the .npz compression and the in-process check less
CLI_QGROUP_GENOME = 1_000_000


def write_fasta_codes(path, name, codes, width=100):
    """``codes`` as one FASTA record of lines of ``width`` bases."""
    chars = np.frombuffer(b"ACGT", np.uint8)[codes]
    full = len(chars) // width * width
    rows = np.concatenate([chars[:full].reshape(-1, width),
                           np.full((full // width, 1), ord("\n"), np.uint8)],
                          axis=1)
    with open(path, "wb") as f:
        f.write(f">{name}\n".encode() + rows.tobytes())
        if full < len(chars):
            f.write(chars[full:].tobytes() + b"\n")


def npz_equal(path, arrays: dict, label: str) -> None:
    """Every key of ``arrays`` in the .npz at ``path``, equal in dtype,
    shape and values, and no other key."""
    z = np.load(path)
    differ = [k for k in arrays
              if k not in z.files or z[k].dtype != np.asarray(arrays[k]).dtype
              or not np.array_equal(z[k], arrays[k])]
    require(not differ and set(z.files) == set(arrays),
            f"{label}: {path} differs from the in-process build in "
            f"{differ or sorted(set(z.files) ^ set(arrays))}")


def index_stages(log: str) -> str:
    found = re.findall(r"stages: (.*)", log)
    return found[-1] if found else ""


def phase_cli_index(genome, fm_host, card) -> dict:
    """The ``index`` app in this process on the card: the genome as a
    FASTA with ``--fmi`` (its .ref.npz and .fmi.npz equal to the
    in-process builds; the suffix sort on the card, as ``auto`` picks for
    2^22 bases or more on cuda; the q-gram table left out); its first
    CLI_CMP_GENOME bases with ``--fmi --bwt --bwt-lz4 --pac --no-qgram``
    (every artifact checked against the in-process builds) and with
    ``--bwt-blockwise``; its first CLI_QGROUP_GENOME bases with ``--qgroup
    16 --no-qgram`` (.qgroup.npz and .ref.npz checked), then ``map`` from
    that prefix (Q-Group seeding, q = 16) on cuda and on cpu: identical
    records."""
    import tempfile

    from nvbio_tpu_torch import packed
    from nvbio_tpu_torch.index.device_sa import build_fmindex_device
    from nvbio_tpu_torch.io.pac import load_bwt, load_pac
    from nvbio_tpu_torch.qgram import build_qgroup_index
    from nvbio_tpu_torch.utils.simgenome import write_fastq

    tmp = tempfile.TemporaryDirectory()

    def p(name):
        return f"{tmp.name}/{name}"

    def ref_arrays(codes, name):   # Reference.save of a genome without N
        return dict(names=np.array([name]),
                    offsets=np.array([0, len(codes)], np.int64), codes=codes,
                    n_mask_words=np.zeros((len(codes) + 31) // 32, np.uint32))

    out = {}
    t0 = time.time()
    write_fasta_codes(p("g.fa"), "sim100M", genome)
    t_fa = time.time() - t0
    secs, log = run_cli([p("g.fa"), p("g"), "--fmi", "--no-qgram",
                         *CLI_GPU_ARGS], "index")
    t0 = time.time()
    npz_equal(p("g.ref.npz"), ref_arrays(genome, "sim100M"), "index 100M")
    npz_equal(p("g.fmi.npz"), fm_host.arrays(), "index 100M")
    out["genome"] = dict(seconds=secs, fasta_s=t_fa, stages=index_stages(log),
                         check_s=time.time() - t0)
    print(f"[cli] index {len(genome)} bp --fmi --no-qgram: {secs:.2f} s end "
          f"to end (FASTA written in {t_fa:.2f} s); stages: "
          f"{out['genome']['stages']}; .ref.npz and .fmi.npz equal to the "
          f"in-process builds; card {card}", flush=True)

    small = genome[:CLI_CMP_GENOME]
    write_fasta_codes(p("h.fa"), "sim8M", small)
    secs, log = run_cli([p("h.fa"), p("h"), "--fmi", "--bwt", "--bwt-lz4",
                         "--pac", "--no-qgram", *CLI_GPU_ARGS], "index")
    t0 = time.time()
    fm = build_fmindex_device(small, device="cuda").arrays()
    npz_equal(p("h.fmi.npz"), fm, "index 8M")
    npz_equal(p("h.ref.npz"), ref_arrays(small, "sim8M"), "index 8M")
    bwt, primary, _ = load_bwt(p("h.bwt"))
    require(primary == int(fm["primary"]) and np.array_equal(
        bwt, packed.unpack(fm["bwt_words"], len(small), 2)),
        "index 8M: h.bwt differs from the FM index's BWT")
    require(np.array_equal(load_pac(p("h.pac")), small),
            "index 8M: h.pac differs from the genome")
    with open(p("h.bwt"), "rb") as f:
        require(f.read(4) == b"NB4\x01", "index 8M: h.bwt has no LZ4 magic")
    out["prefix"] = dict(seconds=secs, stages=index_stages(log),
                         check_s=time.time() - t0)
    print(f"[cli] index {len(small)} bp --fmi --bwt --bwt-lz4 --pac "
          f"--no-qgram: {secs:.2f} s end to end; stages: "
          f"{out['prefix']['stages']}; .fmi.npz, .ref.npz, .bwt (LZ4 "
          f"frames) and .pac equal to the in-process builds; card {card}",
          flush=True)
    secs, log = run_cli([p("h.fa"), p("hb"), "--no-qgram", "--bwt-blockwise",
                         "--bwt-lz4", *CLI_GPU_ARGS], "index")
    with open(p("h.bwt"), "rb") as f, open(p("hb.bwt"), "rb") as g:
        same = f.read() == g.read()
    out["blockwise"] = dict(seconds=secs, stages=index_stages(log))
    print(f"[cli] index {len(small)} bp --bwt-blockwise --bwt-lz4 "
          f"--no-qgram: {secs:.2f} s end to end; stages: "
          f"{out['blockwise']['stages']}; .bwt bytes "
          f"{'equal to' if same else 'DIFFERENT from'} the --fmi --bwt "
          f"run's; card {card}", flush=True)
    require(same, "cli index --bwt-blockwise: .bwt differs from --fmi --bwt")

    qsmall = genome[:CLI_QGROUP_GENOME]
    write_fasta_codes(p("k.fa"), "sim1M", qsmall)
    secs, log = run_cli([p("k.fa"), p("k"), "--qgroup", str(QGROUP_Q),
                         "--no-qgram", *CLI_GPU_ARGS], "index")
    t0 = time.time()
    npz_equal(p("k.ref.npz"), ref_arrays(qsmall, "sim1M"), "index 1M")
    qg = build_qgroup_index(qsmall, QGROUP_Q)
    npz_equal(p("k.qgroup.npz"), dict(
        q=np.asarray(QGROUP_Q), I=qg.I.numpy().view(np.uint32),
        S=qg.S.numpy(), SS=qg.SS.numpy(), P=qg.P.numpy(),
        n=np.asarray(len(qsmall))), "index 1M")
    del qg
    out["qgroup"] = dict(seconds=secs, stages=index_stages(log),
                         check_s=time.time() - t0)
    print(f"[cli] index {len(qsmall)} bp --qgroup {QGROUP_Q} --no-qgram: "
          f"{secs:.2f} s end to end; stages: {out['qgroup']['stages']}; "
          f".qgroup.npz and .ref.npz equal to the in-process builds "
          f"(checked in {out['qgroup']['check_s']:.2f} s); card {card}",
          flush=True)

    sb = head(read_batch(qsmall, SEED + 2100)[0])
    write_fastq(p("q.fq"), sb.names, sb.codes, sb.quals)
    sam = {}
    for run, dev_args in (("card", list(CLI_GPU_ARGS)),
                          ("host", ["--device", "cpu"])):
        reset_launches()
        secs, log = run_cli([p("k"), p("q.fq"), "-o", p(f"q_{run}.sam"),
                             *CLI_FLAGS, "--batch", str(N_CMP), *dev_args])
        if run == "card":
            cli_launches("cli qgroup", read_launches(),
                         {"banded_score_cands": 2, "banded_traceback": 1}, 1)
        with open(p(f"q_{run}.sam")) as f:
            sam[run] = ([ln for ln in f if not ln.startswith("@PG")], secs)
    (g, g_s), (c, c_s) = sam["card"], sam["host"]
    diff = sum(a != b for a, b in zip(g, c))
    recs = [ln.split("\t") for ln in g if not ln.startswith("@")]
    n_ok = sum(not int(r[1]) & 4 for r in recs)
    print(f"[gpu=cpu] cli qgroup (q = {QGROUP_Q}): {len(recs)} SAM records, "
          f"{diff} differ, {n_ok} mapped; cuda {g_s:.2f} s, cpu {c_s:.2f} s",
          flush=True)
    require(len(recs) == N_CMP and len(g) == len(c) and diff == 0,
            "cli qgroup: SAM records differ between cuda and cpu")
    require(n_ok >= 0.95 * N_CMP, f"cli qgroup: {n_ok} of {N_CMP} mapped")
    out["qgroup_map"] = dict(records=len(recs), mapped=n_ok, cuda_s=g_s,
                             cpu_s=c_s)
    tmp.cleanup()
    return out


N_CLI_SETBWT = 65536
SETBWT_OUTPUTS = ("npz", "txt", "lz4")


def phase_cli_setbwt(card) -> dict:
    """The ``setbwt`` app in this process: N_CLI_SETBWT reads of SETBWT_L
    bases with ``--incremental N_CLI_SETBWT --method device --txt --lz4``
    on cuda and on cpu; identical .setbwt.npz, .txt and .lz4 files."""
    import tempfile

    tmp = tempfile.TemporaryDirectory()
    reads = setbwt_reads(N_CLI_SETBWT, SEED + 3200)
    fq = f"{tmp.name}/s.fq"
    chars = np.frombuffer(b"ACGT", np.uint8)[reads]
    with open(fq, "wb") as f:
        for i, r in enumerate(chars):
            f.write(b"@s%d\n%s\n+\n%s\n" % (i, r.tobytes(),
                                                b"I" * SETBWT_L))
    out = {}
    for run, dev_args in (("card", list(CLI_GPU_ARGS)),
                          ("host", ["--device", "cpu"])):
        secs, _ = run_cli([fq, f"{tmp.name}/{run}", "--incremental",
                           str(N_CLI_SETBWT), "--method", "device", "--txt",
                           "--lz4", *dev_args], "setbwt")
        out[f"{run}_s"] = secs
    differ = []
    for ext in SETBWT_OUTPUTS:
        with open(f"{tmp.name}/card.setbwt.{ext}", "rb") as f, \
                open(f"{tmp.name}/host.setbwt.{ext}", "rb") as g:
            if f.read() != g.read():
                differ.append(ext)
    z = np.load(f"{tmp.name}/card.setbwt.npz")
    n_dollar = int((z["bwt"] == 0).sum())
    print(f"[cli] setbwt {N_CLI_SETBWT} reads of {SETBWT_L} bp "
          f"--incremental {N_CLI_SETBWT} --method device --txt --lz4: cuda "
          f"{out['card_s']:.2f} s, cpu {out['host_s']:.2f} s; "
          f"{len(z['bwt'])} symbols, {n_dollar} '$'; "
          f".setbwt.{'/.'.join(SETBWT_OUTPUTS)} "
          f"{'differ in ' + str(differ) if differ else 'equal'} on cuda and "
          f"on cpu; card {card}", flush=True)
    require(not differ and n_dollar == N_CLI_SETBWT,
            f"cli setbwt: outputs {differ} differ between cuda and cpu")
    tmp.cleanup()
    return out


# ---------------------------------------------------------------------------
# [mem], [correct], [sort] and the [cli] runs of mem, correct, sort, extract,
# aln-diff and serve
# ---------------------------------------------------------------------------

MEM_B, MEM_L, MEM_RL = 1024, 256, 150   # the app's batch and max_read_len
MEM_TAIL = 20                # a third of the reads end in 20 random bases
N_MEM_BATCHES = 8
N_MEM_CMP = 128              # GPU = CPU reads, on the genome's first 8 Mbp
CORRECT_GENOME = 4_600_000   # E. coli K-12's size
CORRECT_COV, CORRECT_RL = 30, 100
CORRECT_BATCH, CORRECT_BITS, CORRECT_K = 4096, 1 << 24, 17  # app defaults
CORRECT_BITS_SIZED = 1 << 27   # ~29 filter bits a genome k-mer
CORRECT_CMP_GENOME, N_CORRECT_CMP = 50_000, 10_000
N_SORT = 65536               # [sort]: the first two [main] batches' records
SORT_RUN = 8192              # 8 spilled runs and the merge
MEM_W = 33                   # MemParams().band: 2 * max_dist 16 + 1


def mem_batch(genome, seed, n):
    """n reads of MEM_RL bases (1% substitutions, sample_reads) padded to
    MEM_L; every third ends in MEM_TAIL random bases. Returns (batch,
    starts, is_rc, tailed)."""
    from nvbio_tpu_torch.io.fastq import ReadBatch
    from nvbio_tpu_torch.utils.simgenome import sample_reads

    reads, starts, is_rc = sample_reads(genome, n, MEM_RL, seed=seed,
                                        subst_rate=0.01)
    rng = np.random.default_rng(seed + 1)
    tailed = np.arange(n) % 3 == 0
    reads[tailed, MEM_RL - MEM_TAIL:] = rng.integers(
        0, 4, (int(tailed.sum()), MEM_TAIL))
    codes = np.zeros((n, MEM_L), np.uint8)
    codes[:, :MEM_RL] = reads
    quals = np.zeros((n, MEM_L), np.uint8)
    quals[:, :MEM_RL] = rng.integers(20, 41, (n, MEM_RL))
    names = [f"m{seed}_{i}" for i in range(n)]
    return (ReadBatch(names, codes, quals, np.full(n, MEM_RL, np.int32)),
            starts, is_rc, tailed)


def mem_truth(start, rc, tailed) -> int:
    """The first aligned base of a read's primary: a reverse read's tail is
    its genome-left end, clipped."""
    return int(start) + (MEM_TAIL if tailed and rc else 0)


def mem_placed(rec, start, rc, tailed, max_dist) -> bool:
    return (not rec.flag & 0x4 and bool(rec.flag & 0x10) == bool(rc)
            and abs(rec.pos - 1 - mem_truth(start, rc, tailed)) <= max_dist)


def phase_mem(genome, rep_genome, card, regs):
    """[mem]: the MemMapper (app defaults: batch 1024, max_read_len 256, -k
    19, -T 30, max_dist 16) on the 100 Mbp genome, the reversed genome's FM
    index built on the card: N_MEM_BATCHES batches of 150-base reads, a
    third tailed; K2-LOCAL launched exactly once a batch and nothing else;
    sensitivity >= 0.95, tailed reads soft-clipped >= 0.8; the SMEM stage
    alone (ms, device ops, share of the batch's device busy); host
    formatting's share of the wall; secondaries per read on the
    repeat-planted copy (> 0); GPU = CPU on 128 reads of the first 8 Mbp;
    and K2-LOCAL at this path's shape against its plain version, bit for
    bit (the kernel entry)."""
    from nvbio_tpu_torch.align import kernels as K
    from nvbio_tpu_torch.fmi.mem import find_smems_batch
    from nvbio_tpu_torch.io.reference import Reference
    from nvbio_tpu_torch.mem import MemMapper, MemParams
    from nvbio_tpu_torch.mem.pipeline import (
        both_strands,
        extension_inputs,
        kept_chains,
    )

    P = MemParams()
    W = P.band

    def ref_of(codes, name):
        return Reference([name], np.array([0, len(codes)], np.int64), codes,
                         np.zeros(0, np.uint32))

    t0 = time.time()
    mapper = MemMapper.build(ref_of(genome, "sim100M"), P, device="cuda")
    torch.cuda.synchronize()
    build_s = time.time() - t0
    batches = [mem_batch(genome, SEED + 2000 + i, MEM_B)
               for i in range(N_MEM_BATCHES)]
    out, t_dev, t_fmt, wall, launches = run_batches(
        mapper.dispatch, mapper.format_batch, [(b,) for b, *_ in batches])
    require_launches("mem", launches, {"banded_traceback": 1},
                     N_MEM_BATCHES)
    n = ok = tailed_n = clipped = 0
    for recs, (_, starts, is_rc, tailed) in zip(out, batches):
        prim = [r for r in recs if not r.flag & 0x100]
        require(len(prim) == MEM_B, f"mem: {len(prim)} primaries for "
                                    f"{MEM_B} reads")
        for rec, s, rc, tl in zip(prim, starts, is_rc, tailed):
            n += 1
            ok += mem_placed(rec, s, rc, tl, P.max_dist)
            if tl:
                tailed_n += 1
                clipped += "S" in rec.cigar
    sens, clip = ok / n, clipped / tailed_n
    fmt_share = sum(t_fmt) / wall
    print(f"[mem] reversed genome's FM index on the card in {build_s:.2f} s;"
          f" {n} reads of {MEM_RL} bp in {wall:.3f} s = {n / wall:.1f} "
          f"reads/s; per batch dispatch+sync s: "
          f"{', '.join(f'{x:.3f}' for x in t_dev)}; format s: "
          f"{', '.join(f'{x:.3f}' for x in t_fmt)} (host formatting "
          f"{100 * fmt_share:.1f}% of the wall); sensitivity {sens:.5f}; "
          f"tailed reads soft-clipped {clip:.5f}; launches "
          f"banded_traceback={launches['banded_traceback']} "
          f"({launches['banded_traceback'] / N_MEM_BATCHES:.0f} a batch); "
          f"card {card}", flush=True)
    require(sens >= 0.95, f"mem sensitivity {sens:.4f} < 0.95")
    require(clip >= 0.8, f"mem soft-clipped share {clip:.4f} < 0.8")
    stats = dict(reads=n, seconds=wall, reads_per_s=n / wall,
                 sensitivity=sens, clipped=clip, dispatch_s=sum(t_dev),
                 format_s=sum(t_fmt), format_share=fmt_share,
                 index_build_s=build_s,
                 k2_per_batch=launches["banded_traceback"] / N_MEM_BATCHES)

    # the SMEM stage of one batch alone, and the whole batch profiled
    b0 = batches[0][0]
    reads = torch.from_numpy(b0.codes.astype(np.int32)).cuda()
    lens = torch.from_numpy(b0.lengths).cuda()
    _, reads2, lens2 = both_strands(reads, lens)

    def smem_stage():
        return find_smems_batch(mapper.fmi_rev, reads2, lens2,
                                P.min_seed_len, P.max_smems,
                                P.hits_per_smem)

    stats["profile"] = phase_profile("mem", lambda: mapper.dispatch(b0))
    ms = cuda_ms(smem_stage, reps=3)
    ops, busy = device_ops(smem_stage)
    share = (None if stats["profile"] is None
             else busy / stats["profile"]["device_busy_ms"])
    print(f"[mem] SMEM stage of one batch (2 x {MEM_B} rows of {MEM_L}): "
          f"{ms:.3f} ms, {ops} device ops, device busy {busy:.3f} ms"
          + ("" if share is None else
             f" = {100 * share:.1f}% of the batch's device busy")
          + f"; card {card}", flush=True)
    stats["smem_stage"] = dict(ms=ms, device_ops=ops, device_busy_ms=busy,
                               share_of_batch_busy=share)
    stats["peak_bytes"] = peak_memory("mem", lambda: mapper.dispatch(b0))

    # K2-LOCAL at this path's shape: the batch's own extension lanes
    ch = kept_chains(mapper.fmi_rev, reads2, lens2, P)
    reads_f, lens_f, win, wlens, _ = extension_inputs(
        mapper.genome_words, mapper.n_genome, reads2, lens2, ch, P)
    args = (reads_f, lens_f, win, wlens, P.scoring, W)
    res = check_kernel("banded_traceback_mem", K.banded_traceback,
                       K.banded_traceback_plain, args,
                       local=True)
    nb = reads_f.shape[0]
    group = K.k2_group(nb, torch.cuda.get_device_properties(0)
                       .multi_processor_count, W)
    inst = f"banded_traceback_kernel<{W},{group},1>"
    cells = int(lens_f.long().sum()) * W
    steps = int(res["out"][3].long().sum())
    TW, MAXS = MEM_L + W - 1, (MEM_L + W + 7) // 8 * 8
    k2_ops = K2L_OPS_PER_CELL * cells + K2L_OPS_PER_STEP * steps
    # patterns and the mismatch plane the wrapper fills, windows, lengths,
    # the seven (B,) outputs and the op rows
    k2_bytes = (2 * nb * MEM_L * 4 + nb * TW * 4 + 2 * nb * 4 + 7 * nb * 4
                + nb * MAXS * 4)
    bms, by = bound_of(k2_ops, k2_bytes)
    r, spill = regs.get(inst, (None, None))
    entry = dict(
        name="banded_traceback_mem", route="cuda",
        source="nvbio_tpu_torch/csrc/banded_traceback.cu",
        replaces="nvbio_tpu/align/pallas_kernels.py:568",
        equal=res["equal"], max_abs_err=res["max_abs_err"], ms=res["ms"],
        ms_queued=res["ms_queued"], plain_ms=res["plain_ms"], bound_ms=bms,
        bound_by=by, library_ms=None,
        shape=f"K2-LOCAL (mem): B={nb} (2 strands x {MEM_B} reads x "
              f"{P.max_chains} chains) M={MEM_L} reads of {MEM_RL} W={W} "
              f"group={group}",
        instantiation=inst, registers=r, spill_bytes=spill)
    print(f"[kernels] {entry['shape']}: {cells} cells, "
          f"{steps} walk steps, {k2_ops:.4g} ops {k2_bytes:.4g} B; bound "
          f"{bms:.3f} ms ({by}); {inst} {r} registers, {spill} B spill; "
          f"card {card}", flush=True)
    del res["out"], args, reads_f, win
    stats["kernel_cells"], stats["kernel_walk_steps"] = cells, steps

    # secondaries on the repeat-planted copy (its own index)
    rep = MemMapper.build(ref_of(rep_genome, "sim100M_rep"), P,
                          device="cuda")
    rb = mem_batch(rep_genome, SEED + 2050, MEM_B)[0]
    recs = rep.map_batch(rb)
    n_sec = sum(bool(r.flag & 0x100) for r in recs)
    n_xa = sum("XA" in (r.tags or {}) for r in recs)
    print(f"[mem] repeat-planted genome: {MEM_B} reads, {n_sec} secondary "
          f"records ({n_sec / MEM_B:.4f} a read), {n_xa} primaries with XA",
          flush=True)
    require(n_sec > 0 and n_xa > 0, "mem: no secondary record on the "
                                    "repeat-planted genome")
    stats["secondaries_per_read"] = n_sec / MEM_B
    del rep

    # GPU = CPU on the first 8 Mbp (host SA-IS builds the cpu index)
    small = genome[:CLI_CMP_GENOME]
    sb = mem_batch(small, SEED + 2100, N_MEM_CMP)[0]
    gpu_small = MemMapper.build(ref_of(small, "sim8M"), P, device="cuda")
    t0 = time.time()
    cpu_small = MemMapper.build(ref_of(small, "sim8M"), P, device="cpu")
    print(f"[mem] cpu index of {CLI_CMP_GENOME} bp (host SA-IS) in "
          f"{time.time() - t0:.2f} s", flush=True)
    phase_gpu_equals_cpu("mem", lambda: gpu_small.map_batch(sb),
                         lambda: cpu_small.map_batch(sb))
    return stats, launches, entry


def bound_of(ops, nbytes) -> tuple[float, str]:
    """The larger of ``ops`` integer instructions over the card's issue
    ceiling and ``nbytes`` over HBM, in ms, and which one it is."""
    t_ops, t_bytes = ops / issue_per_s(), nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def correct_reads_set(n_genome, cov, seed):
    """Reads of CORRECT_RL bases at ``cov``x over a seeded genome, half
    reverse-complemented: (truth, reads with ~1% substitutions), uint8."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n_genome, dtype=np.uint8)
    n = n_genome * cov // CORRECT_RL
    starts = rng.integers(0, n_genome - CORRECT_RL, n)
    truth = g[starts[:, None] + np.arange(CORRECT_RL)]
    rc = rng.random(n) < 0.5
    truth[rc] = 3 - truth[rc, ::-1]
    reads = truth.copy()
    flat = reads.reshape(-1)
    k = int(rng.binomial(flat.size, 0.01))
    idx = rng.integers(0, flat.size, k)
    flat[idx] = (flat[idx] + rng.integers(1, 4, k).astype(np.uint8)) % 4
    return truth, reads


def correct_passes(reads, truth, bits, card) -> dict:
    """The three Lighter passes on the card over ``reads`` in batches of
    CORRECT_BATCH with two ``bits``-bit filters: seconds a pass, reads/s,
    both filters' occupancy, substituted bases before and after and bases
    newly broken, and the device ops of one correct batch."""
    from nvbio_tpu_torch.lighter import (
        LighterParams,
        correct_reads,
        mark_trusted,
        sample_kmers,
    )

    n = len(reads)
    params = LighterParams(k=CORRECT_K, bloom_bits_a=bits, bloom_bits_b=bits)
    padded = np.zeros((n, params.max_read_len), np.uint8)
    padded[:, :CORRECT_RL] = reads

    def batches():
        for i in range(0, n, CORRECT_BATCH):
            r = torch.from_numpy(padded[i:i + CORRECT_BATCH].astype(
                np.int32)).cuda()
            yield i, r, torch.full((r.shape[0],), CORRECT_RL,
                                   dtype=torch.int32, device="cuda")

    secs = {}
    torch.cuda.synchronize()
    t0 = time.time()
    bfa = torch.zeros(bits, dtype=torch.uint8, device="cuda")
    for i, r, ln in batches():
        bfa = sample_kmers(bfa, r, ln, i, params)
    torch.cuda.synchronize()
    secs["sample"] = time.time() - t0
    t0 = time.time()
    bfb = torch.zeros(bits, dtype=torch.uint8, device="cuda")
    for i, r, ln in batches():
        bfb = mark_trusted(bfa, bfb, r, ln, params)
    torch.cuda.synchronize()
    secs["trust"] = time.time() - t0
    t0 = time.time()
    corrected = np.empty_like(reads)
    for i, r, ln in batches():
        c, _ = correct_reads(bfb, r, ln, params)
        corrected[i:i + len(c)] = c[:, :CORRECT_RL].cpu().numpy()
    secs["correct"] = time.time() - t0
    total = sum(secs.values())
    occ_a = float(bfa.float().mean())
    occ_b = float(bfb.float().mean())
    before = int((reads != truth).sum())
    after = int((corrected != truth).sum())
    broken = int(((reads == truth) & (corrected != truth)).sum())
    _, r0, l0 = next(batches())
    ops, busy = device_ops(lambda: correct_reads(bfb, r0, l0, params))
    print(f"[correct] 2^{bits.bit_length() - 1}-bit filters: passes: sample "
          f"{secs['sample']:.3f} s, trust {secs['trust']:.3f} s, correct "
          f"{secs['correct']:.3f} s = {total:.3f} s, {n / total:.1f} "
          f"reads/s; filter occupancy A {occ_a:.5f}, B {occ_b:.5f}; "
          f"substituted bases {before} before, {after} after "
          f"({100 * (1 - after / before):.2f}% fewer), {broken} newly "
          f"broken; one correct batch of {CORRECT_BATCH}: {ops} device ops, "
          f"device busy {busy:.3f} ms; card {card}", flush=True)
    return dict(bloom_bits=bits, reads=n, pass_s=secs, seconds=total,
                reads_per_s=n / total, occupancy_a=occ_a,
                occupancy_b=occ_b, subst_before=before, subst_after=after,
                newly_broken=broken, correct_batch_ops=ops,
                correct_batch_busy_ms=busy)


def phase_correct(card):
    """[correct]: the three Lighter passes (sample, trust, correct) on the
    card over 1.38 M reads of 100 bp (a seeded 4.6 Mbp genome at 30x, 1%
    substitutions) in batches of 4096, k = 17, with the app's default
    2^24-bit filters (reported: they saturate at this genome size, and the
    algorithm then adds substitutions, as the JAX package's does,
    tests/test_torch_correct.py::test_filter_size_decides_the_outcome) and
    with CORRECT_BITS_SIZED-bit filters sized for the genome (fewer
    substituted bases after than before required); then the app
    (``correct``) on 10 k reads over 50 kbp on cuda and on cpu: identical
    FASTQ bytes."""
    import tempfile

    from nvbio_tpu_torch.utils.simgenome import write_fastq

    t0 = time.time()
    truth, reads = correct_reads_set(CORRECT_GENOME, CORRECT_COV, SEED + 3000)
    print(f"[correct] {len(reads)} reads of {CORRECT_RL} bp over "
          f"{CORRECT_GENOME} bp made in {time.time() - t0:.2f} s", flush=True)
    stats = dict(default=correct_passes(reads, truth, CORRECT_BITS, card),
                 sized=correct_passes(reads, truth, CORRECT_BITS_SIZED,
                                      card))
    sized = stats["sized"]
    require(sized["subst_after"] < sized["subst_before"],
            f"correct: {sized['subst_after']} substituted bases after "
            f"correction with 2^27-bit filters, {sized['subst_before']} "
            f"before")

    # GPU = CPU through the app: the corrected FASTQ's bytes
    tmp = tempfile.TemporaryDirectory()
    d = tmp.name
    _, small = correct_reads_set(CORRECT_CMP_GENOME, 40, SEED + 3100)
    small = small[:N_CORRECT_CMP]
    quals = np.random.default_rng(SEED + 3101).integers(
        2, 41, small.shape).astype(np.uint8)
    write_fastq(f"{d}/c.fq", [f"c{i}" for i in range(len(small))], small,
                quals)
    out = {}
    for run, dev_args in (("card", list(CLI_GPU_ARGS)),
                          ("host", ["--device", "cpu"])):
        s, _ = run_cli([f"{d}/c.fq", "-o", f"{d}/c_{run}.fq", "--bloom-bits",
                        str(CORRECT_BITS), *dev_args], "correct")
        with open(f"{d}/c_{run}.fq", "rb") as f:
            out[run] = (f.read(), s)
    same = out["card"][0] == out["host"][0]
    changed = sum(a != b for a, b in zip(
        out["card"][0].split(b"\n")[1::4],
        [r.tobytes() for r in np.frombuffer(b"ACGT", np.uint8)[small]]))
    print(f"[gpu=cpu] correct (the app): {len(small)} reads over "
          f"{CORRECT_CMP_GENOME} bp, corrected FASTQ {len(out['card'][0])} "
          f"bytes, identical {same}; {changed} reads changed; cuda "
          f"{out['card'][1]:.2f} s, cpu {out['host'][1]:.2f} s", flush=True)
    require(same, "correct: the FASTQ differs between cuda and cpu")
    require(changed > 0, "correct: the app corrected no read")
    stats["cli"] = dict(cuda_s=out["card"][1], cpu_s=out["host"][1],
                        reads_changed=changed)
    tmp.cleanup()
    return stats


def sorted_keys_ok(recs, names) -> bool:
    """(ref, pos) non-decreasing over SAM column lists, unmapped records
    (and RNAMEs outside ``names``) last."""
    rank = {nm: i for i, nm in enumerate(names)}
    keys = [(0x7FFFFFFF, 0) if int(r[1]) & 4 or r[2] not in rank
            else (rank[r[2]], int(r[3])) for r in recs]
    return keys == sorted(keys)


def phase_sort(records, card):
    """[sort]: the [main] path's single-end records coordinate-sorted from
    SAM to SAM on cuda, in one run and with run_size SORT_RUN (spilled
    runs and the k-way merge), each again on cpu: records/s, the device
    sorts' ms, identical files, (ref, pos) order with unmapped last."""
    import tempfile

    from nvbio_tpu_torch.io.bamsort import sort_alignments
    from nvbio_tpu_torch.io.output import open_alignment_output
    from nvbio_tpu_torch.io.sam import read_sam

    tmp = tempfile.TemporaryDirectory()
    d = tmp.name
    t0 = time.time()
    with open_alignment_output(f"{d}/in.sam", ["sim100M"],
                               [GENOME_LEN]) as w:
        for r in records:
            w.write(r)
    n = len(records)
    print(f"[sort] {n} records written as SAM in {time.time() - t0:.2f} s",
          flush=True)
    stats = {}
    for run_size in (max(n, 262_144), SORT_RUN):
        files, st = {}, {}
        for run, dev in (("card", "cuda"), ("host", "cpu")):
            st[run] = {}
            t0 = time.time()
            got = sort_alignments(f"{d}/in.sam", f"{d}/{run}.sam", run_size,
                                  tmp_dir=d, device=dev, stats=st[run])
            st[run]["seconds"] = time.time() - t0
            require(got == n, f"sort: {got} records of {n}")
            with open(f"{d}/{run}.sam", "rb") as f:
                files[run] = f.read()
        _, recs = read_sam(f"{d}/card.sam")
        ordered = sorted_keys_ok(recs, ["sim100M"])
        s = st["card"]
        print(f"[sort] run_size {run_size}: {s['runs']} runs; cuda "
              f"{s['seconds']:.3f} s = {n / s['seconds']:.1f} records/s, "
              f"device sorts {1e3 * s['sort_s']:.3f} ms; cpu "
              f"{st['host']['seconds']:.3f} s (its sorts "
              f"{1e3 * st['host']['sort_s']:.3f} ms); same order cuda and "
              f"cpu {files['card'] == files['host']}; (ref, pos) order "
              f"{ordered}; card {card}", flush=True)
        require(files["card"] == files["host"],
                f"sort run_size {run_size}: cuda and cpu orders differ")
        require(ordered and len(recs) == n,
                f"sort run_size {run_size}: records out of order")
        require(s["runs"] == -(-n // run_size),
                f"sort: {s['runs']} runs at run_size {run_size}")
        stats[str(run_size)] = dict(runs=s["runs"], seconds=s["seconds"],
                                    records_per_s=n / s["seconds"],
                                    device_sort_ms=1e3 * s["sort_s"],
                                    cpu_seconds=st["host"]["seconds"])
    tmp.cleanup()
    return stats


def phase_cli_apps(genome, card) -> dict:
    """The new commands through the app's main on the card, on the genome's
    first CLI_CMP_GENOME bases: ``mem`` (a FASTA of them, 1024 reads with
    the truth in each name, to BAM: one K2-LOCAL launch, sensitivity >=
    0.95), ``sort`` of that BAM on cuda and on cpu (equal records, sorted),
    ``extract --rc`` of the FASTQ (every line the read's reverse
    complement), ``aln-diff --json`` of the BAM against itself (every
    record matches) and ``serve`` on a thread over a .ref.npz/.fmi.npz
    prefix (PING, LIST, GET; FMClient.get's FMIndex equal to the
    .fmi.npz's)."""
    import contextlib
    import io
    import os
    import shutil
    import tempfile
    import threading

    from nvbio_tpu_torch.__main__ import main as app_main
    from nvbio_tpu_torch.apps import server_app
    from nvbio_tpu_torch.fmi.index import FMIndex
    from nvbio_tpu_torch.index.device_sa import build_fmindex_device
    from nvbio_tpu_torch.io.bam import read_bam
    from nvbio_tpu_torch.io.reference import Reference
    from nvbio_tpu_torch.io.server import FMClient
    from nvbio_tpu_torch.utils.simgenome import write_fastq

    tmp = tempfile.TemporaryDirectory()
    d = tmp.name

    def p(name):
        return f"{d}/{name}"

    out = {}
    small = genome[:CLI_CMP_GENOME]
    write_fasta_codes(p("m.fa"), "sim8M", small)
    b, starts, is_rc, tailed = mem_batch(small, SEED + 2200, N_CMP)
    names = [f"m{j}_{mem_truth(s, rc, tl)}_{int(rc)}" for j, (s, rc, tl) in
             enumerate(zip(starts.tolist(), is_rc.tolist(),
                           tailed.tolist()))]
    write_fastq(p("m.fq"), names, b.codes[:, :MEM_RL], b.quals[:, :MEM_RL])

    reset_launches()
    secs, _ = run_cli([p("m.fa"), p("m.fq"), "-o", p("m.bam"),
                       *CLI_GPU_ARGS], "mem")
    got = read_launches()
    require(got == {k: int(k == "banded_traceback") for k in got},
            f"cli mem: launches {got}, expected one K2-LOCAL")
    _, recs = read_bam(p("m.bam"))
    prim = [r for r in recs if not int(r[1]) & 0x100]
    ok = sum(not int(r[1]) & 4 and bool(int(r[1]) & 0x10) == bool(
        int(r[0].split("_")[2])) and abs(int(r[3]) - 1 - int(
            r[0].split("_")[1])) <= 16 for r in prim)
    sens = ok / len(prim)
    print(f"[cli] mem: {N_CMP} reads of {MEM_RL} bp on {CLI_CMP_GENOME} bp "
          f"to BAM in {secs:.2f} s (FASTA parse and the card's index "
          f"build included); {len(recs)} records, sensitivity {sens:.5f}; "
          f"card {card}", flush=True)
    require(len(prim) == N_CMP and sens >= 0.95,
            f"cli mem: {len(prim)} primaries, sensitivity {sens:.4f}")
    out["mem"] = dict(seconds=secs, records=len(recs), sensitivity=sens)

    sorted_recs = {}
    for run, dev_args in (("card", list(CLI_GPU_ARGS)),
                          ("host", ["--device", "cpu"])):
        s, _ = run_cli([p("m.bam"), p(f"s_{run}.bam"), *dev_args], "sort")
        sorted_recs[run] = (read_bam(p(f"s_{run}.bam"))[1], s)
    (sg, sg_s), (sc, sc_s) = sorted_recs["card"], sorted_recs["host"]
    print(f"[cli] sort of the BAM: {len(sg)} records, cuda {sg_s:.2f} s, "
          f"cpu {sc_s:.2f} s, equal {sg == sc}", flush=True)
    require(sg == sc and len(sg) == len(recs)
            and sorted_keys_ok(sg, ["sim8M"]),
            "cli sort: records differ between cuda and cpu or out of order")
    out["sort"] = dict(cuda_s=sg_s, cpu_s=sc_s)

    s, _ = run_cli([p("m.fq"), "-o", p("m_rc.txt"), "--rc"], "extract")
    with open(p("m_rc.txt")) as f:
        lines = f.read().splitlines()
    want = ["".join("TGCA"[c] for c in row[::-1])
            for row in b.codes[:, :MEM_RL]]
    print(f"[cli] extract --rc: {len(lines)} lines in {s:.2f} s, equal to "
          f"the reverse complements {lines == want}", flush=True)
    require(lines == want, "cli extract --rc: lines differ")

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        s, _ = run_cli([p("m.bam"), p("m.bam"), "--json"], "aln-diff")
    diff = json.loads(buf.getvalue())
    agree = all(diff[k] == diff["both_mapped"] for k in
                ("same_pos", "same_strand", "same_cigar", "same_mapq"))
    print(f"[cli] aln-diff --json of the mem BAM against itself in "
          f"{s:.2f} s: {diff['n_common']} common, {diff['both_mapped']} "
          f"both mapped, all agree {agree}", flush=True)
    require(agree and diff["n_common"] == N_CMP
            and diff["only_left"] == diff["only_right"] == 0,
            f"cli aln-diff: {diff}")

    # serve: a .ref.npz + .fmi.npz prefix, the app's server on a thread
    Reference(["sim8M"], np.array([0, len(small)], np.int64), small).save(
        p("hs.ref.npz"))
    build_fmindex_device(small, device="cuda").save(p("hs.fmi.npz"))
    short = tempfile.mkdtemp(prefix="nvbt")
    sock = os.path.join(short, "fm.sock")
    if len(sock) > 100:   # AF_UNIX paths end at 108 bytes
        sock = os.path.relpath(sock)
    th = threading.Thread(target=app_main, daemon=True, args=(
        ["serve", p("hs"), "--dir", p("hs.shared"), "--socket", sock],))
    t0 = time.time()
    th.start()
    while server_app.current is None or not os.path.exists(sock):
        require(th.is_alive() and time.time() - t0 < 120,
                "cli serve: the server did not start")
        time.sleep(0.05)
    try:
        client = FMClient(sock, p("hs.shared"))
        pong, listed = client.ping(), client.list()
        meta = json.loads(client._request("GET fmindex"))
        got = client.get("fmindex", FMIndex)
        want = FMIndex.load(p("hs.fmi.npz"))
        same = all(
            torch.equal(getattr(got, f), v) if isinstance(v, torch.Tensor)
            else getattr(got, f) == v for f, v in vars(want).items())
    finally:
        server_app.current.stop()
        th.join(timeout=30)
        shutil.rmtree(short, ignore_errors=True)
    print(f"[cli] serve: up in {time.time() - t0:.2f} s; PING {pong}, LIST "
          f"{listed}, GET fmindex {sorted(meta['fields'])}; FMClient.get "
          f"FMIndex equal to the .fmi.npz load {same}", flush=True)
    require(pong and listed == ["fmindex", "reference"] and same
            and meta["type"] == "FMIndex" and not th.is_alive(),
            "cli serve: the server's answers or index differ")
    out["serve_s"] = time.time() - t0
    tmp.cleanup()
    return out


# ---------------------------------------------------------------------------
# [assemble]: a micro-assembly batch through map, sort and assemble; and
# [fm-library]: the FM library's searches, the suffix trie, the q-gram set
# index and the protein FM index on the card against the same on the host
# ---------------------------------------------------------------------------

ASM_GENOME = 100_000         # one contig
ASM_SNP_EVERY = 400          # a SNP about every 400 bp on the second haplotype
ASM_COVERAGE = 30            # 100-base reads, half from each haplotype
ASM_REGIONS = 256            # a HaplotypeCaller-style batch of 200-bp regions
ASM_REGION_SIZE = 200
ASM_K = 15                   # the app's default -k
ASM_RECOVERED = 0.9          # SNPs whose region emits both haplotypes


def asm_dataset(seed):
    """(reference, second haplotype, SNP positions, reads, quals, names):
    the second haplotype carries a SNP about every ASM_SNP_EVERY bases;
    reads of L bases at ASM_COVERAGE x, half from each haplotype, with 1%
    substitutions, half reverse-complemented, Phred 20-40."""
    from nvbio_tpu_torch.utils.simgenome import sample_reads

    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, ASM_GENOME, dtype=np.uint8)
    grid = np.arange(ASM_SNP_EVERY // 2, ASM_GENOME - ASM_SNP_EVERY // 2,
                     ASM_SNP_EVERY)
    snps = grid + rng.integers(-150, 150, len(grid))
    alt = ref.copy()
    alt[snps] = (ref[snps] + rng.integers(1, 4, len(snps))) % 4
    half = ASM_GENOME * ASM_COVERAGE // L // 2
    reads = np.concatenate([sample_reads(h, half, L, seed=seed + i)[0]
                            for i, h in enumerate((ref, alt))])
    quals = rng.integers(20, 41, reads.shape).astype(np.uint8)
    names = [f"a{i}" for i in range(len(reads))]
    return ref, alt, snps, reads.astype(np.uint8), quals, names


def fasta_haplotypes(path) -> dict:
    """{region: [haplotype strings]} of an ``assemble`` FASTA."""
    out: dict = {}
    with open(path) as f:
        lines = f.read().splitlines()
    for head_line, seq in zip(lines[::2], lines[1::2]):
        r = int(re.match(r">region(\d+)_", head_line).group(1))
        out.setdefault(r, []).append(seq)
    return out


def snp_recovery(ref, alt, snps, haps) -> tuple[int, int]:
    """(SNPs at least ASM_K bases inside a region's ends, of them those
    whose region emitted both the reference haplotype and the variant one:
    the reference with every such SNP of the region substituted)."""
    from nvbio_tpu_torch.alphabet import codes_to_string

    counted = recovered = 0
    for r in range(ASM_REGIONS):
        lo, hi = r * ASM_REGION_SIZE, (r + 1) * ASM_REGION_SIZE
        inner = snps[(snps >= lo + ASM_K) & (snps < hi - ASM_K)]
        if not len(inner):
            continue
        var = ref[lo:hi].copy()
        var[inner - lo] = alt[inner]
        got = set(haps.get(r, []))
        ok = codes_to_string(ref[lo:hi]) in got and \
            codes_to_string(var) in got
        counted += len(inner)
        recovered += len(inner) * ok
    return counted, recovered


def phase_assemble(card) -> dict:
    """A user's micro-assembly batch through the three commands in this
    process: ``map`` (cuda) of ~30 k reads of a two-haplotype 100 kbp
    contig to SAM, ``sort`` (cuda), then ``assemble --regions 256
    --region-size 200 --support`` on cuda and on cpu: equal FASTA bytes;
    reads, rows, nodes, edges, cyclic regions and haplotypes; the seconds of
    each of the app's stages (timed around its calls in the cuda run) and
    the k-mer scan's ms on the card; SNPs at least k bases inside a region
    recovered as both haplotypes >= ASM_RECOVERED."""
    import tempfile

    from nvbio_tpu_torch import assembly
    from nvbio_tpu_torch.assembly import graph as agraph
    from nvbio_tpu_torch.utils.simgenome import write_fastq

    t_phase = time.time()
    tmp = tempfile.TemporaryDirectory()

    def p(name):
        return f"{tmp.name}/{name}"

    ref, alt, snps, reads, quals, names = asm_dataset(SEED + 3100)
    write_fasta_codes(p("asm.fa"), "asm100k", ref)
    write_fastq(p("asm.fq"), names, reads, quals)
    out = dict(reads=len(reads), snps=len(snps))
    out["map_s"], _ = run_cli([p("asm.fa"), p("asm.fq"), "-o", p("m.sam"),
                               "--batch", str(B), "--max-read-len", str(L),
                               *CLI_GPU_ARGS])
    with open(p("m.sam")) as f:
        recs = [ln.split("\t", 3) for ln in f if not ln.startswith("@")]
    out["mapped"] = sum(not int(r[1]) & 4 for r in recs) / len(recs)
    out["sort_s"], _ = run_cli([p("m.sam"), p("s.sam"), *CLI_GPU_ARGS],
                               "sort")
    args = [p("asm.fa"), p("s.sam"), "--regions", str(ASM_REGIONS),
            "--region-size", str(ASM_REGION_SIZE), "-k", str(ASM_K),
            "--support"]

    # the cuda run, each stage timed around the app's own call
    stages, kept = {}, {}
    real = {n: getattr(assembly, n) for n in (
        "load_active_regions", "build_debruijn_graph", "k_best_haplotypes",
        "haplotype_support")}

    def timed(name):
        def call(*a, **kw):
            t0 = time.time()
            res = real[name](*a, **kw)
            stages[name] = time.time() - t0
            kept[name] = res
            return res
        return call

    for n in real:
        setattr(assembly, n, timed(n))
    try:
        out["card_s"], _ = run_cli([*args, "-o", p("h_card.fa"),
                                    *CLI_GPU_ARGS], "assemble")
    finally:
        for n, fn in real.items():
            setattr(assembly, n, fn)
    out["host_s"], _ = run_cli([*args, "-o", p("h_host.fa"), "--device",
                                "cpu"], "assemble")
    with open(p("h_card.fa"), "rb") as f, open(p("h_host.fa"), "rb") as g:
        card_fa, host_fa = f.read(), g.read()
    _, codes, lengths, rid, is_ref, q = kept["load_active_regions"]
    graph = kept["build_debruijn_graph"]
    haps = fasta_haplotypes(p("h_card.fa"))
    counted, recovered = snp_recovery(ref, alt, snps, haps)
    q = np.where(is_ref[:, None], np.uint8(0xFF), q)
    out["scan_ms"] = cuda_ms(lambda: agraph._kmer_scan(
        codes, lengths, q, ASM_K, 6, "cuda"), reps=5)
    out["scan_ops"], out["scan_busy_ms"] = device_ops(
        lambda: agraph._kmer_scan(codes, lengths, q, ASM_K, 6, "cuda"))
    n_assigned = sum(int((s.best_hap >= 0).sum())
                     for s in kept["haplotype_support"] if s is not None)
    out.update(rows=len(codes), nodes=graph.n_nodes, edges=graph.n_edges,
               cyclic=int(graph.cycle_flags.sum()),
               haplotypes=sum(len(h) for h in haps.values()),
               assigned=n_assigned, snps_counted=counted,
               snps_recovered=recovered,
               recovery=recovered / max(counted, 1),
               stages_s=stages, equal=card_fa == host_fa)
    out["phase_s"] = time.time() - t_phase
    print(f"[assemble] {len(reads)} reads ({100 * out['mapped']:.2f}% "
          f"mapped, map {out['map_s']:.2f} s, sort {out['sort_s']:.2f} s); "
          f"{ASM_REGIONS} regions of {ASM_REGION_SIZE} bp: {len(codes)} rows, "
          f"{graph.n_nodes} nodes, {graph.n_edges} edges, {out['cyclic']} "
          f"cyclic, {out['haplotypes']} haplotypes, {n_assigned} reads "
          f"assigned; k-mer scan {out['scan_ms']:.3f} ms on the card "
          f"({out['scan_ops']} device ops, busy {out['scan_busy_ms']:.3f} "
          f"ms); stages (s): " + ", ".join(
              f"{k} {v:.3f}" for k, v in stages.items())
          + f"; the app {out['card_s']:.2f} s on cuda, {out['host_s']:.2f} s "
          f"on cpu, FASTA {'equal' if out['equal'] else 'DIFFERENT'}; SNPs "
          f">= {ASM_K} bases inside a region: {recovered} of {counted} "
          f"recovered as both haplotypes ({out['recovery']:.4f}); phase "
          f"{out['phase_s']:.1f} s; card {card}", flush=True)
    require(out["mapped"] >= 0.95, f"assemble: {out['mapped']} mapped")
    require(out["equal"], "assemble: FASTA bytes differ between cuda and cpu")
    require(out["recovery"] >= ASM_RECOVERED and counted > 0,
            f"assemble: {recovered} of {counted} SNPs recovered")
    tmp.cleanup()
    return out


N_MM_SEEDS = 1024            # search_1mm: L * 3 + 1 searches a seed
N_LIB_SEEDS = 8192
LIB_SEED_L = 22
N_LIB_CMP = 256              # of them also searched on the host index
KMM_K, KMM_STATES = 2, 32
TRIE_TEXT = 256 * 1024       # the suffix trie's text: the genome's start
TRIE_DEPTH = 10
N_SET_READS = 65536          # QGramSetIndex over reads of L bases
SET_Q, SET_STRIDE = 15, 5
PROT_N = 4 << 20             # protein residues: a multiple of 32
N_PROT_QUERIES = 8192
PROT_L = 9
N_PROT_SCAN = 64             # queries also counted by a numpy scan


def same_intervals(lo, hi, want) -> bool:
    """Equal where ``want``'s interval is nonempty, empty alike: an empty
    pattern's bounds are not defined (the card's index has the k-mer
    table, whose empty intervals are (0, 0); an extension steps on past an
    empty one)."""
    lo, hi = lo.cpu(), hi.cpu()
    wlo, whi = (w.cpu() for w in want)
    ne = whi > wlo
    return bool(torch.equal(hi > lo, ne) and torch.equal(lo[ne], wlo[ne])
                and torch.equal(hi[ne], whi[ne]))


def phase_fm_library(genome, fm_cpu, fm_gpu, card) -> dict:
    """The FM library on the card against the host: search_1mm over
    N_MM_SEEDS seeds of 22 bases, search_1mm_hybrid and search_kmm (k = 2,
    32 states) over N_LIB_SEEDS on the 100 Mbp index (the first N_LIB_CMP
    also on the cpu index: equal); extend_backward / extend_forward of the
    same seeds symbol by symbol with the reversed genome's index built on
    the card, each equal to a plain backward search on its side; a
    SuffixTrie of the genome's first 256 kbp at depth 10 on cuda and cpu
    (equal arrays and walks); a QGramSetIndex of 65536 reads at q = 15,
    stride 5 (range and locate equal); a protein FM index of 4 Mi residues
    (counts of 8192 queries of 9 equal, and equal to a numpy scan for 64).
    ms a call (CUDA events) and device ops of each."""
    from nvbio_tpu_torch import qgram, trie
    from nvbio_tpu_torch.fmi import bidir, protein
    from nvbio_tpu_torch.fmi import search as S
    from nvbio_tpu_torch.index.device_sa import build_fmindex_device

    t_phase = time.time()
    rng = np.random.default_rng(SEED + 3300)
    starts = rng.integers(0, len(genome) - LIB_SEED_L, N_LIB_SEEDS)
    seeds = genome[starts[:, None] + np.arange(LIB_SEED_L)].astype(np.int64)
    for n_mm, rows in ((1, slice(0, None, 3)), (2, slice(1, None, 3))):
        cols = rng.integers(0, LIB_SEED_L, (len(seeds[rows]), n_mm))
        sub = seeds[rows]
        np.put_along_axis(sub, cols, (np.take_along_axis(sub, cols, 1)
                                      + rng.integers(1, 4, cols.shape)) % 4,
                          1)
        seeds[rows] = sub
    q = torch.from_numpy(seeds)
    ql = torch.full((N_LIB_SEEDS,), LIB_SEED_L, dtype=torch.int64)
    qg, qlg = q.cuda(), ql.cuda()
    qc, qlc = q[:N_LIB_CMP], ql[:N_LIB_CMP]
    out = {}

    def timed(name, fn, n, **extra):
        ms = cuda_ms(fn, reps=5)
        ops, busy = device_ops(fn)
        out[name] = dict(n=n, ms=ms, device_ops=ops, device_busy_ms=busy,
                         **extra)
        print(f"[fm-library] {name} ({n}): {ms:.3f} ms a call, {ops} device "
              f"ops, device busy {busy:.3f} ms"
              + "".join(f", {k} {v}" for k, v in extra.items())
              + f"; card {card}", flush=True)

    m = N_MM_SEEDS
    got = S.search_1mm(fm_gpu, qg[:m], qlg[:m])
    want = S.search_1mm(fm_cpu, qc, qlc)
    c = N_LIB_CMP
    require(same_intervals(got[0][:c], got[1][:c], want[:2])
            and same_intervals(got[2][:c], got[3][:c], want[2:4])
            and torch.equal(got[4][:c].cpu(), want[4]),
            "fm-library: search_1mm differs between cuda and cpu")
    timed("search_1mm", lambda: S.search_1mm(fm_gpu, qg[:m], qlg[:m]), m,
          nonempty_branches=int((got[3] > got[2]).sum()))

    A = (LIB_SEED_L + 1) // 2
    got = S.search_1mm_hybrid(fm_gpu, qg, qlg, A)
    want = S.search_1mm_hybrid(fm_cpu, qc, qlc, A)
    require(all(torch.equal(a[:c].cpu(), b) for a, b in zip(got, want)),
            "fm-library: search_1mm_hybrid differs between cuda and cpu")
    timed("search_1mm_hybrid", lambda: S.search_1mm_hybrid(fm_gpu, qg, qlg,
                                                           A), N_LIB_SEEDS,
          nonempty_branches=int((got[3] > got[2]).sum()))

    want_exact = S.backward_search_core(fm_gpu.without_ftab(), qg, qlg)
    got = S.search_kmm(fm_gpu, qg, qlg, KMM_K, KMM_STATES)
    want = S.search_kmm(fm_cpu, qc, qlc, KMM_K, KMM_STATES)
    require(all(torch.equal(a[:c].cpu(), b) for a, b in zip(got, want)),
            "fm-library: search_kmm differs between cuda and cpu")
    # the beam is mismatch-sorted: an exact seed's exact interval is slot 0
    exact = slice(2, None, 3)
    require(bool(got[3][exact, 0].all()) and not got[2][exact, 0].any()
            and torch.equal(got[0][exact, 0], want_exact[0][exact])
            and torch.equal(got[1][exact, 0], want_exact[1][exact]),
            "fm-library: search_kmm lost an exact seed's interval")
    found = [int(got[3][rows].any(dim=1).sum()) for rows in
             (slice(0, None, 3), slice(1, None, 3), exact)]
    timed("search_kmm", lambda: S.search_kmm(fm_gpu, qg, qlg, KMM_K,
                                             KMM_STATES), N_LIB_SEEDS,
          found_1mm_2mm_exact=found,
          full_beams=int(got[3].all(dim=1).sum()))

    t0 = time.time()
    rev = build_fmindex_device(genome[::-1].copy(), device="cuda")
    torch.cuda.synchronize()
    out["reverse_index_s"] = time.time() - t0
    fwd = fm_gpu.without_ftab()
    want_f = S.backward_search_core(fwd, qg, qlg)
    want_r = S.backward_search_core(rev, qg.flip(1), qlg)

    def grow(f, r, qq, backward):
        iv = bidir.init_interval(f, (qq.shape[0],))
        order = range(LIB_SEED_L - 1, -1, -1) if backward else \
            range(LIB_SEED_L)
        ext = bidir.extend_backward if backward else bidir.extend_forward
        for j in order:
            iv = ext(f, r, *iv, qq[:, j])
        return iv

    rev_cpu = rev.to("cpu")
    for name, backward in (("extend_backward", True),
                           ("extend_forward", False)):
        iv = grow(fm_gpu, rev, qg, backward)
        require(same_intervals(iv[0], iv[1], want_f)
                and same_intervals(iv[2], iv[3], want_r),
                f"fm-library: {name} differs from backward search")
        host = grow(fm_cpu, rev_cpu, qc, backward)
        require(all(torch.equal(a[:c].cpu(), b) for a, b in zip(iv, host)),
                f"fm-library: {name} differs between cuda and cpu")
        timed(name, lambda b=backward: grow(fm_gpu, rev, qg, b), N_LIB_SEEDS,
              steps=LIB_SEED_L)
    del rev, rev_cpu

    text = genome[:TRIE_TEXT]
    t0 = time.time()
    tg = trie.SuffixTrie.build(text, max_depth=TRIE_DEPTH, device="cuda")
    t_card = time.time() - t0
    t0 = time.time()
    tc = trie.SuffixTrie.build(text, max_depth=TRIE_DEPTH, device="cpu")
    t_host = time.time() - t0
    same = all(np.array_equal(getattr(tg, f.name), getattr(tc, f.name))
               for f in dataclasses.fields(tg))
    wq = torch.from_numpy(seeds[:, :TRIE_DEPTH + 2].copy())
    wl = torch.full((N_LIB_SEEDS,), TRIE_DEPTH + 2)
    walk_g = tg.walk(wq.cuda(), wl.cuda())
    walk_c = tc.walk(wq, wl)
    same_walk = all(torch.equal(a.cpu(), b) for a, b in zip(walk_g, walk_c))
    out["suffix_trie"] = dict(text=TRIE_TEXT, depth=TRIE_DEPTH,
                              nodes=len(tg.count), card_s=t_card,
                              host_s=t_host, equal=same and same_walk)
    print(f"[fm-library] SuffixTrie of {TRIE_TEXT} bp at depth {TRIE_DEPTH}: "
          f"{len(tg.count)} nodes, built in {t_card:.2f} s (cuda) and "
          f"{t_host:.2f} s (cpu), arrays and {N_LIB_SEEDS} walks "
          f"{'equal' if same and same_walk else 'DIFFERENT'}", flush=True)
    require(same and same_walk, "fm-library: SuffixTrie differs")

    sreads, _, _ = read_batch(genome, SEED + 3400)
    sr = np.concatenate([sreads.codes, read_batch(genome, SEED + 3401)[
        0].codes])[:N_SET_READS]
    sr[::97, 40] = 4                                   # N windows
    t0 = time.time()
    si = qgram.build_qgram_set_index(sr, np.full(len(sr), L), SET_Q,
                                     SET_STRIDE)
    t_build = time.time() - t0
    sig = si.to("cuda")
    keys = qgram.seed_keys_from_batch(torch.from_numpy(
        sr[:, 5:5 + SET_Q].astype(np.int32)), SET_Q)
    keys[1::2] = torch.from_numpy(rng.integers(0, 4 ** SET_Q,
                                               len(keys) // 2))
    kg = keys.cuda()
    rg = qgram.set_index_range(sig, kg)
    rc = qgram.set_index_range(si, keys)
    lg = qgram.set_index_locate(sig, rg[0])
    lc = qgram.set_index_locate(si, rc[0])
    require(all(torch.equal(a.cpu(), b) for a, b in zip((*rg, *lg),
                                                         (*rc, *lc))),
            "fm-library: QGramSetIndex range or locate differs")
    hits = int((rc[1] > rc[0]).sum())
    require(bool((lc[1][::2][rc[1][::2] > rc[0][::2]] % SET_STRIDE
                  == 0).all()), "fm-library: located q-grams off the stride")
    timed("set_index_range", lambda: qgram.set_index_range(sig, kg),
          len(keys), hits=hits, build_s=round(t_build, 3),
          qgrams=int(si.qgrams.shape[0]), max_probe=si.max_probe)
    timed("set_index_locate", lambda: qgram.set_index_locate(sig, rg[0]),
          len(keys))

    ptext = rng.integers(0, 24, PROT_N, dtype=np.uint8)
    t0 = time.time()
    pf = protein.build_protein_fmindex(ptext)
    t_pbuild = time.time() - t0
    pg = pf.to("cuda")
    pq = ptext[rng.integers(0, PROT_N - PROT_L, N_PROT_QUERIES)[:, None]
               + np.arange(PROT_L)]
    pq[1::2] = rng.integers(0, 24, (N_PROT_QUERIES // 2, PROT_L))
    pqt = torch.from_numpy(pq.astype(np.int64))
    pl = torch.full((N_PROT_QUERIES,), PROT_L)
    cnt_g = protein.protein_count(pg, pqt.cuda(), pl.cuda()).cpu()
    cnt_c = protein.protein_count(pf, pqt, pl)
    w24 = 24 ** np.arange(PROT_L - 1, -1, -1, dtype=np.int64)
    win = np.lib.stride_tricks.sliding_window_view(ptext, PROT_L)
    all_keys = np.sort(win.astype(np.int64) @ w24)
    qk = pq[:N_PROT_SCAN].astype(np.int64) @ w24
    scan = (np.searchsorted(all_keys, qk, side="right")
            - np.searchsorted(all_keys, qk))
    require(torch.equal(cnt_g, cnt_c)
            and np.array_equal(cnt_c[:N_PROT_SCAN].numpy(), scan),
            "fm-library: protein counts differ (cuda, cpu, numpy scan)")
    timed("protein_count", lambda: protein.protein_count(
        pg, pqt.cuda(), pl.cuda()), N_PROT_QUERIES,
          residues=PROT_N, build_s=round(t_pbuild, 3),
          found=int((cnt_c > 0).sum()))
    out["phase_s"] = time.time() - t_phase
    print(f"[fm-library] every result equal on cuda and cpu; reversed index "
          f"on the card {out['reverse_index_s']:.2f} s; phase "
          f"{out['phase_s']:.1f} s; card {card}", flush=True)
    return out


# [surface]: the package-level names, gather_symbols, rank2
SURFACE_NAMES = {
    "": {"Alphabet": "alphabet"},
    "bowtie": {"MapParams": "bowtie.params",
               "ReadMapper": "bowtie.pipeline"},
    "fmi": {"FMIndex": "fmi.index", "build_fmindex": "fmi.index",
            "rank": "fmi.rank", "rank2": "fmi.rank",
            "backward_search": "fmi.search", "locate_batch": "fmi.search"},
    "index": {"suffix_array": "index.sa"},
    "io": {"read_fasta": "io.fasta", "write_fasta": "io.fasta",
           "read_fastq": "io.fastq", "fastq_batches": "io.fastq",
           "Reference": "io.reference", "SamWriter": "io.sam",
           "BamReader": "io.bam", "BamWriter": "io.bam",
           "open_alignment_output": "io.output",
           "read_alignments": "io.output", "SNPDatabase": "io.vcf",
           "load_vcf": "io.vcf"},
    "utils": {"log_debug": "utils.console", "log_error": "utils.console",
              "log_info": "utils.console", "log_stats": "utils.console",
              "log_verbose": "utils.console", "log_visible": "utils.console",
              "set_verbosity": "utils.console", "Timer": "utils.timers"},
}
N_SURFACE = 1 << 20          # gather_symbols positions, rank2 triples


def phase_surface(host_words, words, fm_cpu, fm_gpu, card) -> dict:
    """The public surface on the card: package-level names, gather_symbols
    and PackedArray on the genome's words and rank2 on the FM rank rows,
    each equal to its reference (GPU = CPU)."""
    import importlib

    from nvbio_tpu_torch.fmi.rank import rank, rank2
    from nvbio_tpu_torch.packed import PackedArray, gather_symbols, unpack

    t_phase = time.time()
    out = {}
    n_names = 0
    for pkg, names in SURFACE_NAMES.items():
        mod = importlib.import_module(
            "nvbio_tpu_torch" + (f".{pkg}" if pkg else ""))
        for name, home in names.items():
            want = getattr(importlib.import_module(
                f"nvbio_tpu_torch.{home}"), name)
            require(getattr(mod, name) is want,
                    f"surface: {pkg or 'nvbio_tpu_torch'}.{name} is not "
                    f"{home}.{name}")
            n_names += 1
    out["names"] = n_names

    rng = np.random.default_rng(SEED + 3400)
    n = GENOME_LEN
    idx = rng.integers(0, n, N_SURFACE)
    idx[:2] = 0, n - 1
    got = gather_symbols(words, torch.from_numpy(idx).cuda(), 2)
    require(got.is_cuda and got.dtype == torch.int32,
            "surface: gather_symbols left the card or int32")
    codes = unpack(host_words, n, 2)
    require(np.array_equal(got.cpu().numpy(), codes[idx].astype(np.int32))
            and torch.equal(got.cpu(), gather_symbols(
                words.cpu(), torch.from_numpy(idx), 2)),
            "surface: gather_symbols differs from unpack or the cpu copy")
    pa = PackedArray(host_words, n, 2).to("cuda")
    require(pa.words.is_cuda and np.array_equal(pa.to_codes(), codes),
            "surface: PackedArray through .to('cuda') lost symbols")
    out["gather_symbols_n"] = N_SURFACE
    print(f"[surface] {n_names} package-level names are their modules'; "
          f"gather_symbols of {N_SURFACE} positions equal to unpack and the "
          f"cpu copy; PackedArray of {n} symbols round-trips; card {card}",
          flush=True)

    nr = fm_gpu.n
    a, b = rng.integers(0, nr + 1, (2, N_SURFACE))
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    lo[:3], hi[:3] = (0, 0, nr), (0, nr, nr)
    c = torch.from_numpy(rng.integers(0, 4, N_SURFACE))
    lo, hi = torch.from_numpy(lo), torch.from_numpy(hi)
    cg, lo_g, hi_g = c.cuda(), lo.cuda(), hi.cuda()
    rlo, rhi = rank2(fm_gpu.rank_rows, cg, lo_g, hi_g)
    clo, chi = rank2(fm_cpu.rank_rows, c, lo, hi)
    require(torch.equal(rlo, rank(fm_gpu.rank_rows, cg, lo_g))
            and torch.equal(rhi, rank(fm_gpu.rank_rows, cg, hi_g))
            and torch.equal(rlo.cpu(), clo) and torch.equal(rhi.cpu(), chi),
            "surface: rank2 differs from rank on the card or from the cpu")
    out["rank2_n"] = N_SURFACE
    print(f"[surface] rank2 of {N_SURFACE} triples on the {nr} bp index "
          f"equal to two rank calls and to the cpu rows; card {card}",
          flush=True)
    out["phase_s"] = time.time() - t_phase
    print(f"[surface] phase {out['phase_s']:.1f} s; card {card}", flush=True)
    return out


# ---------------------------------------------------------------------------
# The scan route (extension="scan": the aligner library's engine, no kernel)
# and the aligner library at realistic sizes
# ---------------------------------------------------------------------------

N_SCAN_CMP = 512             # GPU = CPU reads (pairs) of each scan path
N_ALN = 32768                # library calls: pairs a call
N_ALN_CMP = 256              # of them also run on the CPU
ALN_TB = L + W - 1           # the banded calls' text: 130
PROT_ALN_B, PROT_ALN_M, PROT_ALN_N = 4096, 256, 512
PROT_GAP_OPEN, PROT_GAP_EXT = -5, -3   # examples/proteinsw's gaps


def records_differ(a, b) -> int:
    """Reads whose records differ between two record lists (grouped by read
    name, so --all's differing record counts are one read each)."""
    ga, gb = by_read(a), by_read(b)
    return sum([r.line() for r in ga[n]] != [r.line() for r in gb.get(n, [])]
               for n in ga)


def phase_scan(genome, rep_genome, ref, rep_ref, index, rep_index, kernel,
               params, local_params, card) -> dict:
    """[scan]: one batch of B reads (pairs) of each of SE, PE (5% seedless
    mates, rescued by the full-matrix wavefront over the maxins + band =
    531 window), local, paired-full and --all (the repeat copy) with
    extension="scan" on cuda, through the phases of the kernel route with
    its sensitivity limits and no kernel launched; per batch the seconds,
    torch ops (``torch_ops``) and peak device memory of one more dispatch;
    the reads whose records differ from the kernel route's on the same
    batch (``kernel``: the records of each path's first batch, the same
    seed), reported only; GPU = CPU SAM records on the first N_SCAN_CMP
    reads (pairs)."""
    from nvbio_tpu_torch.bowtie.paired import (
        dispatch_pair_batch,
        map_pair_batch,
    )
    from nvbio_tpu_torch.bowtie.pipeline import ReadMapper

    def scan(prm):
        return dataclasses.replace(prm, extension="scan")

    def build(r, prm, idx, dev):
        return ReadMapper.build(r, scan(prm), index=idx, device=dev)

    cpu_index, cpu_rep = index.to("cpu"), rep_index.to("cpu")
    full = dataclasses.replace(params, pe_full_traceback=True)
    out = {}
    for path in ("se", "pe", "local", "paired-full", "all"):
        label = f"scan-{path}"
        recs = []
        t0 = time.time()
        if path == "se":
            gm, batch, _, stats = phase_main_path(
                genome, ref, index, scan(params), card, label=label,
                n_batches=1, records=recs, per_batch={})
            cm = build(ref, params, cpu_index, "cpu")
            inputs = (batch,)
        elif path == "pe":
            gm = build(ref, params, index, "cuda")
            pair, _, stats = phase_paired(genome, gm, card, label=label,
                                          n_batches=1, per_batch={},
                                          records=recs)
            cm = build(ref, params, cpu_index, "cpu")
            inputs = tuple(pair)
        elif path == "local":
            gm = build(ref, local_params, index, "cuda")
            batch, _, stats = phase_local(genome, gm, card, label=label,
                                          n_batches=1, per_batch={},
                                          records=recs)
            cm = build(ref, local_params, cpu_index, "cpu")
            inputs = (batch,)
        elif path == "paired-full":
            gm = build(ref, full, index, "cuda")
            pair, _, stats = phase_paired_full(genome, gm, label, SEED + 600,
                                               {}, card, records=recs)
            cm = build(ref, full, cpu_index, "cpu")
            inputs = tuple(pair)
        else:
            gm = build(rep_ref, params, rep_index, "cuda")
            batch, _, stats = phase_all(rep_genome, gm, card, label=label,
                                        per_batch={}, records=recs)
            cm = build(rep_ref, params, cpu_rep, "cpu")
            inputs = (batch,)
        dispatch, mapped = {
            "pe": (dispatch_pair_batch, map_pair_batch),
            "paired-full": (dispatch_pair_batch, map_pair_batch),
            "all": (ReadMapper.dispatch_all, ReadMapper.map_batch_all),
        }.get(path, (ReadMapper.dispatch, ReadMapper.map_batch))
        counts = []

        def dispatch_counted():
            res, n = torch_ops(lambda: dispatch(gm, *inputs))
            counts.append(n)
            return res
        stats["peak_bytes"] = peak_memory(label, dispatch_counted)
        ops = stats["torch_ops"] = counts[0]
        n_diff = records_differ(recs, kernel[path])
        stats["reads_differing_from_kernel_route"] = n_diff
        small = tuple(head(b, N_SCAN_CMP) for b in inputs)
        phase_gpu_equals_cpu(label, lambda: mapped(gm, *small),
                             lambda: mapped(cm, *small),
                             secondaries=path == "all")
        stats["phase_s"] = time.time() - t0
        print(f"[scan] {path}: dispatch+sync {stats['dispatch_s']:.3f} s, "
              f"format {stats['format_s']:.3f} s a batch of {B}; "
              f"{ops} torch ops; peak "
              f"{stats['peak_bytes'] / 1e6:.1f} MB; {n_diff} of {B} reads "
              f"(pairs) with records unlike the kernel route's; phase "
              f"{stats['phase_s']:.1f} s; card {card}", flush=True)
        out[path] = stats
    return out


def library_call(label, fn, lanes, cells, card, **fixed) -> dict:
    """One aligner-library call on the card, ``fn(**lanes, **fixed)``
    (``lanes``: the per-lane tensors by name): ms (one timed call after the
    first), GCUPS (``cells`` / time), and the same call on the CPU over the
    first N_ALN_CMP lanes, every output equal, its torch ops counted
    (``torch_ops``; the op sequence does not depend on the lane count; a
    full-matrix call counts 2 ops more on the card)."""
    got = fn(**lanes, **fixed)
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: fn(**lanes, **fixed), reps=1, warm=False)
    cpu_lanes = {k: v[:N_ALN_CMP].cpu() for k, v in lanes.items()}
    cpu_fixed = {k: v.cpu() if isinstance(v, torch.Tensor) else v
                 for k, v in fixed.items()}
    want, ops = torch_ops(lambda: fn(**cpu_lanes, **cpu_fixed))
    equal = all(torch.equal(g[:N_ALN_CMP].cpu(), w)
                for g, w in zip(got, want))
    gcups = cells / (ms * 1e-3) / 1e9
    print(f"[aligner] {label}: {ms:.3f} ms, {ops} torch ops, {gcups:.3f} "
          f"GCUPS ({cells} cells); cuda = cpu on {N_ALN_CMP} lanes: "
          f"{equal}; card {card}", flush=True)
    require(equal, f"[aligner] {label}: cuda and cpu differ")
    return dict(ms=ms, torch_ops=ops, gcups=gcups, cells=cells)


def phase_aligner(genome, card) -> dict:
    """[aligner]: the aligner library on the card at realistic sizes —
    ED, SW and Gotoh x GLOBAL, SEMI_GLOBAL, LOCAL full-matrix over N_ALN
    pairs of L x RW (reads against their mate-rescue-sized windows), the
    banded Gotoh score (three types) and traceback (SEMI_GLOBAL, LOCAL)
    at W over N_ALN x (L, L + W - 1), the XLA Myers over N_ALN x (L, RW),
    Gotoh LOCAL + BLOSUM62 over PROT_ALN_B pairs of PROT_ALN_M x
    PROT_ALN_N residues (proteinsw's gaps); each via ``library_call``."""
    from nvbio_tpu_torch.align import (
        GLOBAL,
        LOCAL,
        SEMI_GLOBAL,
        batch_score_banded,
        batch_score_full,
        batch_traceback_banded,
        make_edit_distance_aligner,
        make_gotoh_aligner,
        make_smith_waterman_aligner,
    )
    from nvbio_tpu_torch.align.myers import myers_semiglobal
    from nvbio_tpu_torch.align.scoring import BLOSUM62
    from nvbio_tpu_torch.bowtie.params import MapParams

    t_phase = time.time()
    rng = np.random.default_rng(SEED + 1400)
    dev = torch.device("cuda")
    n = len(genome)
    pats, starts = make_reads(genome, N_ALN, rng)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
    # each read inside a window of RW at a random offset, a few cut short
    w0 = np.clip(starts - rng.integers(0, RW - L - 2 * MAX_DIST, N_ALN), 0,
                 n - RW)
    texts = genome[w0[:, None] + np.arange(RW)]
    tlens = np.full(N_ALN, RW, np.int32)
    tlens[:64] = rng.integers(L, RW, 64)
    full = dict(patterns=t(pats), pattern_lens=t(np.full(N_ALN, L)),
                texts=t(texts), text_lens=t(tlens))
    sc = MapParams().scoring
    out = {}
    for kind, make in (("ed", lambda ty: make_edit_distance_aligner(ty)),
                       ("sw", lambda ty: make_smith_waterman_aligner(ty)),
                       ("gotoh", lambda ty: make_gotoh_aligner(ty, sc))):
        for ty in (GLOBAL, SEMI_GLOBAL, LOCAL):
            out[f"full-{kind}-{ty.name}"] = library_call(
                f"batch_score_full {kind} {ty.name} {N_ALN} x {L} x {RW}",
                batch_score_full, full, N_ALN * L * RW, card,
                aligner=make(ty))
    # banded: the read's own window from max_dist before its start
    bw0 = np.clip(starts - MAX_DIST, 0, n - ALN_TB)
    btexts = genome[bw0[:, None] + np.arange(ALN_TB)]
    banded = dict(full, texts=t(btexts), text_lens=t(np.full(N_ALN, ALN_TB)),
                  mismatch_scores=t(-(2 + (4 * rng.integers(
                      2, 41, size=(N_ALN, L))) // 40)))
    for ty in (GLOBAL, SEMI_GLOBAL, LOCAL):
        out[f"banded-{ty.name}"] = library_call(
            f"batch_score_banded gotoh {ty.name} W={W} {N_ALN} x {L}",
            batch_score_banded, banded, N_ALN * L * W, card,
            aligner=make_gotoh_aligner(ty, sc), band=W)
    for ty in (SEMI_GLOBAL, LOCAL):
        out[f"traceback-{ty.name}"] = library_call(
            f"batch_traceback_banded gotoh {ty.name} W={W} {N_ALN} x {L}",
            batch_traceback_banded, banded, N_ALN * L * W, card,
            aligner=make_gotoh_aligner(ty, sc), band=W)
    out["myers"] = library_call(
        f"myers_semiglobal {N_ALN} x {L} x {RW}", myers_semiglobal, full,
        N_ALN * L * RW, card)
    # protein: random residues, a third of the queries planted in their text
    prng = np.random.default_rng(SEED + 1500)
    ppats = prng.integers(0, 24, size=(PROT_ALN_B, PROT_ALN_M))
    ptexts = prng.integers(0, 24, size=(PROT_ALN_B, PROT_ALN_N))
    k = PROT_ALN_B // 3
    ptexts[:k, 100:100 + PROT_ALN_M] = ppats[:k]
    prot = make_gotoh_aligner(LOCAL, type(sc)(
        0, 0, PROT_GAP_OPEN, PROT_GAP_EXT, PROT_GAP_OPEN, PROT_GAP_EXT))
    out["protein-local-blosum62"] = library_call(
        f"batch_score_full gotoh LOCAL BLOSUM62 {PROT_ALN_B} x {PROT_ALN_M} "
        f"x {PROT_ALN_N}", batch_score_full,
        dict(patterns=t(ppats), pattern_lens=t(np.full(PROT_ALN_B,
                                                       PROT_ALN_M)),
             texts=t(ptexts), text_lens=t(np.full(PROT_ALN_B, PROT_ALN_N))),
        PROT_ALN_B * PROT_ALN_M * PROT_ALN_N, card, aligner=prot,
        subst_matrix=torch.as_tensor(BLOSUM62, device=dev))
    out["phase_s"] = time.time() - t_phase
    print(f"[aligner] phase {out['phase_s']:.1f} s; card {card}", flush=True)
    return out


N_DIST_CMP = 1024            # [dist]: GPU = CPU reads through a gloo group
N_DIST_CLI_BATCHES = 2       # [dist]: the SE batches map --dist maps


def free_port() -> int:
    """A free localhost TCP port for a process group's rendezvous."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_step(mesh, label, run, fmt, per_batch, card, n_reads) -> tuple:
    """One batch through a sharded step on ``mesh``: its seconds (dispatch
    + sync, every rank starting together), the launches of the kernel
    wrappers in it (``per_batch`` each, as on the unsharded path), the
    peak device memory of a second run, and its records (``fmt(res)``)."""
    from nvbio_tpu_torch.parallel.mesh import all_reduce_sum

    # every rank starts the timed step together, the group's communicator
    # made: a rank's time would otherwise hold its wait for the slowest
    # rank's host work before the step (the step's collectives wait)
    all_reduce_sum(mesh, torch.zeros(1, device=mesh.device))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    res = run()
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = read_launches()
    require_launches(f"dist {label}", launches, per_batch, 1)
    peak = peak_memory(f"dist {label}", run)
    recs = fmt(res)
    print(f"[dist] {label}: {n_reads} reads a rank in {dt:.3f} s "
          f"({n_reads / dt:.1f} reads/s a rank); launches {launches}; "
          f"peak {peak / 1e9:.3f} GB; card {card}", flush=True)
    return res, recs, dict(seconds=dt, reads_per_s=n_reads / dt,
                           launches=launches, peak_bytes=peak)


def unmapped_names(recs) -> set:
    return {r.qname for r in recs if r.flag & 0x4}


def dist_legs(mesh, genome, ref, index, fm_index, params, fm_params, card,
              rank=0) -> dict:
    """The sharded steps on ``mesh`` (each rank its own batch of B reads,
    or pairs): single-end with ``shard_qgram_index`` and with
    ``shard_fmindex(method="device", resident=True)``, the replicated
    paired and --all steps, and ``dryrun_multichip``. Each against the
    unsharded ReadMapper on the same batch: the replicated steps' records
    equal; the sharded steps' records equal for every read mapped by the
    first pass (the reseed pass of a sharded index differs by design:
    ROADMAP section 3), the others counted."""
    from nvbio_tpu_torch.bowtie.paired import format_pair_batch, \
        map_pair_batch
    from nvbio_tpu_torch.bowtie.pipeline import ReadMapper
    from nvbio_tpu_torch.fmi.sharded import place_sharded_fmindex, \
        shard_fmindex
    from nvbio_tpu_torch.parallel.dryrun import dryrun_multichip
    from nvbio_tpu_torch.parallel.mesh import (
        sharded_align_step,
        sharded_all_step,
        sharded_paired_step,
    )
    from nvbio_tpu_torch.parallel.sharded_index import (
        place_sharded_index,
        shard_qgram_index,
    )

    D, dev = mesh.size, mesh.device
    out = dict(world=D)
    t0 = time.time()
    sq_host = shard_qgram_index(index, D)
    sq = place_sharded_index(mesh, sq_host)
    torch.cuda.synchronize()
    out["qgram_shard_s"] = time.time() - t0
    slices = []
    t0 = time.time()
    sf_all = shard_fmindex(genome, D, method="device", resident=True,
                           device=dev, on_slice=lambda d, s: slices.append(s))
    sf = place_sharded_fmindex(mesh, sf_all)
    torch.cuda.synchronize()
    out["fm_shard_s"] = time.time() - t0
    print(f"[dist] rank {rank}/{D} on {dev}: q-gram shards in "
          f"{out['qgram_shard_s']:.2f} s ({sq.positions.numel()} positions "
          f"here); FM slices of {sf.slice_len} + {sf.overlap} bp built on "
          f"the card in {out['fm_shard_s']:.2f} s (s a slice: "
          f"{', '.join(f'{s:.3f}' for s in slices)}), "
          f"{sf.nbytes() / 1e6:.1f} MB here", flush=True)

    def mapper(prm, idx):
        return ReadMapper.build(ref, prm, index=idx, device=dev)

    base, base_fm = mapper(params, index), mapper(fm_params, fm_index)
    first = {"qgram": mapper(dataclasses.replace(params, max_reseed=0),
                             base.index),
             "fmi": mapper(dataclasses.replace(fm_params, max_reseed=0),
                           base_fm.index)}
    batch = read_batch(genome, SEED + 1900 + rank)[0]
    tens = base.batch_tensors(batch)
    for name, sidx, prm, ref_mapper in (("qgram", sq, params, base),
                                        ("fmi", sf, fm_params, base_fm)):
        step = sharded_align_step(mesh, prm, index_sharded=True)
        _, recs, st = dist_step(
            mesh, f"se-sharded-{name}",
            lambda: step(sidx, base.genome_words, base.n_genome, *tens)[0],
            lambda res: base.format_batch(batch, res), SE_LAUNCHES, card, B)
        want = ref_mapper.map_batch(batch)
        second = unmapped_names(first[name].map_batch(batch))
        differ = {a.qname for a, b in zip(recs, want) if a.line() != b.line()}
        st.update(differ=len(differ), reseeded=len(second),
                  mapped=sum(not r.flag & 4 for r in recs) / B)
        print(f"[dist] se-sharded-{name}: {len(differ)} reads' records "
              f"differ from the unsharded mapper's, all among the "
              f"{len(second)} the first pass leaves unmapped: "
              f"{differ <= second}; mapped {st['mapped']:.5f}", flush=True)
        require(len(recs) == len(want) == B and differ <= second,
                f"dist se-sharded-{name}: records differ outside the "
                f"reseed pass")
        require(st["mapped"] >= 0.95, f"dist se-sharded-{name}: mapped "
                                      f"{st['mapped']:.4f}")
        out[f"se_sharded_{name}"] = st

    (p1, p2), *_ = pair_batches(genome, SEED + 1950 + rank)
    pstep = sharded_paired_step(mesh, params)
    _, recs, st = dist_step(
        mesh, "paired-replicated",
        lambda: pstep(base.index, base.genome_words, base.n_genome,
                      *base.batch_tensors(p1), *base.batch_tensors(p2))[:3],
        lambda res: format_pair_batch(base, p1, p2, res), PE_LAUNCHES,
        card, B)
    want = map_pair_batch(base, p1, p2)
    require([r.line() for r in recs] == [r.line() for r in want],
            "dist paired-replicated: records differ from map_pair_batch's")
    out["paired_replicated"] = st

    ab = read_batch(genome, SEED + 1980 + rank)[0]
    astep = sharded_all_step(mesh, params)
    _, recs, st = dist_step(
        mesh, "all-replicated",
        lambda: astep(base.index, base.genome_words, base.n_genome,
                      *base.batch_tensors(ab))[0],
        lambda res: base.format_batch_all(ab, res), ALL_LAUNCHES, card, B)
    require([r.line() for r in recs] ==
            [r.line() for r in base.map_batch_all(ab)],
            "dist all-replicated: records differ from map_batch_all's")
    out["all_replicated"] = st
    t0 = time.time()
    out["dryrun"] = dryrun_multichip(mesh)
    print(f"[dist] dryrun_multichip({D}) in {time.time() - t0:.2f} s: "
          f"{out['dryrun']}", flush=True)
    out["sharded"] = dict(qgram=sq_host, fmi=sf_all, batch=batch,
                          words=base.genome_words, base=base)
    return out


def dist_cli(genome, mapper, card) -> dict:
    """``map --dist --num-processes 2``: two processes on this card over
    gloo, each mapping its stripe of N_DIST_CLI_BATCHES SE batches on the
    genome's .pac; the merged SAM against the single-process records in
    stripe order (rank 0's batches, then rank 1's)."""
    import os
    import tempfile

    from nvbio_tpu_torch.io.pac import save_reference_pac
    from nvbio_tpu_torch.io.reference import Reference
    from nvbio_tpu_torch.utils.simgenome import write_fastq

    tmp = tempfile.TemporaryDirectory()
    d = tmp.name
    save_reference_pac(Reference(mapper.ref_names, mapper.ref_offsets,
                                 genome), f"{d}/g")
    se = [read_batch(genome, SEED + 2000 + i)[0]
          for i in range(N_DIST_CLI_BATCHES)]
    write_fastq(f"{d}/se.fq", [n for b in se for n in b.names],
                np.concatenate([b.codes for b in se]),
                np.concatenate([b.quals for b in se]))
    repo = os.path.dirname(os.path.abspath(__file__))
    coord = f"127.0.0.1:{free_port()}"
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "nvbio_tpu_torch", "map", f"{d}/g",
         f"{d}/se.fq", "-o", f"{d}/dist.sam", *CLI_FLAGS, *CLI_GPU_ARGS,
         "--dist", "--coordinator", coord, "--num-processes", "2",
         "--process-id", str(r)], cwd=repo,
        env={**os.environ, "PYTHONPATH": repo}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    want = [r.line() for rank in range(2) for b in se[rank::2]
            for r in mapper.map_batch(b)]
    logs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=600)
        finally:
            p.kill()
        logs.append(err)
        for line in err.splitlines():
            print(f"[dist]   cli: {line}", flush=True)
        require(p.returncode == 0, f"map --dist exited {p.returncode}")
    dt = time.time() - t0
    with open(f"{d}/dist.sam") as f:
        got = [ln.rstrip("\n") for ln in f if not ln.startswith("@")]
    shards = [n for n in os.listdir(d) if ".shard" in n]
    print(f"[dist] map --dist, 2 processes on one card over gloo: "
          f"{len(got)} records in {dt:.2f} s end to end (reference load, "
          f"index, gauge included); equal to the single-process records in "
          f"stripe order: {got == want}; shards left {shards}; card {card}",
          flush=True)
    bad = [(a, b) for a, b in zip(got, want) if a != b]
    require(not bad and len(got) == len(want) == N_DIST_CLI_BATCHES * B,
            f"map --dist: {len(bad)} merged records differ from the "
            f"single-process run's in stripe order, first {bad[:1]}")
    require(not shards and "merged 2 SAM shards" in logs[0],
            "map --dist: the shards were not merged and removed")
    tmp.cleanup()
    return dict(seconds=dt, records=len(got))


def phase_dist(genome, ref, index, fm_index, params, fm_params, mapper,
               card) -> dict:
    """The sharded steps over NCCL at world = 1 in this process (a card a
    rank: more cards take ``--dist-cards``), GPU = CPU through a gloo
    group of the same rank, and map --dist with two processes on the
    card."""
    import torch.distributed as dist

    from nvbio_tpu_torch.bowtie.pipeline import ReadMapper
    from nvbio_tpu_torch.fmi.sharded import place_sharded_fmindex
    from nvbio_tpu_torch.parallel.dist import init_distributed
    from nvbio_tpu_torch.parallel.mesh import make_reads_mesh, \
        sharded_align_step
    from nvbio_tpu_torch.parallel.sharded_index import place_sharded_index

    n = torch.cuda.device_count()
    print(f"[dist] the legs at D = 2 and 4 need more than one card (run "
          f"python3 chip_smoke.py --dist-cards 2 4 on a machine with 4): "
          f"this process runs D = 1 on 1 of {n}", flush=True)
    require(init_distributed(f"127.0.0.1:{free_port()}", 1, 0,
                             backend="nccl"), "no NCCL group")
    try:
        mesh = make_reads_mesh(None, "cuda:0")
        out = dist_legs(mesh, genome, ref, index, fm_index, params,
                        fm_params, card)
        sh = out.pop("sharded")
        # the same rank through a gloo group, on the CPU
        mesh_cpu = make_reads_mesh(dist.new_group(backend="gloo"), "cpu")
        small = head(sh["batch"], N_DIST_CMP)
        words_cpu = sh["words"].cpu()
        fmt = sh["base"]
        cpu_fmt = ReadMapper(index=None, genome_words=words_cpu,
                             n_genome=fmt.n_genome, ref_names=fmt.ref_names,
                             ref_offsets=fmt.ref_offsets, params=params,
                             device=torch.device("cpu"))
        for name, prm, gpu_idx, cpu_idx in (
                ("qgram", params, place_sharded_index(mesh, sh["qgram"]),
                 place_sharded_index(mesh_cpu, sh["qgram"])),
                ("fmi", fm_params, place_sharded_fmindex(mesh, sh["fmi"]),
                 place_sharded_fmindex(mesh_cpu, sh["fmi"]))):
            gstep = sharded_align_step(mesh, prm, index_sharded=True)
            cstep = sharded_align_step(mesh_cpu, prm, index_sharded=True)
            phase_gpu_equals_cpu(
                f"dist se-sharded-{name}",
                lambda: fmt.format_batch(small, gstep(
                    gpu_idx, fmt.genome_words, fmt.n_genome,
                    *fmt.batch_tensors(small))[0]),
                lambda: cpu_fmt.format_batch(small, cstep(
                    cpu_idx, words_cpu, fmt.n_genome,
                    *cpu_fmt.batch_tensors(small))[0]), N_DIST_CMP)
        del sh
    finally:
        dist.destroy_process_group()
    out["cli"] = dist_cli(genome, mapper, card)
    return out


def dist_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    """One spawned rank of ``--dist-cards``: the NCCL group, its card
    (``cuda:<rank>``), the operating point's genome and indexes built
    here, and ``dist_legs``; writes ``dist_<world>_<rank>.json``."""
    import torch.distributed as dist

    from nvbio_tpu_torch.index.device_sa import build_fmindex_device
    from nvbio_tpu_torch.io.reference import Reference
    from nvbio_tpu_torch.parallel.dist import init_distributed
    from nvbio_tpu_torch.parallel.mesh import make_reads_mesh
    from nvbio_tpu_torch.qgram import build_qgram_index

    card = smi("name,power.limit")
    torch.cuda.set_device(rank)   # the synchronizes and memory counters
    init_distributed(f"127.0.0.1:{port}", world, rank, backend="nccl")
    try:
        mesh = make_reads_mesh(None, f"cuda:{rank}")
        genome = np.random.default_rng(SEED).integers(
            0, 4, size=GENOME_LEN, dtype=np.uint8)
        ref = Reference(["sim100M"], np.array([0, GENOME_LEN], np.int64),
                        genome, np.zeros(0, np.uint32))
        params, fm_params = map_params()
        index = build_qgram_index(genome, params.qgram_q)
        fm = build_fmindex_device(genome, device=mesh.device)
        out = dist_legs(mesh, genome, ref, index, fm, params, fm_params,
                        card, rank)
        out.pop("sharded")
        out["card"] = card
        with open(f"{out_dir}/dist_{world}_{rank}.json", "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def dist_cards_main(worlds) -> int:
    """``python3 chip_smoke.py --dist-cards N [N ...]``: the [dist] step
    legs at each world size N as N spawned ranks, one card each (N at
    most the machine's cards); per world the slowest rank's seconds a
    batch and the aggregate reads/s."""
    import tempfile

    import torch.multiprocessing as mp

    from nvbio_tpu_torch.align import kernels as K

    n = torch.cuda.device_count()
    require(all(1 <= w <= n for w in worlds),
            f"--dist-cards {worlds} on a machine with {n} cards")
    card = smi("name,power.limit")
    K.build()
    summary = {}
    with tempfile.TemporaryDirectory() as d:
        for world in worlds:
            stamp(f"dist-{world}")
            mp.start_processes(dist_rank, args=(world, free_port(), d),
                               nprocs=world, start_method="spawn")
            ranks = []
            for r in range(world):
                with open(f"{d}/dist_{world}_{r}.json") as f:
                    ranks.append(json.load(f))
            legs = {}
            for leg in ("se_sharded_qgram", "se_sharded_fmi",
                        "paired_replicated", "all_replicated"):
                slow = max(x[leg]["seconds"] for x in ranks)
                legs[leg] = dict(
                    seconds_slowest_rank=slow, reads_per_s=world * B / slow,
                    peak_bytes=max(x[leg]["peak_bytes"] for x in ranks),
                    launches_rank0=ranks[0][leg]["launches"])
                print(f"[dist] D = {world}: {leg} slowest rank "
                      f"{slow:.3f} s a batch of {B} a rank = "
                      f"{world * B / slow:.1f} reads/s over {world} cards; "
                      f"peak {legs[leg]['peak_bytes'] / 1e9:.3f} GB; card "
                      f"{card}", flush=True)
            summary[world] = dict(legs=legs, ranks=ranks)
    print(json.dumps({"dist_cards": summary, "phase_starts": STAMPS,
                      "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def device_rows(prof) -> list:
    """(device µs, calls, name) of each kernel a profile saw; host ops are
    left out, their device time is their kernels', and so are the
    program's spans' shadows on the device timeline (user annotations)."""
    rows = []
    for ev in prof.key_averages():
        if "CUDA" not in str(getattr(ev, "device_type", "")) \
                or getattr(ev, "is_user_annotation", False):
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    return rows


def phase_profile(label, dispatch):
    """Device time of one batch's ``dispatch()`` by kernel (torch.profiler):
    busy share of the wall time and the largest device-time consumers."""
    from torch.profiler import ProfilerActivity, profile

    dispatch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        dispatch()
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows)
    if busy == 0:
        print(f"[profile] {label}: the profiler saw no device time: not "
              f"measured", flush=True)
        return None
    rows.sort(reverse=True)
    print(f"[profile] {label}, one batch: wall {wall_us / 1e3:.3f} ms, "
          f"device busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), "
          f"{sum(r[1] for r in rows)} device ops", flush=True)
    for us, count, key in rows[:12]:
        print(f"[profile]   {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}",
              flush=True)
    return dict(wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
                top=[dict(ms=us / 1e3, count=c, name=k[:90])
                     for us, c, k in rows[:12]])


def peak_memory(label, dispatch) -> int:
    """Peak device memory of one batch's ``dispatch()`` above what was
    allocated before it (torch.cuda.max_memory_allocated)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = dispatch()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del res
    print(f"[memory] {label}, one batch: peak device memory {peak / 1e6:.1f} "
          f"MB above the {base / 1e6:.1f} MB held before", flush=True)
    return peak


def phase_gpu_equals_cpu(label, gpu_fn, cpu_fn, n_records=None,
                         secondaries=False):
    """The same reads mapped on cuda and on cpu: identical SAM records (and
    ``n_records`` of them where the path writes a fixed number; some of
    them secondary where ``secondaries``)."""
    recs = gpu_fn()
    gpu = [r.line() for r in recs]
    t0 = time.time()
    cpu = [r.line() for r in cpu_fn()]
    diff = sum(a != b for a, b in zip(gpu, cpu))
    n_sec = sum(bool(r.flag & 0x100) for r in recs)
    print(f"[gpu=cpu] {label}: {len(gpu)} records ({n_sec} secondary), "
          f"{diff} differ (cpu map {time.time() - t0:.2f} s)", flush=True)
    require(len(gpu) == len(cpu) == (n_records or len(gpu)) and diff == 0,
            f"{label}: SAM records differ between cuda and cpu")
    require(n_sec > 0 or not secondaries,
            f"{label}: no secondary record among those compared")


def head(batch, n=N_CMP):
    from nvbio_tpu_torch.io.fastq import ReadBatch

    return ReadBatch(batch.names[:n], batch.codes[:n], batch.quals[:n],
                     batch.lengths[:n])


def map_params():
    """The single-end and paired-end paths' MapParams (-X 500, fr, rescue
    on) and the FM-seeded copy."""
    from nvbio_tpu_torch.bowtie.params import MapParams

    params = MapParams(max_read_len=L, seed_len=22, seed_stride=15,
                       hits_per_seed=6, max_dist=MAX_DIST, maxins=MAXINS)
    return params, dataclasses.replace(params, seeding="fmi")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--dist-cards"]:
        return dist_cards_main([int(x) for x in sys.argv[2:]])
    from nvbio_tpu_torch.align import kernels as K
    from nvbio_tpu_torch.bowtie.paired import (
        dispatch_pair_batch,
        dispatch_pair_batch_all,
        map_pair_batch,
        map_pair_batch_all,
    )
    from nvbio_tpu_torch.bowtie.params import MapParams
    from nvbio_tpu_torch.bowtie.pipeline import ReadMapper
    from nvbio_tpu_torch.io.reference import Reference
    from nvbio_tpu_torch.packed import words_to_tensor
    from nvbio_tpu_torch.qgram import build_qgram_index

    card = smi("name,power.limit")
    print(f"[card] {card}", flush=True)

    # the precompiled libraries and those of bands W2 and MEM_W (mem's
    # band), one nvcc each, all in parallel
    t0 = time.time()
    stamp("build")
    info = K.build(bands=(W2, MEM_W))
    for name, d in info.items():
        print(f"[build] {name}: {d['seconds']:.1f} s; "
              f"{' | '.join(ptxas_summary(d['ptxas']))}", flush=True)
    print(f"[build] all kernels and the band-{W2} and band-{MEM_W} "
          f"libraries in {time.time() - t0:.1f} s", flush=True)

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    t0 = time.time()
    genome = rng.integers(0, 4, size=GENOME_LEN, dtype=np.uint8)
    ref = Reference(["sim100M"], np.array([0, GENOME_LEN], np.int64), genome,
                    np.zeros(0, np.uint32))
    words = words_to_tensor(ref.packed_words(), dev)
    print(f"[genome] {GENOME_LEN} bp in {time.time() - t0:.2f} s",
          flush=True)

    regs = {}
    for d in info.values():
        regs.update(ptxas_entries(d["ptxas"]))
    stamp("kernels")
    kernels, extra = phase_kernels(genome, words, dev, rng, regs)

    # one parameter set serves the single-end and paired-end paths
    # (-X 500, fr, rescue on); local mode is the --local preset
    params, fm_params = map_params()
    local_params = MapParams.local(max_read_len=L, seed_len=22,
                                   seed_stride=15, hits_per_seed=6)
    full_params = dataclasses.replace(params, pe_full_traceback=True)
    full_local = dataclasses.replace(local_params, pe_full_traceback=True)
    stamp("qgram_index")
    t0 = time.time()
    index = build_qgram_index(genome, params.qgram_q)
    print(f"[index] q-gram q={params.qgram_q} over {GENOME_LEN} bp on the "
          f"host in {time.time() - t0:.2f} s", flush=True)
    se_records = []
    stamp("single-end")
    gpu_mapper, batch0, se_launches, stats = phase_main_path(
        genome, ref, index, params, card, records=se_records)
    gpu_index = gpu_mapper.index
    stamp("paired")
    pe_records = []
    pair0, pe_launches, pe_stats = phase_paired(genome, gpu_mapper, card,
                                                records=pe_records)

    def gpu(prm):
        return ReadMapper.build(ref, prm, index=gpu_index, device="cuda")

    # any band: max_dist 10 (band 21, no precompiled library); rescue of
    # 150-base mates (K4 over 5 words)
    params21 = dataclasses.replace(params, max_dist=MAX_DIST_2)
    stamp("single-end-w21")
    gpu21, batch21, se21_launches, se21_stats = phase_main_path(
        genome, ref, gpu_index, params21, card, label="single-end-w21",
        n_batches=1, seed=SEED + 800)
    params150 = dataclasses.replace(params, max_read_len=L_PE2)
    gpu150 = gpu(params150)
    stamp("paired-150")
    pair150, pe150_launches, pe150_stats = phase_paired(
        genome, gpu150, card, label="paired-150", n_batches=1, rl=L_PE2,
        seed=SEED + 900)

    # FM-index seeding: the index built once, its search on the card against
    # the CPU, then the FM-seeded single-end and paired-end paths
    stamp("build_fm")
    fm_cpu, fm_gpu, fm_build = build_fm(genome)
    stamp("fmi_search")
    fm_search = phase_fmi_search(genome, fm_cpu, fm_gpu, fm_params, card)
    stamp("fmi")
    gpu_fm, fm_batch0, fm_launches, fm_stats = phase_fmi(
        genome, ref, fm_gpu, fm_params, card)
    fm_stats.update(build=fm_build, search=fm_search)
    stamp("paired-fmi")
    pfm0, pfm_launches, pfm_stats = phase_paired(
        genome, gpu_fm, card, label="paired-fmi", n_batches=1,
        seed=SEED + 1500)

    # index construction on the card beyond the uniform genome's, and
    # randomized hit selection on three paths
    t0 = time.time()
    rep_genome = plant_repeats(genome, np.random.default_rng(SEED + 1))
    print(f"[index] repeat-planted genome ({N_REPEATS} x {REPEAT_LEN} bp) "
          f"in {time.time() - t0:.2f} s", flush=True)
    stamp("index_device")
    index_device, rep_bwt = phase_index_device(rep_genome, card)
    index_device["uniform"] = fm_build["device"]
    stamp("blockwise")
    blockwise = phase_blockwise(genome, fm_gpu, rep_genome, rep_bwt, card)
    del rep_bwt
    stamp("setbwt")
    setbwt = phase_setbwt(card)
    stamp("randomized")
    rand_stats, rand_launches = phase_randomized(
        genome, ref, gpu_index, fm_gpu, fm_cpu, params, card)

    gpu_local = gpu(local_params)
    stamp("local")
    local_records = []
    local0, local_launches, local_stats = phase_local(
        genome, gpu_local, card, records=local_records)
    gpu_full, gpu_full_local = gpu(full_params), gpu(full_local)
    full_launches = {**PE_LAUNCHES, "banded_traceback": 0,
                     "banded_traceback_wide": 2}
    stamp("paired_full")
    pf_records = []
    pf0, pf_launches, pf_stats = phase_paired_full(
        genome, gpu_full, "paired-full", SEED + 600, full_launches, card,
        records=pf_records)
    stamp("paired-full-local")
    pfl0, pfl_launches, pfl_stats = phase_paired_full(
        genome, gpu_full_local, "paired-full-local", SEED + 700,
        full_launches, card)
    # the --all paths map against the genome with exact repeats planted
    t0 = time.time()
    rep_ref = Reference(["sim100M_rep"], np.array([0, GENOME_LEN], np.int64),
                        rep_genome, np.zeros(0, np.uint32))
    gpu_rep = ReadMapper.build(
        rep_ref, params, index=build_qgram_index(rep_genome, params.qgram_q),
        device="cuda")
    print(f"[index] the repeat-planted genome's q-gram index in "
          f"{time.time() - t0:.2f} s", flush=True)
    stamp("all")
    all_records = []
    all0, all_launches, all_stats = phase_all(rep_genome, gpu_rep, card,
                                              records=all_records)
    stamp("paired_all")
    pa0, pa_launches, pa_stats = phase_paired_all(rep_genome, gpu_rep, card)
    stamp("gcups")
    gcups_launches, gcups = phase_gcups(card)
    stamp("cli")
    cli_stats = phase_cli(genome, gpu_mapper, card)
    stamp("cli_index")
    cli_stats["index"] = phase_cli_index(genome, fm_cpu, card)
    stamp("cli_setbwt")
    cli_stats["setbwt"] = phase_cli_setbwt(card)

    # mem (SMEM seeding, chaining, one K2-LOCAL launch a batch), error
    # correction, coordinate sorting and the new commands
    stamp("mem")
    mem_stats, mem_launches, mem_kernel = phase_mem(genome, rep_genome, card,
                                                    regs)
    kernels.append(mem_kernel)
    stamp("correct")
    correct_stats = phase_correct(card)
    stamp("sort")
    sort_stats = phase_sort(se_records[:N_SORT], card)
    se_first = se_records[:B]   # [scan] compares the first batch's
    del se_records
    stamp("cli_apps")
    cli_stats["apps"] = phase_cli_apps(genome, card)
    # the micro-assembly batch and the FM library (no kernel of the repo)
    stamp("assemble")
    asm_stats = phase_assemble(card)
    stamp("fm_library")
    fmlib_stats = phase_fm_library(genome, fm_cpu, fm_gpu, card)
    # the public surface: package names, gather_symbols, rank2
    stamp("surface")
    surface_stats = phase_surface(ref.packed_words(), words, fm_cpu, fm_gpu,
                                  card)
    # the scan route and the aligner library (no kernel of the repo)
    stamp("scan")
    # the kernel route's records of each path's first batch (same seeds)
    scan_stats = phase_scan(
        genome, rep_genome, ref, rep_ref, gpu_index, gpu_rep.index,
        {"se": se_first, "pe": pe_records[:2 * B],
         "local": local_records[:B], "paired-full": pf_records,
         "all": all_records}, params, local_params, card)
    del se_first, pe_records, local_records, pf_records, all_records
    stamp("aligner")
    aligner_stats = phase_aligner(genome, card)
    # multi-GPU mapping: the sharded steps over NCCL, GPU = CPU over gloo,
    # and map --dist
    stamp("dist")
    dist_stats = phase_dist(genome, ref, gpu_index, fm_gpu, params,
                            fm_params, gpu_mapper, card)
    stamp("profile")

    # each kernel's launches in the run of the path it serves
    runs = {"single_end": se_launches, "paired_end": pe_launches,
            "local": local_launches, "paired_full": pf_launches,
            "paired_full_local": pfl_launches, "all": all_launches,
            "paired_all": pa_launches, "gcups": gcups_launches,
            "single_end_w21": se21_launches, "paired_150": pe150_launches,
            "fmi": fm_launches, "paired_fmi": pfm_launches,
            "mem": mem_launches, **rand_launches}
    # each entry's path, its batches there and its wrapper
    own = {"banded_score_cands": ("single_end", N_BATCHES),
           "banded_score_cands_local": ("local", N_BATCHES_LOCAL),
           "banded_traceback": ("single_end", N_BATCHES),
           "banded_traceback_local": ("local", N_BATCHES_LOCAL),
           "banded_score_windows": ("paired_end", N_BATCHES_PE),
           "myers_semiglobal_windows": ("paired_end", N_BATCHES_PE),
           "banded_traceback_wide": ("paired_full", 1),
           "banded_traceback_wide_local": ("paired_full_local", 1),
           "regtile_score_blocked": ("gcups", 2),
           "banded_score_cands_w21": ("single_end_w21", 1),
           "banded_traceback_w21": ("single_end_w21", 1),
           "banded_traceback_mem": ("mem", N_MEM_BATCHES)}
    for k in kernels:
        path, n_batches = own[k["name"]]
        wrapper = re.sub(r"_local$|_w\d+$|_mem$", "", k["name"])
        k["launches"] = runs[path][wrapper]
        k["launches_per_batch"] = runs[path][wrapper] / n_batches
        k["launches_by_path"] = {p: c[wrapper] for p, c in runs.items()}
        require(k["launches"] > 0, f"{k['name']} never launched on its path")
    require(len(kernels) == len(own),
            f"{len(kernels)} kernel entries, not {len(own)}")

    stats["profile"] = phase_profile(
        "single-end", lambda: gpu_mapper.dispatch(batch0))
    pe_stats["profile"] = phase_profile(
        "paired-end", lambda: dispatch_pair_batch(gpu_mapper, *pair0))
    local_stats["profile"] = phase_profile(
        "local", lambda: gpu_local.dispatch(local0))
    pf_stats["profile"] = phase_profile(
        "paired-full", lambda: dispatch_pair_batch(gpu_full, *pf0))
    all_stats["profile"] = phase_profile(
        "all", lambda: gpu_rep.dispatch_all(all0))
    stats["peak_bytes"] = peak_memory(
        "single-end", lambda: gpu_mapper.dispatch(batch0))
    local_stats["peak_bytes"] = peak_memory(
        "local", lambda: gpu_local.dispatch(local0))
    pa_stats["profile"] = phase_profile(
        "paired-all", lambda: dispatch_pair_batch_all(gpu_rep, *pa0))
    pfm_stats["profile"] = phase_profile(
        "paired-fmi", lambda: dispatch_pair_batch(gpu_fm, *pfm0))

    stamp("gpu=cpu")
    cpu_index = gpu_index.to("cpu")

    def cpu(prm):
        return ReadMapper.build(ref, prm, index=cpu_index, device="cpu")

    cpu_mapper, cpu_local = cpu(params), cpu(local_params)
    small = head(batch0)
    phase_gpu_equals_cpu("single-end", lambda: gpu_mapper.map_batch(small),
                         lambda: cpu_mapper.map_batch(small), N_CMP)
    p1, p2 = head(pair0[0]), head(pair0[1])
    phase_gpu_equals_cpu("paired-end",
                         lambda: map_pair_batch(gpu_mapper, p1, p2),
                         lambda: map_pair_batch(cpu_mapper, p1, p2),
                         2 * N_CMP)
    small_local = head(local0)
    phase_gpu_equals_cpu("local", lambda: gpu_local.map_batch(small_local),
                         lambda: cpu_local.map_batch(small_local), N_CMP)
    cpu_full = cpu(full_params)
    f1, f2 = head(pf0[0]), head(pf0[1])
    phase_gpu_equals_cpu("paired-full",
                         lambda: map_pair_batch(gpu_full, f1, f2),
                         lambda: map_pair_batch(cpu_full, f1, f2), 2 * N_CMP)
    cpu_rep = ReadMapper.build(rep_ref, params,
                               index=gpu_rep.index.to("cpu"), device="cpu")
    small_all = head(all0)   # --all writes a record per kept locus
    phase_gpu_equals_cpu("all", lambda: gpu_rep.map_batch_all(small_all),
                         lambda: cpu_rep.map_batch_all(small_all),
                         secondaries=True)
    a1, a2 = head(pa0[0]), head(pa0[1])
    phase_gpu_equals_cpu("paired-all",
                         lambda: map_pair_batch_all(gpu_rep, a1, a2),
                         lambda: map_pair_batch_all(cpu_rep, a1, a2),
                         secondaries=True)
    cpu21 = cpu(params21)
    small21 = head(batch21)
    phase_gpu_equals_cpu("single-end-w21", lambda: gpu21.map_batch(small21),
                         lambda: cpu21.map_batch(small21), N_CMP)
    cpu150 = cpu(params150)
    q1, q2 = head(pair150[0]), head(pair150[1])
    phase_gpu_equals_cpu("paired-150",
                         lambda: map_pair_batch(gpu150, q1, q2),
                         lambda: map_pair_batch(cpu150, q1, q2), 2 * N_CMP)

    # FM seeding: the CPU maps with the same index and no k-mer table
    cpu_fm = ReadMapper.build(ref, fm_params, index=fm_cpu, device="cpu")
    small_fm = head(fm_batch0)
    phase_gpu_equals_cpu("fmi", lambda: gpu_fm.map_batch(small_fm),
                         lambda: cpu_fm.map_batch(small_fm), N_CMP)
    m1, m2 = head(pfm0[0]), head(pfm0[1])
    phase_gpu_equals_cpu("paired-fmi",
                         lambda: map_pair_batch(gpu_fm, m1, m2),
                         lambda: map_pair_batch(cpu_fm, m1, m2), 2 * N_CMP)

    stamp("end")
    print(json.dumps({"kernels": kernels, "kernel_extra": extra,
                      "main_path": stats, "paired_end": pe_stats,
                      "single_end_w21": se21_stats,
                      "paired_150": pe150_stats,
                      "local": local_stats, "paired_full": pf_stats,
                      "paired_full_local": pfl_stats, "all": all_stats,
                      "paired_all": pa_stats, "gcups": gcups,
                      "fmi": fm_stats, "paired_fmi": pfm_stats,
                      "index_device": index_device,
                      "blockwise": blockwise, "setbwt": setbwt,
                      "randomized": rand_stats, "mem": mem_stats,
                      "correct": correct_stats, "sort": sort_stats,
                      "cli": cli_stats, "assemble": asm_stats,
                      "fm_library": fmlib_stats, "surface": surface_stats,
                      "scan": scan_stats,
                      "aligner": aligner_stats, "dist": dist_stats,
                      "phase_starts": STAMPS,
                      "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
