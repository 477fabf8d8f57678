"""`nvbio_tpu_torch correct` — Bloom-filter error correction (nvLighter).

    python -m nvbio_tpu_torch correct reads.fq [-o out.fq] [-k K]
        [--alpha-den A] [--solid-cov C] [--bloom-bits N] [--batch B]
        [--max-read-len L] [--device cpu]

Port of ``nvbio_tpu/apps/correct_app.py``: three streaming passes over the
FASTQ (sample -> trust -> correct), nvLighter's three Pipeline phases
(``nvLighter/nvLighter.cu:417-600``), writing the same corrected FASTQ.
The filters and every phase live on the CUDA card unless ``--device cpu``
is given; it raises where there is no card.
"""

from __future__ import annotations

import sys
import time


def add_parser(sub):
    p = sub.add_parser("correct", help="error-correct reads (Lighter-style)")
    p.add_argument("reads", help="FASTQ(.gz)")
    p.add_argument("-o", "--output", default="-", help="corrected FASTQ out")
    p.add_argument("-k", type=int, default=17)
    p.add_argument("--alpha-den", type=int, default=8)
    p.add_argument("--solid-cov", type=int, default=9)
    p.add_argument("--bloom-bits", type=int, default=1 << 24)
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--max-read-len", type=int, default=128)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.set_defaults(func=run)
    return p


def run(args):
    import numpy as np
    import torch

    from nvbio_tpu_torch.alphabet import Alphabet, codes_to_string
    from nvbio_tpu_torch.bloom import ByteBloomFilter
    from nvbio_tpu_torch.device import resolve_device
    from nvbio_tpu_torch.io.fastq import fastq_batches
    from nvbio_tpu_torch.lighter import (
        LighterParams,
        correct_reads,
        mark_trusted,
        sample_kmers,
    )
    from nvbio_tpu_torch.utils.console import log_info, log_stats

    dev = resolve_device(args.device)
    params = LighterParams(
        k=args.k, alpha_den=args.alpha_den, solid_cov=args.solid_cov,
        bloom_bits_a=args.bloom_bits, bloom_bits_b=args.bloom_bits,
        max_read_len=args.max_read_len,
    )

    def batches():
        for b in fastq_batches(args.reads, args.batch, args.max_read_len):
            yield b, (torch.from_numpy(b.codes.astype(np.int32)).to(dev),
                      torch.from_numpy(b.lengths).to(dev))

    t0 = time.time()
    bfa = ByteBloomFilter.empty(params.bloom_bits_a, 3, dev).bytes_
    off = 0
    for b, (codes, lens) in batches():
        bfa = sample_kmers(bfa, codes, lens, off, params)
        off += len(b.names)
    log_info(f"phase 1 (sample) done in {time.time()-t0:.1f}s")

    bfb = ByteBloomFilter.empty(params.bloom_bits_b, 3, dev).bytes_
    for b, (codes, lens) in batches():
        bfb = mark_trusted(bfa, bfb, codes, lens, params)
    log_info(f"phase 2 (trust) done in {time.time()-t0:.1f}s")

    out = sys.stdout if args.output == "-" else open(args.output, "w")
    n_reads = n_corr_total = 0
    for b, (codes, lens) in batches():
        corrected, n_corr = correct_reads(bfb, codes, lens, params)
        corrected = corrected.cpu().numpy()
        n_corr = n_corr.cpu().numpy()
        for i, name in enumerate(b.names):
            L = int(b.lengths[i])
            if L == 0:
                continue
            seq = codes_to_string(corrected[i, :L], Alphabet.DNA)
            qual = (b.quals[i, :L] + 33).tobytes().decode()
            out.write(f"@{name}\n{seq}\n+\n{qual}\n")
            n_reads += 1
            n_corr_total += int(n_corr[i])
    if out is not sys.stdout:
        out.close()
    log_stats(
        f"{n_reads:,} reads, {n_corr_total:,} corrections "
        f"in {time.time()-t0:.1f}s"
    )
    return 0
