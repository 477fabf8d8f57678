"""`nvbio_tpu_torch setbwt` — read-set BWT construction (nvSetBWT).

    python -m nvbio_tpu_torch setbwt reads.fq prefix [--txt] [--bgz]
        [--lz4] [--incremental BLOCK]
        [--method native|rank|device|paged|merge] [--device cpu]

Port of ``nvbio_tpu/apps/setbwt_app.py``: writes the same files as
``python -m nvbio_tpu setbwt``:
  <prefix>.setbwt.npz      BWT symbols {0:'$', 1..4} and the primary row
  <prefix>.setbwt.txt      ASCII BWT ('$ACGT', with --txt)
  <prefix>.setbwt.txt.bgz  the same, BGZF-compressed (with --bgz)
  <prefix>.setbwt.lz4      LZ4 frames of the symbol bytes (with --lz4)
Without ``--incremental`` the joined read set is sorted by host SA-IS; with
it, blocks of BLOCK reads merge by the chosen engine (``index.setbwt``),
``--method device`` running the card's BWTE engine
(``index.bwte_device``) on the app's device. The app resolves its device
as ``map`` and ``index`` do: cuda unless ``--device cpu`` is given, and it
raises where there is no card.
"""

from __future__ import annotations

import struct
import time

import numpy as np


def add_parser(sub):
    p = sub.add_parser("setbwt", help="build the BWT of a read set")
    p.add_argument("reads", help="FASTQ(.gz)")
    p.add_argument("output", help="output prefix (.setbwt.npz / .txt)")
    p.add_argument("--txt", action="store_true", help="also write ASCII BWT")
    p.add_argument("--bgz", action="store_true",
                   help="also write BGZF-compressed ASCII BWT (.txt.bgz)")
    p.add_argument("--lz4", action="store_true",
                   help="also write the LZ4-framed BWT symbols "
                        "(.setbwt.lz4)")
    p.add_argument("--incremental", type=int, metavar="BLOCK", default=0,
                   help="build block-incrementally with this block size")
    p.add_argument("--method",
                   choices=["native", "rank", "device", "paged", "merge"],
                   default="native",
                   help="incremental engine: native (C++ BCR blocks and "
                        "rank-walk merges; rank for ragged sets), rank "
                        "(numpy static-rank merge), device (the BWTE "
                        "engine on the app's device; uniform reads), paged "
                        "(PagedText column insertion), merge "
                        "(Holt-McMillan refinement)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.set_defaults(func=run)
    return p


def write_lz4(path: str, bwt: np.ndarray) -> None:
    """The symbol bytes in LZ4 frames of 16 MiB: magic ``NB4s``, the byte
    count, then (raw length, compressed length, block) per frame."""
    from nvbio_tpu_torch import native

    data = np.asarray(bwt, np.uint8).tobytes()
    with open(path, "wb") as f:
        f.write(b"NB4s")
        f.write(struct.pack("<Q", len(data)))
        CH = 1 << 24
        for s in range(0, max(len(data), 1), CH):
            seg = data[s:s + CH]
            comp = native.lz4_compress(seg)
            f.write(struct.pack("<II", len(seg), len(comp)))
            f.write(comp.tobytes())


def run(args):
    from nvbio_tpu_torch.alphabet import Alphabet, string_to_codes
    from nvbio_tpu_torch.device import resolve_device
    from nvbio_tpu_torch.index.setbwt import (
        bwt_to_text,
        mse_bwt_incremental,
        save_set_bwt,
        set_bwt,
    )
    from nvbio_tpu_torch.io.fastq import read_fastq
    from nvbio_tpu_torch.utils.console import log_stats

    dev = resolve_device(args.device)
    t0 = time.time()
    recs = read_fastq(args.reads)
    reads = [string_to_codes(s, Alphabet.DNA) for _, s, _ in recs]
    if args.incremental:
        tb0 = time.time()
        bwt = mse_bwt_incremental(reads, args.incremental,
                                  method=args.method, device=dev)
        dt = time.time() - tb0
        log_stats(f"incremental ({args.method}"
                  f"{', ' + dev.type if args.method == 'device' else ''}) "
                  f"build: {len(bwt):,} symbols in {dt:.1f}s = "
                  f"{len(bwt) / max(dt, 1e-9) / 1e6:.2f} M symbols/s")
        primary = -1  # multi-string BWT: one '$' per read, no single primary
    else:
        bwt, primary = set_bwt(reads)
    save_set_bwt(args.output + ".setbwt.npz", bwt, primary)
    if args.txt:
        with open(args.output + ".setbwt.txt", "w") as f:
            f.write(bwt_to_text(bwt))
    if args.bgz:
        from nvbio_tpu_torch.io.bgzf import BgzfWriter

        with BgzfWriter(args.output + ".setbwt.txt.bgz") as f:
            f.write(bwt_to_text(bwt).encode())
    if args.lz4:
        write_lz4(args.output + ".setbwt.lz4", bwt)
    log_stats(
        f"set-BWT of {len(reads):,} reads ({len(bwt):,} symbols) "
        f"in {time.time() - t0:.1f}s"
    )
    return 0
