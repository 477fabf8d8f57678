"""Out-of-core coordinate sorting of SAM/BAM files.

Counterpart of the reference's bamsort prototype
(``prototypes/bamsort/bam_sort.cu:56-78`` sortkey_gen/sort/merge and
``bam_sort.h:200-230`` generate_sort_keys): alignments are keyed by
``(ref_id, position)`` with unmapped reads keyed last, sorted in
device-sized runs, spilled, and k-way merged.

Port of ``nvbio_tpu.io.bamsort``: the per-run key sort is two stable
``torch.argsort`` passes (pos, then ref_id) on the run's device (cuda
unless the caller asks for the CPU) — the reference's
thrust::sort_by_key — while the spill runs, the k-way heap merge with its
(key, counter) tie-break and the host streaming I/O stay as they are.
"""

from __future__ import annotations

import heapq
import itertools
import os
import shutil
import tempfile
import time

import numpy as np

UNMAPPED_REF = 0x7FFFFFFF  # unmapped reads sort last (bam_sort.h:207-209)


def _sort_run_device(ref_ids: np.ndarray, positions: np.ndarray,
                     device) -> np.ndarray:
    """Stable (ref_id, pos) order of one run via argsorts on ``device``."""
    import torch

    pos = torch.from_numpy(np.ascontiguousarray(positions)).to(device)
    ref = torch.from_numpy(np.ascontiguousarray(ref_ids)).to(device)
    pos_order = torch.argsort(pos, stable=True)
    final = pos_order[torch.argsort(ref[pos_order], stable=True)]
    return final.cpu().numpy()


def _iter_alignment_file(path: str):
    """(ref_names, ref_lengths, record iterator) for SAM or BAM input."""
    if path.endswith(".bam"):
        from nvbio_tpu_torch.io.bam import BamReader

        br = BamReader(path)
        return br.ref_names, br.ref_lengths, iter(br)
    from nvbio_tpu_torch.io.sam import SamRecord, parse_tag_value, read_sam

    header, rows = read_sam(path)
    names, lengths = [], []
    for line in header:
        if line.startswith("@SQ"):
            fields = dict(f.split(":", 1) for f in line.split("\t")[1:])
            names.append(fields["SN"])
            lengths.append(int(fields["LN"]))

    def gen():
        for f in rows:
            tags = {}
            for t in f[11:]:
                k, typ, v = t.split(":", 2)
                tags[k] = parse_tag_value(typ, v)
            yield SamRecord(f[0], int(f[1]), f[2], int(f[3]), int(f[4]),
                            f[5], f[9], f[10], f[6], int(f[7]), int(f[8]),
                            tags or None)
    return names, lengths, gen()


def sort_alignments(in_path: str, out_path: str, run_size: int = 262_144,
                    tmp_dir: str | None = None, device=None,
                    stats: dict | None = None) -> int:
    """Coordinate-sort ``in_path`` into ``out_path`` (SAM or BAM each); the
    runs' key sorts on ``device`` (cuda unless the caller asks for the
    CPU; raises where there is no card). With a ``stats`` dict, the
    seconds of the runs' key sorts (upload, the two argsorts and the
    order's copy back) go into ``sort_s`` and the spilled runs into
    ``runs``."""
    from nvbio_tpu_torch.device import resolve_device
    from nvbio_tpu_torch.io.bam import BamReader, BamWriter
    from nvbio_tpu_torch.io.output import open_alignment_output

    dev = resolve_device(device)
    names, lengths, records = _iter_alignment_file(in_path)
    ref_rank = {n: i for i, n in enumerate(names)}

    def sort_key(rec):
        # records whose RNAME is missing from the header also sort last:
        # the spill BAM round-trips them as '*', so any other key would
        # break the merge phase's sorted-run invariant
        if rec.flag & 0x4 or rec.rname == "*" or rec.rname not in ref_rank:
            return (UNMAPPED_REF, 0)
        return (ref_rank[rec.rname], rec.pos)

    def device_order(buf):
        if not buf:
            return []
        keys = np.array([sort_key(r) for r in buf], np.int64)
        t0 = time.perf_counter()
        order = _sort_run_device(keys[:, 0].astype(np.int32),
                                 keys[:, 1].astype(np.int32), dev)
        if stats is not None:
            stats["sort_s"] = stats.get("sort_s", 0.0) + (
                time.perf_counter() - t0)
        return order

    runs = []
    tmp = tempfile.mkdtemp(dir=tmp_dir, prefix="bamsort_")
    n_total = 0
    try:
        buf = []
        for rec in records:
            buf.append(rec)
            n_total += 1
            if len(buf) >= run_size:
                run_path = os.path.join(tmp, f"run{len(runs)}.bam")
                with BamWriter(run_path, names, lengths, level=1) as w:
                    for i in device_order(buf):
                        w.write(buf[int(i)])
                runs.append(run_path)
                buf = []

        if stats is not None:
            stats["runs"] = max(len(runs) + bool(buf), 1)
        if not runs:  # everything fit in one run: write output directly
            with open_alignment_output(out_path, names, lengths,
                                       sort_order="coordinate") as w:
                for i in device_order(buf):
                    w.write(buf[int(i)])
            return n_total

        if buf:
            run_path = os.path.join(tmp, f"run{len(runs)}.bam")
            with BamWriter(run_path, names, lengths, level=1) as w:
                for i in device_order(buf):
                    w.write(buf[int(i)])
            runs.append(run_path)

        # k-way merge of the sorted runs (merge_batches, bam_sort.cu:83-150)
        readers = [BamReader(p) for p in runs]
        try:
            iters = [iter(r) for r in readers]
            tiebreak = itertools.count()
            heap = []
            for idx, it in enumerate(iters):
                rec = next(it, None)
                if rec is not None:
                    heapq.heappush(heap,
                                   (sort_key(rec), next(tiebreak), idx, rec))
            with open_alignment_output(out_path, names, lengths,
                                       sort_order="coordinate") as w:
                while heap:
                    _, _, idx, rec = heapq.heappop(heap)
                    w.write(rec)
                    nxt = next(iters[idx], None)
                    if nxt is not None:
                        heapq.heappush(heap, (sort_key(nxt), next(tiebreak),
                                              idx, nxt))
        finally:
            for r in readers:
                r.close()
        return n_total
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
