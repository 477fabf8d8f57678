"""One rank of a real multi-process mapping run.

    python -m nvbio_tpu_torch.parallel.worker --outdir DIR
        [--coordinator HOST:PORT --num-processes N --process-id R]
        [--batch 64] [--device cpu] [--dryrun]
    torchrun --nproc-per-node N -m nvbio_tpu_torch.parallel.worker \\
        --outdir DIR

Counterpart of ``scripts/dist_worker.py``. Every rank:

1. joins the process group (``parallel.dist.init_distributed``: NCCL on
   cuda, one card a rank; gloo on the CPU),
2. builds the same reference and q-gram index and holds it on its device
   (``place_replicated``),
3. takes its own rows of the global read batch (``shard_batch``),
4. runs the replicated-index step (stats all-reduced over the ranks), then
   the same reads against the bucket-sharded q-gram index and the
   genome-sliced FM index (equal on these exact reads),
5. formats its rows into its own SAM shard (``shard_path``), and
6. rank 0 merges the shards (``merge_sam_shards``), checks every read
   landed at its sampled position and writes ``DIST.json``.

``--dryrun`` also runs ``parallel.dryrun.dryrun_multichip`` on the mesh.
The line ``[R] DISTRIBUTED_OK ...`` ends each rank's run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch
import torch.distributed as dist

GENOME_LEN = 20_000
READ_LEN = 36


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nvbio_tpu_torch.parallel.worker")
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--coordinator", metavar="HOST:PORT")
    ap.add_argument("--num-processes", type=int)
    ap.add_argument("--process-id", type=int)
    ap.add_argument("--batch", type=int, default=64,
                    help="global reads; divides by the number of ranks")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--dryrun", action="store_true",
                    help="also run dryrun_multichip on the mesh")
    args = ap.parse_args(argv)

    from nvbio_tpu_torch import packed
    from nvbio_tpu_torch.bowtie.params import MapParams
    from nvbio_tpu_torch.bowtie.pipeline import ReadMapper
    from nvbio_tpu_torch.device import resolve_device
    from nvbio_tpu_torch.fmi.sharded import place_sharded_fmindex, \
        shard_fmindex
    from nvbio_tpu_torch.io.fastq import ReadBatch
    from nvbio_tpu_torch.io.sam import SamWriter
    from nvbio_tpu_torch.parallel.dist import (
        global_reads_mesh,
        init_distributed,
        local_rows,
        merge_sam_shards,
        place_replicated,
        shard_path,
    )
    from nvbio_tpu_torch.parallel.mesh import shard_batch, sharded_align_step
    from nvbio_tpu_torch.parallel.sharded_index import (
        place_sharded_index,
        shard_qgram_index,
    )
    from nvbio_tpu_torch.qgram import build_qgram_index

    backend = "nccl" if resolve_device(args.device).type == "cuda" \
        else "gloo"
    if not init_distributed(args.coordinator, args.num_processes,
                            args.process_id, backend=backend):
        raise SystemExit("no process group configured: give --coordinator, "
                         "--num-processes and --process-id, or run under "
                         "torchrun")
    mesh = global_reads_mesh(args.device)
    pid, nproc = mesh.rank, mesh.size
    batch = args.batch
    if batch % nproc:
        raise SystemExit(f"--batch {batch} does not divide over {nproc} "
                         f"ranks")

    # the same deterministic problem on every rank
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, size=GENOME_LEN, dtype=np.uint8)
    params = MapParams(max_read_len=READ_LEN, seed_len=16, seed_stride=10,
                       hits_per_seed=2, max_dist=3, qgram_q=10)
    index = build_qgram_index(genome, params.qgram_q)
    starts = np.random.default_rng(7).integers(0, GENOME_LEN - READ_LEN,
                                               size=batch)
    reads_all = np.stack([genome[s:s + READ_LEN]
                          for s in starts]).astype(np.int32)
    lens_all = np.full(batch, READ_LEN, np.int32)
    quals_all = np.full((batch, READ_LEN), 30, np.uint8)

    index_r = place_replicated(mesh, index)
    words = place_replicated(mesh, packed.words_to_tensor(
        packed.pack(genome, 2), "cpu"))
    mine = [shard_batch(mesh, a) for a in (reads_all, lens_all, quals_all)]
    res, stats = sharded_align_step(mesh, params)(index_r, words, GENOME_LEN,
                                                  *mine)
    n_mapped = int(stats["n_mapped"])
    assert int(stats["n_reads"]) == batch, stats
    assert n_mapped == batch, f"{n_mapped}/{batch} mapped"
    for name, sidx, prm in (
            ("sharded q-gram", place_sharded_index(
                mesh, shard_qgram_index(index, nproc)), params),
            ("sharded FM", place_sharded_fmindex(
                mesh, shard_fmindex(genome, nproc, overlap=64)),
             dataclasses.replace(params, seeding="fmi"))):
        res_s, stats_s = sharded_align_step(mesh, prm, index_sharded=True)(
            sidx, words, GENOME_LEN, *mine)
        assert int(stats_s["n_mapped"]) == batch, (name, stats_s)
        for k in ("mapped", "window_start", "best_score"):
            assert torch.equal(res_s[k], res[k]), (name, k)

    # this rank's rows -> its own SAM shard
    rows = batch // nproc
    sl = slice(pid * rows, (pid + 1) * rows)
    mapper = ReadMapper(index=index_r, genome_words=words,
                        n_genome=GENOME_LEN, ref_names=["ref"],
                        ref_offsets=np.zeros(1, np.int64), params=params,
                        device=mesh.device)
    local_batch = ReadBatch(
        names=[f"r{i}" for i in range(sl.start, sl.stop)],
        codes=reads_all[sl].astype(np.uint8), quals=quals_all[sl],
        lengths=lens_all[sl])
    host = local_rows(res)
    recs = mapper.format_fetched(local_batch, host)
    os.makedirs(args.outdir, exist_ok=True)
    w = SamWriter(shard_path(os.path.join(args.outdir, "out.sam")), ["ref"],
                  [GENOME_LEN])
    for r in recs:
        w.write(r)
    w.close()
    dry = None
    if args.dryrun:
        from nvbio_tpu_torch.parallel.dryrun import dryrun_multichip

        dry = dryrun_multichip(mesh)
    dist.barrier()

    if pid == 0:
        merged = os.path.join(args.outdir, "out.sam")
        n_rec = merge_sam_shards(
            [shard_path(merged, p) for p in range(nproc)], merged)
        assert n_rec == batch, (n_rec, batch)
        # every exact read aligns at its sampled position, forward
        got = {}
        with open(merged) as f:
            for line in f:
                if not line.startswith("@"):
                    fld = line.split("\t")
                    got[fld[0]] = (int(fld[1]), int(fld[3]))
        bad = [i for i in range(batch)
               if got[f"r{i}"] != (0, int(starts[i]) + 1)]
        assert not bad, f"misplaced reads: {bad[:5]}"
        with open(os.path.join(args.outdir, "DIST.json"), "w") as f:
            json.dump({"processes": nproc, "device": str(mesh.device),
                       "batch": batch, "n_mapped": n_mapped,
                       "records": n_rec, "verified": True,
                       "dryrun": dry}, f)
    dist.barrier()
    print(f"[{pid}] DISTRIBUTED_OK mapped={n_mapped}/{batch} procs={nproc} "
          f"device={mesh.device}", flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
