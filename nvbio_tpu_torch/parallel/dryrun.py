"""One full SPMD pipeline step of every sharded path over a reads mesh.

Port of ``dryrun_multichip`` (``__graft_entry__.py:60-208``): a 1 Mbp
genome, 100-base reads with ~1% substitutions at the production seed
geometry (seed 22, stride 15), the reseed pass with 1-mismatch seeding on.
Legs: single-end against a replicated and a bucket-sharded q-gram index
(equal on these data), the genome-sliced FM index against a replicated
one on a read set that straddles every seam (equal on these data), the
all-mapping step, and paired-end pairing with rescue. Every rank of the
mesh calls it; each maps its own 8 reads. The tests run it over gloo
ranks on the CPU, ``chip_smoke.py`` over NCCL on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nvbio_tpu_torch.parallel.mesh import ReadsMesh

KEYS = ("mapped", "best_score", "window_start", "mapq")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _equal(a: dict, b: dict, what: str) -> None:
    for k in KEYS:
        _require(torch.equal(a[k], b[k]), f"{what}: {k} differs")


def dryrun_multichip(mesh: ReadsMesh, genome_len: int = 1_000_000) -> dict:
    """Run every leg on ``mesh`` (each rank its 8 reads); raises
    AssertionError where a leg disagrees. Returns the legs' all-reduced
    stats as ints."""
    from nvbio_tpu_torch import packed
    from nvbio_tpu_torch.bowtie.params import MapParams
    from nvbio_tpu_torch.fmi.index import build_fmindex
    from nvbio_tpu_torch.fmi.sharded import (
        place_sharded_fmindex,
        shard_fmindex,
    )
    from nvbio_tpu_torch.parallel.mesh import (
        replicate,
        shard_batch,
        sharded_align_step,
        sharded_all_step,
        sharded_paired_step,
    )
    from nvbio_tpu_torch.parallel.sharded_index import (
        place_sharded_index,
        shard_qgram_index,
    )
    from nvbio_tpu_torch.qgram import build_qgram_index
    from nvbio_tpu_torch.utils.simgenome import sample_reads

    D = mesh.size
    batch = 8 * D
    read_len = 100
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, size=genome_len, dtype=np.uint8)
    params = MapParams(
        max_read_len=read_len, seed_len=22, seed_stride=15, hits_per_seed=4,
        max_reseed=1, seeding_1mm=True, reseed_frac=0.5)
    host_idx = build_qgram_index(genome, params.qgram_q)
    n = len(genome)

    def words_of(g):
        return replicate(mesh, packed.words_to_tensor(packed.pack(g, 2),
                                                      "cpu"))

    reads, _, _ = sample_reads(genome, batch, read_len, seed=1,
                               subst_rate=0.01)
    lens = np.full(batch, read_len, np.int32)
    quals = np.full((batch, read_len), 30, np.uint8)
    mine = [shard_batch(mesh, a) for a in (reads, lens, quals)]
    idx = replicate(mesh, host_idx)
    words = words_of(genome)

    res, stats = sharded_align_step(mesh, params)(idx, words, n, *mine)
    out = {"se": {k: int(v) for k, v in stats.items()}}
    n_mapped = out["se"]["n_mapped"]
    _require(out["se"]["n_reads"] == batch, f"se: {out['se']}")
    _require(n_mapped >= int(0.95 * batch),
             f"expected ~all 1%-error reads mapped, got {out['se']}")

    # the bucket-sharded index: its rows on this rank, lookups served by
    # collectives inside the step
    sidx = place_sharded_index(mesh, shard_qgram_index(host_idx, D))
    res_sh, stats_sh = sharded_align_step(mesh, params, index_sharded=True)(
        sidx, words, n, *mine)
    out["se_sharded_qgram"] = {k: int(v) for k, v in stats_sh.items()}
    _require(out["se_sharded_qgram"]["n_mapped"] == n_mapped,
             f"sharded q-gram {out['se_sharded_qgram']} vs {out['se']}")
    _equal(res, res_sh, "sharded q-gram vs replicated")
    del sidx

    _, stats_all = sharded_all_step(mesh, params)(idx, words, n, *mine)
    out["all"] = {k: int(v) for k, v in stats_all.items()}
    _require(out["all"]["n_alignments"] >= n_mapped, f"all: {out['all']}")

    # the genome-sliced FM index on a genome whose every seam is straddled
    genome_fm = rng.integers(0, 4, size=4096 * D, dtype=np.uint8)
    n_fm = len(genome_fm)
    slice_len = (n_fm + D - 1) // D
    starts = rng.integers(0, n_fm - read_len, size=batch)
    for i, d in enumerate((list(range(1, D)) * batch)[:batch // 2]):
        starts[i] = min(d * slice_len - read_len // 2, n_fm - read_len)
    reads_fm = np.stack([genome_fm[s:s + read_len]
                         for s in starts]).astype(np.int32)
    words_fm = words_of(genome_fm)
    mine_fm = [shard_batch(mesh, reads_fm)] + mine[1:]
    params_fm = dataclasses.replace(params, seeding="fmi")
    fm_sidx = place_sharded_fmindex(mesh, shard_fmindex(genome_fm, D,
                                                        overlap=64))
    res_fm, stats_fm = sharded_align_step(
        mesh, params_fm, index_sharded=True)(fm_sidx, words_fm, n_fm,
                                             *mine_fm)
    out["se_sharded_fmi"] = {k: int(v) for k, v in stats_fm.items()}
    _require(out["se_sharded_fmi"]["n_mapped"] == batch,
             f"sharded FM: {out['se_sharded_fmi']}")
    fm_rep = replicate(mesh, build_fmindex(genome_fm))
    res_fr, _ = sharded_align_step(mesh, params_fm)(fm_rep, words_fm, n_fm,
                                                    *mine_fm)
    _equal(res_fr, res_fm, "sharded FM vs replicated FM")

    # paired-end: mate 2 is the reverse complement of mate 1
    rc = np.ascontiguousarray((3 - reads)[:, ::-1]).astype(np.int32)
    mates = mine + [shard_batch(mesh, rc)] + mine[1:]
    *_, pstats = sharded_paired_step(mesh, params)(idx, words, n, *mates)
    out["pe"] = {k: int(v) for k, v in pstats.items()}
    _require(out["pe"]["n_pairs"] == batch, f"pe: {out['pe']}")
    _require(out["pe"]["n_proper"] >= int(0.9 * batch), f"pe: {out['pe']}")
    return out
