"""The rank side of ``tests/test_torch_parallel.py``: the port's sharded
functions in a group of gloo ranks on the CPU, one process a rank.

``run_rank`` is the target of one ``torch.multiprocessing`` spawn of
``WORLD`` ranks. Each rank builds the same data (``dataset``, numpy only),
forms the world mesh (D = 4) and a mesh of ranks 0 and 1 (D = 2, a
subgroup), runs every case on its own rows (the pipeline steps at D = 4)
and writes them to ``rank<r>.npz``; the test compares the files with the JAX package's
functions under ``jax.shard_map``. This module imports torch and the port,
never JAX or ``nvbio_tpu``, so the spawned children load neither.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

WORLD = 4
SUB = 2                 # ranks 0 and 1 form the subgroup's mesh
B_RANK = 8              # reads a rank, as the JAX dry run
L = 60
GENOME_LEN = 24_000
OVERLAP = 64            # >= L: a whole read across a seam lies in one slice
PARAMS = dict(max_read_len=L, seed_len=16, seed_stride=10, hits_per_seed=4,
              max_dist=5, qgram_q=7, max_reseed=1, seeding_1mm=True,
              reseed_frac=0.5, extension="scan")
N_LOOKUP = 24           # random (key, slot) queries a rank


def seams(D: int) -> list[int]:
    slice_len = (GENOME_LEN + D - 1) // D
    return [d * slice_len for d in range(1, D)]


def dataset():
    """(genome, reads (WORLD*B_RANK, L) int32, pair mates, lens, quals):
    a genome with 300-base repeats planted (wide q-gram buckets and
    multi-slice FM hits); reads with 2 substitutions, 5 (they need the
    reseed pass) or none (whole-read hits, three of them across seams),
    every seam of D = 2, 3 and 4 straddled, half on the reverse strand;
    mate 2 of each pair is the reverse complement of the fragment's far
    end."""
    rng = np.random.default_rng(15)
    g = rng.integers(0, 4, size=GENOME_LEN).astype(np.uint8)
    for _ in range(8):
        src, dst = rng.integers(0, GENOME_LEN - 300, size=2)
        g[dst:dst + 300] = g[src:src + 300]
    B = WORLD * B_RANK
    starts = rng.integers(0, GENOME_LEN - 400, size=B)
    straddle = sorted(set(seams(2) + seams(3) + seams(4)))
    for i, s in enumerate(straddle):
        starts[4 * i] = s - L // 2
    reads = g[starts[:, None] + np.arange(L)].astype(np.int32)
    mate2 = g[(starts + 300)[:, None] + np.arange(L)].astype(np.int32)
    for r in (reads, mate2):
        for i in range(B):
            k = 5 if i % 6 == 5 else 0 if i % 8 == 0 or i % 6 == 3 else 2
            at = rng.choice(L, size=k, replace=False)
            r[i, at] = (r[i, at] + rng.integers(1, 4, size=k)) % 4
    rc = rng.random(B) < 0.5
    reads = np.where(rc[:, None], (3 - reads)[:, ::-1], reads)
    mate2 = (3 - mate2)[:, ::-1]
    mate2 = np.where(rc[:, None], (3 - mate2)[:, ::-1], mate2)
    lens = np.full(B, L, np.int32)
    quals = rng.integers(20, 41, size=(B, L)).astype(np.uint8)
    return g, np.ascontiguousarray(reads), np.ascontiguousarray(mate2), \
        lens, quals


def lookup_queries(q: int):
    """(keys, slots) (WORLD*N_LOOKUP,) of the lookup case."""
    rng = np.random.default_rng(16)
    n = WORLD * N_LOOKUP
    return (rng.integers(0, 1 << (2 * q), size=n).astype(np.int32),
            rng.integers(0, 3, size=n).astype(np.int32))


def seed_planes(reads, lens, q: int):
    """(keys (B, NS), mutated keys (B, NS*3q), seeds (B, NS, s)) of the
    first seeding pass, as the pipeline forms them."""
    import torch

    from nvbio_tpu_torch.bowtie.params import MapParams
    from nvbio_tpu_torch.bowtie.pipeline import reverse_strand, seed_grid
    from nvbio_tpu_torch.qgram import seed_keys_from_batch

    P = MapParams(**PARAMS)
    r = torch.from_numpy(reads)
    ln = torch.from_numpy(lens)
    _, seeds, _ = seed_grid(r, reverse_strand(r, ln), ln, P)
    keys = seed_keys_from_batch(seeds, q)
    jj = torch.arange(q, dtype=torch.int32)
    dd = torch.arange(1, 4, dtype=torch.int32)
    xor = (dd[None, :] << (2 * (q - 1 - jj))[:, None]).reshape(3 * q)
    mut = (keys[:, :, None] ^ xor).reshape(keys.shape[0], -1)
    return keys.numpy(), mut.numpy(), seeds.numpy().astype(np.int32)


def whole_read_queries(reads, lens):
    """(queries (2B, L), lens (2B,)) of pass 0, grouped by rank: the
    forward strand of a rank's reads, then their reverse strand."""
    import torch

    from nvbio_tpu_torch.bowtie.pipeline import reverse_strand

    r = torch.from_numpy(reads)
    rc = reverse_strand(r, torch.from_numpy(lens)).numpy()
    qs, ls = [], []
    for i in range(0, len(reads), B_RANK):
        qs += [np.minimum(reads[i:i + B_RANK], 3), np.minimum(
            rc[i:i + B_RANK], 3)]
        ls += [lens[i:i + B_RANK]] * 2
    return np.concatenate(qs).astype(np.int32), np.concatenate(ls)


def _numpy(tree, prefix: str, out: dict) -> None:
    import torch

    if isinstance(tree, dict):
        for k, v in tree.items():
            _numpy(v, f"{prefix}.{k}", out)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _numpy(v, f"{prefix}[{i}]", out)
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree.cpu().numpy()


def _cases(mesh, D, data, out, steps: bool) -> None:
    """Every case at mesh size D on this rank's rows, into ``out``: the
    lookups and searches, and where ``steps`` the pipeline steps."""
    import torch

    from nvbio_tpu_torch import packed
    from nvbio_tpu_torch.bowtie.paired import align_paired_core
    from nvbio_tpu_torch.bowtie.params import MapParams
    from nvbio_tpu_torch.bowtie.pipeline import (
        align_batch_all,
        align_batch_core,
    )
    from nvbio_tpu_torch.fmi import sharded as fs
    from nvbio_tpu_torch.parallel import mesh as pm
    from nvbio_tpu_torch.parallel import sharded_index as si
    from nvbio_tpu_torch.qgram import build_qgram_index

    g, reads, mate2, lens, quals = data
    n = D * B_RANK
    reads, mate2, lens, quals = reads[:n], mate2[:n], lens[:n], quals[:n]
    P = MapParams(**PARAMS)
    q = P.qgram_q
    tag = f"D{D}"

    def rows(a):
        return pm.shard_batch(mesh, a)

    index = build_qgram_index(g, q)
    sq = si.place_sharded_index(mesh, si.shard_qgram_index(index, D))
    keys, slots = lookup_queries(q)
    p, rs = si.sharded_lookup(
        mesh, sq.offsets, sq.positions, rows(keys[:D * N_LOOKUP]),
        rows(slots[:D * N_LOOKUP]), q=q, n_shards=D,
        keys_per_shard=sq.keys_per_shard)
    out[f"{tag}/lookup"], out[f"{tag}/lookup_rs"] = p.numpy(), rs.numpy()
    skeys, mut, seeds = seed_planes(reads, lens, q)
    for name, kk, H in (("hits", skeys, P.hits_per_seed), ("hits1", mut, 1)):
        p, rs = si.sharded_seed_hits(sq, rows(kk), H)
        out[f"{tag}/{name}"], out[f"{tag}/{name}_rs"] = p.numpy(), rs.numpy()

    sf = fs.place_sharded_fmindex(mesh, fs.shard_fmindex(g, D,
                                                         overlap=OVERLAP))
    p, v, rs = fs.sharded_fmi_seed_hits(sf, rows(seeds), P.seed_len,
                                        P.hits_per_seed)
    out.update({f"{tag}/fm_hits": p.numpy(), f"{tag}/fm_hits_v": v.numpy(),
                f"{tag}/fm_hits_rs": rs.numpy()})
    wq, wl = whole_read_queries(reads, lens)
    p, v = fs.sharded_fmi_whole_read(sf, rows(wq), rows(wl))
    out[f"{tag}/fm_whole"], out[f"{tag}/fm_whole_v"] = p.numpy(), v.numpy()
    p, v = fs.sharded_fmi_seed_hits_1mm(sf, rows(seeds), P.seed_len)
    out[f"{tag}/fm_1mm"], out[f"{tag}/fm_1mm_v"] = p.numpy(), v.numpy()

    if not steps:
        return
    words = pm.replicate(mesh, packed.words_to_tensor(packed.pack(g, 2),
                                                      "cpu"))
    mine = [rows(a) for a in (reads, lens, quals)]
    fm_params = dataclasses.replace(P, seeding="fmi")
    for name, sidx, prm in (("se_qgram", sq, P), ("se_fmi", sf, fm_params)):
        res, stats = pm.sharded_align_step(mesh, prm, index_sharded=True)(
            sidx, words, len(g), *mine)
        _numpy(res, f"{tag}/{name}", out)
        _numpy(stats, f"{tag}/{name}_stats", out)
    # the replicated-index steps, and the single-process cores on the
    # same rows
    idx = pm.replicate(mesh, index)
    res, stats = pm.sharded_align_step(mesh, P)(idx, words, len(g), *mine)
    _numpy((res, stats), f"{tag}/rep_se", out)
    _numpy(align_batch_core(idx, words, len(g), *mine, P),
           f"{tag}/core_se", out)
    res, stats = pm.sharded_all_step(mesh, P)(idx, words, len(g), *mine)
    _numpy((res, stats), f"{tag}/rep_all", out)
    _numpy(align_batch_all(idx, words, len(g), *mine, P),
           f"{tag}/core_all", out)
    mates = mine + [rows(a) for a in (mate2, lens, quals)]
    got = pm.sharded_paired_step(mesh, P)(idx, words, len(g), *mates)
    _numpy(got, f"{tag}/rep_pe", out)
    _numpy(align_paired_core(idx, words, len(g), *mates, P),
           f"{tag}/core_pe", out)


def run_rank(rank: int, port: int, outdir: str) -> None:
    """One rank of the spawn: the world mesh's cases, then (ranks 0 and 1)
    the subgroup's; writes ``rank<r>.npz``."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from nvbio_tpu_torch.parallel.dist import init_distributed
    from nvbio_tpu_torch.parallel.mesh import make_reads_mesh

    assert init_distributed(f"127.0.0.1:{port}", WORLD, rank)
    sub = dist.new_group(list(range(SUB)))
    data = dataset()
    out = {}
    _cases(make_reads_mesh(None, "cpu"), WORLD, data, out, steps=True)
    if rank < SUB:
        _cases(make_reads_mesh(sub, "cpu"), SUB, data, out, steps=False)
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()
