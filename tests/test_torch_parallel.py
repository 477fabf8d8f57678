"""Port parity of multi-GPU mapping: the reads mesh, the bucket-sharded
q-gram index, the genome-sliced FM index and the sharded pipeline steps.

The port runs as one ``torch.multiprocessing`` spawn of 4 gloo ranks on the
CPU (``tests/torch_parallel_ranks.py``: the world mesh, D = 4, and a
subgroup of ranks 0 and 1, D = 2), each rank writing its rows to an
``.npz``; the JAX package runs the same functions under ``jax.shard_map``
on 4 and 2 of conftest's 8 fake devices, traced on parallel threads while
the ranks work. Held exactly: ``shard_qgram_index`` (D = 2, 3, 4 and a
uint32-position index), ``sharded_lookup``, ``sharded_seed_hits``,
``shard_fmindex`` in every mode, the three sharded FM searches on reads
that straddle every seam (positions where valid: an invalid slot's
position is junk in either package, uint32 in JAX), and (D = 4) the
sharded single-end step with either sharded index (scan route on both sides: op
rows forward) on every field and stat. The replicated-index SE, PE and
``--all`` steps are held to the port's single-process cores on each rank's
rows, their stats to the sums: JAX's replicated step is that core under
``shard_map`` plus ``psum`` (``nvbio_tpu/parallel/mesh.py:26-38``)."""

import dataclasses
import importlib
import socket
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp
from jax.sharding import PartitionSpec

from nvbio_tpu import packed as jpacked
from nvbio_tpu.bowtie.params import MapParams as JMapParams
from nvbio_tpu.fmi import sharded as jfs
from nvbio_tpu.parallel import mesh as jmesh
from nvbio_tpu.parallel import sharded_index as jsi
from nvbio_tpu.qgram import QGramIndex as JQGramIndex
from nvbio_tpu.qgram import build_qgram_index as j_build_qgram
from nvbio_tpu_torch.fmi import sharded as tfs
from nvbio_tpu_torch.parallel import sharded_index as tsi
from nvbio_tpu_torch.qgram import QGramIndex as TQGramIndex
from nvbio_tpu_torch.qgram import build_qgram_index as t_build_qgram
from tests import torch_parallel_ranks as R

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

# ``nvbio_tpu_torch.fmi.rank`` is the function, as in ``nvbio_tpu.fmi``
rank_mod = importlib.import_module("nvbio_tpu_torch.fmi.rank")

SHARDED = PartitionSpec(jmesh.READS_AXIS)
MESHES = (R.WORLD, R.SUB)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _smap(D, fn):
    """``fn`` under ``shard_map`` over D devices, every argument and
    result sharded on the reads axis."""
    return jax.jit(jax.shard_map(fn, mesh=jmesh.make_reads_mesh(D),
                                 in_specs=SHARDED, out_specs=SHARDED,
                                 check_vma=False))


def _jax_cases(D, data):
    """The JAX package's answers at mesh size D (global arrays, rows in
    rank order)."""
    g, reads, _, lens, quals = data
    n = D * R.B_RANK
    reads, lens, quals = reads[:n], lens[:n], quals[:n]
    P = JMapParams(**R.PARAMS)
    q = P.qgram_q
    index = j_build_qgram(g, q)
    sq = jsi.shard_qgram_index(index, D)
    keys, slots = R.lookup_queries(q)
    out = {}
    out["lookup"], out["lookup_rs"] = _smap(
        D, lambda o, p, k, s: jsi.sharded_lookup(
            o, p, k, s, q=q, n_shards=D, keys_per_shard=sq.keys_per_shard))(
        sq.offsets, sq.positions, keys[:D * R.N_LOOKUP],
        slots[:D * R.N_LOOKUP])
    skeys, mut, seeds = R.seed_planes(reads, lens, q)
    for name, kk, H in (("hits", skeys, P.hits_per_seed), ("hits1", mut, 1)):
        out[name], out[f"{name}_rs"] = _smap(
            D, lambda s, k, H=H: jsi.sharded_seed_hits(s, k, H))(sq, kk)
    sf = jfs.shard_fmindex(g, D, overlap=R.OVERLAP)
    out["fm_hits"], out["fm_hits_v"], out["fm_hits_rs"] = _smap(
        D, lambda s, x: jfs.sharded_fmi_seed_hits(
            s, x, P.seed_len, P.hits_per_seed))(sf, seeds)
    wq, wl = R.whole_read_queries(reads, lens)
    out["fm_whole"], out["fm_whole_v"] = _smap(
        D, jfs.sharded_fmi_whole_read)(sf, wq, wl)
    out["fm_1mm"], out["fm_1mm_v"] = _smap(
        D, lambda s, x: jfs.sharded_fmi_seed_hits_1mm(s, x, P.seed_len))(
        sf, seeds)
    if D != R.WORLD:
        return jax.tree.map(np.asarray, out)

    mesh = jmesh.make_reads_mesh(D)
    words = jmesh.replicate(mesh, jnp.asarray(jpacked.pack(g, 2)))
    mine = [jmesh.shard_batch(mesh, jnp.asarray(a))
            for a in (reads, lens, quals)]
    fm_params = dataclasses.replace(P, seeding="fmi")
    for name, sidx, prm in (
            ("se_qgram", jsi.place_sharded_index(mesh, sq), P),
            ("se_fmi", jfs.place_sharded_fmindex(mesh, sf), fm_params)):
        out[name], out[f"{name}_stats"] = jmesh.sharded_align_step(
            mesh, prm, index_sharded=True)(sidx, words, jnp.int32(len(g)),
                                           *mine)
    return jax.tree.map(np.asarray, out)


def _spawn(tmp_dir):
    tmp.start_processes(R.run_rank, args=(_free_port(), str(tmp_dir)),
                        nprocs=R.WORLD, start_method="spawn")
    return [dict(np.load(tmp_dir / f"rank{r}.npz")) for r in range(R.WORLD)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port ranks' arrays, JAX answers by D), the JAX side traced while
    the ranks run."""
    data = R.dataset()
    with ThreadPoolExecutor(1 + len(MESHES)) as pool:
        ranks = pool.submit(_spawn, tmp_path_factory.mktemp("ranks"))
        jax_out = {D: pool.submit(_jax_cases, D, data) for D in MESHES}
        return ranks.result(), {D: f.result() for D, f in jax_out.items()}


def _port(runs, D, key):
    """The port's rows of a case at mesh size D, concatenated by rank."""
    ranks = runs[0][:D]
    return np.concatenate([r[f"D{D}/{key}"] for r in ranks])


# ---- host splits ----------------------------------------------------------

@pytest.mark.parametrize("D", [2, 3, 4])
def test_shard_qgram_index_key_for_key(D):
    g = R.dataset()[0]
    want = jsi.shard_qgram_index(j_build_qgram(g, 7), D)
    got = tsi.shard_qgram_index(t_build_qgram(g, 7), D)
    for f in ("q", "n_shards", "keys_per_shard", "pos_per_shard", "n"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.offsets.dtype == torch.int32
    np.testing.assert_array_equal(got.offsets.numpy(), want.offsets)
    np.testing.assert_array_equal(got.positions.numpy(), want.positions)
    if D == 3:   # 4^7 keys do not divide by 3: a ragged tail shard
        assert D * want.keys_per_shard > 1 << 14


def test_shard_qgram_index_uint32_positions():
    """Past 2^31 positions the JAX tables are uint32; the port's int64
    positions carry the same values."""
    idx = j_build_qgram(R.dataset()[0], 7)
    offs = idx.offsets.astype(np.uint32)
    pos = idx.positions.astype(np.uint32) + np.uint32(3 << 30)
    want = jsi.shard_qgram_index(JQGramIndex(7, offs, pos, (1 << 32) - 1), 4)
    got = tsi.shard_qgram_index(
        TQGramIndex.from_arrays(7, (1 << 32) - 1, offs, pos), 4)
    assert want.positions.dtype == np.uint32
    assert got.positions.dtype == torch.int64
    np.testing.assert_array_equal(got.offsets.numpy(), want.offsets)
    np.testing.assert_array_equal(got.positions.numpy(),
                                  want.positions.astype(np.int64))


@pytest.fixture(scope="module")
def jax_fm_slices():
    return jfs.shard_fmindex(R.dataset()[0], 4, overlap=R.OVERLAP)


@pytest.mark.parametrize("mode", ["host", "jobs2", "device", "resident"])
def test_shard_fmindex_every_mode(jax_fm_slices, mode):
    g = R.dataset()[0]
    seen = []
    kw = dict(host={}, jobs2=dict(jobs=2),
              device=dict(method="device", device="cpu"),
              resident=dict(method="device", device="cpu", resident=True,
                            on_slice=lambda d, s: seen.append(d)))[mode]
    got = tfs.shard_fmindex(g, 4, overlap=R.OVERLAP, **kw)
    want = jax_fm_slices
    for f in ("n_shards", "slice_len", "overlap", "n", "sa_interval"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.primary.numpy(), want.primary)
    np.testing.assert_array_equal(got.bwt_words.numpy().view(np.uint32),
                                  want.bwt_words)
    np.testing.assert_array_equal(got.ssa_marks.numpy().view(np.uint32),
                                  want.ssa_marks)
    for f in ("occ", "count", "ssa_cum", "ssa_vals"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(want, f), err_msg=f)
    full = want.slice_len + want.overlap
    for d in range(4):
        np.testing.assert_array_equal(
            got.rank_rows[d].numpy(), rank_mod.build_rank_rows(
                want.bwt_words[d], full, want.occ[d]))
    assert seen == ([0, 1, 2, 3] if mode == "resident" else [])


# ---- collectives over 4 and 2 ranks ----------------------------------------

@pytest.mark.parametrize("D", MESHES)
@pytest.mark.parametrize("case", ["lookup", "hits", "hits1"])
def test_sharded_qgram_lookups(runs, D, case):
    want = runs[1][D]
    for key in (case, f"{case}_rs"):
        np.testing.assert_array_equal(_port(runs, D, key), want[key],
                                      err_msg=key)
    if case == "hits1":   # the reseed plane reaches wide buckets
        assert (want["hits1_rs"] > 1).sum() > 0


@pytest.mark.parametrize("D", MESHES)
@pytest.mark.parametrize("case", ["fm_hits", "fm_whole", "fm_1mm"])
def test_sharded_fm_searches(runs, D, case):
    want = runs[1][D]
    valid = want[f"{case}_v"]
    np.testing.assert_array_equal(_port(runs, D, f"{case}_v"), valid)
    np.testing.assert_array_equal(
        np.where(valid, _port(runs, D, case), 0),
        np.where(valid, want[case].astype(np.int64), 0))
    if case == "fm_hits":
        np.testing.assert_array_equal(_port(runs, D, "fm_hits_rs"),
                                      want["fm_hits_rs"])
    # hits came from more than one slice, and the seam-straddling reads
    # (rows 0, 4, 8, ...) found their seam's slice
    slice_len = (R.GENOME_LEN + D - 1) // D
    assert len(np.unique(want[case][valid] // slice_len)) >= 2


@pytest.mark.parametrize("index", ["qgram", "fmi"])
def test_sharded_step_equals_jax(runs, index):
    D = R.WORLD
    name = f"se_{index}"
    want = runs[1][D]
    res, stats = want[name], want[f"{name}_stats"]
    for k in sorted(res):
        np.testing.assert_array_equal(_port(runs, D, f"{name}.{k}"), res[k],
                                      err_msg=k)
    for r in runs[0][:D]:
        for k in stats:
            assert int(r[f"D{D}/{name}_stats.{k}"]) == int(stats[k]), k
    # the 5-SNP reads (rows 5, 11, ...) map through the reseed pass
    assert res["mapped"][5::6].sum() >= len(res["mapped"][5::6]) - 1
    assert int(stats["n_mapped"]) >= D * R.B_RANK - 2


@pytest.mark.parametrize("step,stat_keys", [
    ("se", ("n_reads", "n_mapped", "n_unique", "sum_mapq")),
    ("all", ("n_reads", "n_alignments")),
    ("pe", ("n_pairs", "n_proper", "n_mapped"))])
def test_replicated_steps_equal_the_cores(runs, step, stat_keys):
    ranks, D = runs[0], R.WORLD
    n_out = 3 if step == "pe" else 1
    for r in ranks:
        core = {k[len(f"D{D}/core_{step}"):]: v for k, v in r.items()
                if k.startswith(f"D{D}/core_{step}")}
        for k, v in core.items():
            if n_out == 1:
                got = r[f"D{D}/rep_{step}[0]{k}"]
            else:
                got = r[f"D{D}/rep_{step}{k}"]
            np.testing.assert_array_equal(got, v, err_msg=f"{step}{k}")
    # the stats: every rank holds the sums of the cores' per-rank counts
    tot = dict.fromkeys(stat_keys, 0)
    for r in ranks:
        c = f"D{D}/core_{step}"
        if step == "se":
            m = r[f"{c}.mapped"]
            part = dict(n_reads=R.B_RANK, n_mapped=m.sum(),
                        n_unique=(m & ~r[f"{c}.has_second"]).sum(),
                        sum_mapq=r[f"{c}.mapq"].sum())
        elif step == "all":
            part = dict(n_reads=R.B_RANK, n_alignments=r[f"{c}.keep"].sum())
        else:
            part = dict(n_pairs=R.B_RANK, n_proper=r[f"{c}[2].proper"].sum(),
                        n_mapped=(r[f"{c}[0].mapped"]
                                  | r[f"{c}[1].mapped"]).sum())
        for k in stat_keys:
            tot[k] += int(part[k])
    stats_key = "[1]" if n_out == 1 else "[3]"
    for r in ranks:
        for k in stat_keys:
            assert int(r[f"D{D}/rep_{step}{stats_key}.{k}"]) == tot[k], k
    assert tot[stat_keys[1]] >= D * R.B_RANK // 2
