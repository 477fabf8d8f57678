"""The Q-Group index at q up to 16 and past 2^31 symbols (CPU).

The card builder's torch ops (``build_qgroup_index_device``, here on CPU
tensors) against the host builder and the JAX package's at q 8, 12 and 16,
with buckets and keys larger than a partition, and with q-grams over an N
left out; tables whose entries lie past 2^31 (uint32 bits in int32 tensors) read as
int64 through ``qgroup_range``, ``qgroup_locate`` and the mapper's
``_seed_loci``, and kept by ``save`` and ``load``; ``ReadMapper.build`` at
``qgram_q`` 16 and 12; the ``nvbio.qgroup`` spans; and a seeded map at q 16
judged by the benchmark's plain reference."""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nvbio_tpu.qgram import build_qgroup_index as j_build_qgroup
from nvbio_tpu_torch import packed
from nvbio_tpu_torch import qgram as tq
from nvbio_tpu_torch.bowtie import pipeline
from nvbio_tpu_torch.bowtie.params import MapParams
from nvbio_tpu_torch.io.reference import Reference
from nvbio_tpu_torch.utils import timers
from nvbio_tpu_torch.utils.simgenome import repeat_rich_genome, sample_reads

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLES = ("I", "S", "SS", "P")


def _words(codes):
    return packed.words_to_tensor(packed.pack(codes, 2), "cpu")


def test_packed_keys_equal_host_keys():
    """``packed_qgram_keys`` reads every q-gram of the packed text as
    ``qgram_keys`` does, for every q and every phase in a word."""
    codes = np.random.default_rng(1).integers(0, 4, 1003).astype(np.uint8)
    words = _words(codes)
    for q in range(1, 17):
        pos = torch.arange(len(codes) - q + 1)
        np.testing.assert_array_equal(
            tq.packed_qgram_keys(words, pos, q).numpy(),
            tq.qgram_keys(codes, q))


@pytest.mark.parametrize("q,n", [(8, 200_003), (12, 200_017), (16, 120_001)])
def test_card_builder_equals_host_and_jax(q, n):
    """The card builder's tables, in one step each and in many chunks and
    partitions, equal the host builder's and the JAX package's bit for
    bit."""
    codes = repeat_rich_genome(n, seed=q)
    want = j_build_qgroup(codes, q)
    host = tq.build_qgroup_index(codes, q)
    words = _words(codes)
    # at q 16 (4^16 keys, ~6 s a build here) the small steps alone
    steps = [dict(chunk=1 << 14, rows=1 << 12)] + ([{}] if q < 16 else [])
    for kw in steps:
        card = tq.build_qgroup_index_device(words, n, q, **kw)
        for name in TABLES:
            got = getattr(card, name)
            assert got.dtype == torch.int32
            assert torch.equal(got, getattr(host, name)), name
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(getattr(want, name)).view(np.int32))
    # one slot for each distinct key
    assert card.SS.shape[0] - 1 == len(np.unique(tq.qgram_keys(codes, q)))


@pytest.mark.parametrize("q", [8, 12, 16])
def test_card_builder_splits_large_buckets(q, monkeypatch):
    """Buckets, and single keys, of more positions than a partition's
    ``rows`` (a 3 kbp poly-A run and a 3 kbp (CA)n tandem): a bucket is
    split into its keys, a key over ``rows`` is a partition of its own, so
    no sort takes more than ``chunk`` or ``2 * rows`` rows; and the tables
    equal the host builder's."""
    codes = repeat_rich_genome(120_001, seed=3)
    codes[5000:8000] = 0
    codes[20000:23000:2], codes[20001:23000:2] = 1, 0
    host = tq.build_qgroup_index(codes, q)
    sorted_rows = []
    sort = torch.sort

    def counted(t, *args, **kw):
        sorted_rows.append(t.numel())
        return sort(t, *args, **kw)

    monkeypatch.setattr(torch, "sort", counted)
    card = tq.build_qgroup_index_device(_words(codes), len(codes), q,
                                        chunk=2048, rows=1024)
    assert 0 < max(sorted_rows) <= 2048
    for name in TABLES:
        assert torch.equal(getattr(card, name), getattr(host, name)), name


def _ref_with_n(codes, runs):
    """A one-contig ``Reference`` of ``codes`` with N runs [a, b) (folded
    to A, flagged in ``n_mask_words``)."""
    flags = np.zeros(len(codes), bool)
    for a, b in runs:
        flags[a:b] = True
    bits = np.zeros(-(-len(codes) // 32) * 32, bool)
    bits[:len(codes)] = flags
    return Reference(["g"], np.array([0, len(codes)], np.int64),
                     np.where(flags, 0, codes).astype(np.uint8),
                     np.packbits(bits, bitorder="little").view(np.uint32))


@pytest.mark.parametrize("q", [8, 16])
def test_builders_leave_out_q_grams_over_n(q):
    """With N runs (at both ends, across a mask word, inside) the host
    builder's ``n_flags`` and the card builder's ``n_mask`` leave out
    exactly the q-grams over an N: the rows are every other position in
    (key, position) order, and both builders' tables are equal."""
    ref = _ref_with_n(repeat_rich_genome(60_000, seed=9),
                      [(0, 5), (31, 33), (1000, 1400), (59_990, 60_000)])
    flags = ref.n_flags()
    npos = len(ref.codes) - q + 1
    over_n = np.lib.stride_tricks.sliding_window_view(flags, q).any(1)
    np.testing.assert_array_equal(
        tq.packed_has_n(ref.n_mask("cpu"), torch.arange(npos), q).numpy(),
        over_n)
    keys = tq.qgram_keys(ref.codes, q)
    clean = np.flatnonzero(~over_n)
    want = clean[np.lexsort((clean, keys[clean]))]
    host = tq.build_qgroup_index(ref.codes, q, n_flags=flags)
    np.testing.assert_array_equal(tq._u32(host.P).numpy(), want)
    card = tq.build_qgroup_index_device(
        _words(ref.codes), len(ref.codes), q, n_mask=ref.n_mask("cpu"),
        chunk=1 << 13, rows=1 << 11)
    for name in TABLES:
        assert torch.equal(getattr(card, name), getattr(host, name)), name


class Shifted:
    """A table of uint32 bits read as ``table`` moved up by ``at`` entries,
    each value increased by ``add``: entry j >= at is table[j - at] + add.
    It holds ``table`` alone, so a test can stand tables of 2^32 entries
    with values past 2^31 on the CPU."""

    def __init__(self, table: torch.Tensor, at: int, add: int):
        self.table, self.at, self.add = table, at, add
        self.shape = (at + table.shape[0],)

    def __getitem__(self, j):
        v = tq._u32(self.table[(j - self.at).clamp(min=0)]) + self.add
        return tq._bits32(v)


# positions past 2^31, and slots (S) and rows (SS) past 2^31
BASE = 2**31 + 12345
ROWS = 2**31 + 777
SLOTS = 2**31 + 99
N_FAR = 2**32 - 1


@pytest.fixture(scope="module")
def near_far():
    """A Q-Group index of a small genome, and the same index as if the
    genome's positions, its table's rows and its slots all lay past 2^31
    (``Shifted`` tables)."""
    codes = repeat_rich_genome(60_000, seed=4)
    near = tq.build_qgroup_index(codes, 10)
    far = tq.QGroupIndex(
        10, near.I, tq._bits32(tq._u32(near.S) + SLOTS),
        Shifted(tq._bits32(tq._u32(near.SS) + ROWS), SLOTS, 0),
        Shifted(tq._bits32(tq._u32(near.P) + BASE), ROWS, 0), N_FAR)
    return codes, near, far


def test_tables_past_2_31_read_as_uint32(near_far):
    codes, near, far = near_far
    keys = torch.from_numpy(tq.qgram_keys(codes, 10)[::97]).to(torch.int32)
    lo, hi = tq.qgroup_range(near, keys)
    flo, fhi = tq.qgroup_range(far, keys)
    assert flo.dtype == torch.int64 and (hi > lo).all()
    assert torch.equal(flo, lo + ROWS) and torch.equal(fhi, hi + ROWS)
    slot = (hi - lo) // 2
    pos = tq.qgroup_locate(near, lo, slot)
    fpos = tq.qgroup_locate(far, flo, slot)
    assert torch.equal(fpos, pos + BASE) and (fpos > 2**31).all()
    # a key not in the text: an empty range
    bits = (tq._u32(near.I)[:, None] >> torch.arange(32)) & 1
    absent = torch.nonzero(bits.reshape(-1) == 0)[:5, 0].to(torch.int32)
    assert len(absent) == 5
    alo, ahi = tq.qgroup_range(far, absent)
    assert (alo == ahi).all()


@pytest.mark.parametrize("mode", ["stratified", "1mm", "randomized"])
def test_seed_loci_past_2_31(near_far, mode):
    """The mapper's seeding stage over the far index: every window of the
    near index moved by the positions' offset (windows the genome's start
    clamps excepted), through the stratified slots, the 1-mismatch
    middle slots and the randomized draws."""
    codes, near, far = near_far
    L = 100
    reads, _, _ = sample_reads(codes, 64, L, seed=5, subst_rate=0.03)
    reads = torch.from_numpy(reads.astype(np.int32))
    lens = torch.full((64,), L, dtype=torch.int32)
    rc = pipeline.reverse_strand(reads, lens)
    params = MapParams(max_read_len=L, seed_len=16, seed_stride=10,
                       qgram_q=10, select_mode="randomized"
                       if mode == "randomized" else "stratified")
    args = (reads, rc, lens, params, 3, mode == "1mm")
    w0, valid, CH = pipeline._seed_loci(near, len(codes), *args)
    fw0, fvalid, fCH = pipeline._seed_loci(far, N_FAR, *args)
    assert CH == fCH and torch.equal(valid, fvalid)
    assert valid.sum() > 64 * 4
    inside = valid & (w0 > 0)
    assert torch.equal(fw0[inside], w0[inside] + BASE)
    assert (fw0[valid] >= BASE - L - params.max_dist).all()


def test_save_load_round_trip(tmp_path, near_far):
    """``save`` writes the JAX package's ``.qgroup.npz`` below 2^31 (int32
    tables) and uint32 tables from 2^31 symbols; ``load`` gives back the
    same bits either way."""
    codes, near, _ = near_far
    want = j_build_qgroup(codes, 10)
    near.save(str(tmp_path / "near.qgroup.npz"))
    z = np.load(tmp_path / "near.qgroup.npz")
    for name in TABLES:
        a = np.asarray(getattr(want, name))
        assert z[name].dtype == a.dtype
        np.testing.assert_array_equal(z[name], a)
    far = tq.QGroupIndex(10, near.I, tq._bits32(tq._u32(near.S) + SLOTS),
                         tq._bits32(tq._u32(near.SS) + ROWS),
                         tq._bits32(tq._u32(near.P) + BASE), 2**31 + 2**28)
    far.save(str(tmp_path / "far.qgroup.npz"))
    z = np.load(tmp_path / "far.qgroup.npz")
    assert z["P"].dtype == np.uint32 and int(z["P"].min()) >= BASE
    assert int(z["SS"][0]) == ROWS and int(z["S"][0]) == SLOTS
    back = tq.QGroupIndex.load(str(tmp_path / "far.qgroup.npz"))
    assert back.n == far.n and back.q == 10
    for name in TABLES:
        assert torch.equal(getattr(back, name), getattr(far, name)), name


def test_mapper_build_at_q16_and_q12():
    """``ReadMapper.build`` at ``qgram_q`` 16 holds the Q-Group index (the
    card builder's torch ops on the CPU: the host builder's tables), at 12
    the direct-address table as before; both leave out the q-grams over
    the genome's N run."""
    ref = _ref_with_n(repeat_rich_genome(40_000, seed=6), [(9000, 9100)])
    codes, flags = ref.codes, ref.n_flags()
    m16 = pipeline.ReadMapper.build(ref, MapParams(qgram_q=16),
                                    device="cpu")
    assert isinstance(m16.index, tq.QGroupIndex) and m16.index.q == 16
    want = tq.build_qgroup_index(codes, 16, n_flags=flags)
    assert want.P.shape[0] == len(codes) - 15 - 115
    for name in TABLES:
        assert torch.equal(getattr(m16.index, name), getattr(want, name))
    m12 = pipeline.ReadMapper.build(ref, MapParams(qgram_q=12),
                                    device="cpu")
    dense = tq.build_qgram_index(codes, 12, n_flags=flags)
    assert isinstance(m12.index, tq.QGramIndex) and m12.index.q == 12
    assert torch.equal(m12.index.positions, dense.positions)
    assert torch.equal(m12.index.offsets, dense.offsets)


def test_qgroup_spans_inside_seeding():
    """Under a profiler a Q-Group mapper's batch opens ``nvbio.qgroup``
    inside ``nvbio.seed``: the range and the slots on each pass, and the
    1-mismatch middle slots on the reseed pass; a q-gram table opens
    none."""
    codes = repeat_rich_genome(30_000, seed=7)
    ref = Reference(["g"], np.array([0, len(codes)], np.int64), codes, None)
    params = MapParams(max_read_len=80, seed_len=16, seed_stride=10,
                       max_dist=5, qgram_q=8)
    reads, _, _ = sample_reads(codes, 16, 80, seed=8, subst_rate=0.05)
    from nvbio_tpu_torch.io.fastq import ReadBatch

    batch = ReadBatch([f"r{i}" for i in range(16)], reads.astype(np.uint8),
                      np.full(reads.shape, 30, np.uint8),
                      np.full(16, 80, np.int32))
    for index, want in ((tq.build_qgroup_index(codes, 8), 5),
                        (tq.build_qgram_index(codes, 8), 0)):
        m = pipeline.ReadMapper.build(ref, params, index=index, device="cpu")
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            m.dispatch(batch)
        names = [ev.name for ev in prof.events()
                 if ev.name.startswith(timers.SPAN_PREFIX)]
        assert names.count("nvbio.qgroup") == want
        timers.reset_counters()


def test_seeded_map_at_q16_judged_correct():
    """The ``g3g-qgroup`` configuration, its genome cut to 300 kbp, and
    the ``se150`` traffic in batches of 200: the port's CPU map at q 16 is
    judged by the benchmark's plain reference within the cell's limits,
    with no wrong field."""
    from benchmark.harness import genome as genome_mod
    from benchmark.harness import traffic as traffic_mod
    from benchmark.harness.reference import Judge
    from benchmark.harness.runner import Window
    from benchmark.harness.system import System

    def load(*path):
        with open(os.path.join(REPO, "benchmark", *path)) as f:
            return json.load(f)

    cfg = load("configs", "g3g-qgroup.json")
    cfg["genome"].update(length=300_000, unique_prefix=65_536)
    tr = load("traffic", "se150.json")
    tr.update(batch=200, pool_batches=2, sample_per_batch=64)
    limits = load("limits", "g3g-qgroup-se150.json")
    seed = 2**33 + 22
    genome = genome_mod.make_genome(cfg["genome"], seed)
    pool = traffic_mod.make_pool(genome, tr, seed, "cpu")
    system = System(cfg, genome, torch.device("cpu"))
    system.build()
    assert isinstance(system.mapper.index, tq.QGroupIndex)
    win = Window(system, system.items(pool, "single"), pool, "single",
                 SimpleNamespace(config=cfg, traffic=tr), seed, False)
    win.sampling = True
    win.run(batches=2)
    samples = {k: np.concatenate([s[k] for s in win.samples])
               for k in win.samples[0]}
    unplaced = {k: np.concatenate([np.empty((0, 150), np.uint8)]
                                  + [u[k] for u in win.unplaced])
                for k in ("codes", "quals")}
    unplaced["reads"] = win.unplaced_reads
    verdict = Judge(genome, cfg, "cpu")(samples, "single", unplaced)
    assert verdict["wrong_fields"] == 0, verdict["examples"][:2]
    for name, limit in limits.items():
        if isinstance(limit, (int, float)):
            assert verdict[name] <= limit, (name, verdict[name])
    assert win.placed > 0.9 * win.reads
