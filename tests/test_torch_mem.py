"""Port parity of ``mem`` (CPU): nvbio_tpu_torch's SMEM search, anchor
chaining, ``mem_align_core``, ``MemMapper.map_batch`` and the ``mem``
command line against nvbio_tpu's, with no tolerance (integer outputs).

The JAX pipeline picks its local traceback by backend
(``nvbio_tpu/mem/pipeline.py:100-108`` and ``:183``): the Pallas kernel
walk (K2-LOCAL, ops END->START) where ``jax.default_backend() == "tpu"``,
else the scan walk. The port always runs K2-LOCAL, so it is held to the
kernel branch: ``mem_kernel_branch()`` gives the pipeline's module a
``jax`` whose ``default_backend()`` says ``"tpu"`` and runs the Pallas
entry points in interpret mode (``tests/jax_kernel_path.py``); nothing in
``nvbio_tpu`` changes. On this file's reads the CPU (scan) branch writes
the same records as the kernel branch (``test_cpu_branch_agrees``)."""

import contextlib
import importlib
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvbio_tpu.alphabet import Alphabet, codes_to_string
from nvbio_tpu.io.fastq import ReadBatch as JBatch
from nvbio_tpu.io.reference import Reference as JReference
from nvbio_tpu_torch.fmi import index as tidx
from nvbio_tpu_torch.fmi import mem as tmem
from nvbio_tpu_torch.io.fastq import ReadBatch as TBatch
from nvbio_tpu_torch.io.reference import Reference as TReference
from nvbio_tpu_torch.mem import chain as tchain
from nvbio_tpu_torch.mem import pipeline as tpipe
from tests.jax_kernel_path import kernel_path

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

# ``nvbio_tpu.fmi`` and ``nvbio_tpu.mem`` re-export names of their modules
jidx = importlib.import_module("nvbio_tpu.fmi.index")
jmem = importlib.import_module("nvbio_tpu.fmi.mem")
jchain = importlib.import_module("nvbio_tpu.mem.chain")
jpipe = importlib.import_module("nvbio_tpu.mem.pipeline")

L = 80             # max_read_len
MAX_DIST = 8       # band 17
N_READS = 37       # in batches of BATCH: the last one padded
BATCH = 24         # not a multiple of 1024
CLI_FLAGS = ("--batch", str(BATCH), "--max-read-len", str(L), "-k", "15",
             "--max-dist", str(MAX_DIST))


class _TpuBackend:
    """``jax`` as the mem pipeline sees it on the accelerator: its
    ``default_backend()`` is ``"tpu"``; everything else is jax's."""

    def __getattr__(self, name):
        return getattr(jax, name)

    def default_backend(self):
        return "tpu"


@contextlib.contextmanager
def mem_kernel_branch():
    """Run ``nvbio_tpu.mem`` down its kernel branch on the CPU. The jitted
    ``mem_align_core`` is cleared on entry and exit: another file may have
    traced the same shapes down the scan branch in this process."""
    jpipe.mem_align_core.clear_cache()
    try:
        with kernel_path(), pytest.MonkeyPatch.context() as mp:
            mp.setattr(jpipe, "jax", _TpuBackend())
            yield
    finally:
        jpipe.mem_align_core.clear_cache()


def _genome(seed=21, n=12000):
    return np.random.default_rng(seed).integers(0, 4, n).astype(np.uint8)


def _dup_genome():
    """The 12 kbp genome with its 300-base segment at 2000 copied to 6000,
    so reads from it have two loci (secondaries and XA)."""
    g = _genome()
    return np.concatenate([g[:6000], g[2000:2300], g[6000:]])


def _reads(genome, n=N_READS, seed=5):
    """Reads of 40-80 bases with 2% substitutions: every fifth from the
    duplicated segment, every third with a random 20-base tail, every
    other one reverse-complemented; random qualities."""
    rng = np.random.default_rng(seed)
    codes = np.zeros((n, L), np.uint8)
    lens = np.zeros(n, np.int32)
    for i in range(n):
        ln = int(rng.integers(40, L + 1))
        p = int(rng.integers(0, len(genome) - ln))
        if i % 5 == 0:
            p = 6000 + int(rng.integers(0, 300 - ln))
        r = genome[p:p + ln].copy()
        sub = rng.random(ln) < 0.02
        r[sub] = (r[sub] + 1) % 4
        if i % 3 == 0:
            r[-20:] = rng.integers(0, 4, 20)
        if i % 2:
            r = 3 - r[::-1]
        codes[i, :ln] = r
        lens[i] = ln
    quals = rng.integers(2, 41, (n, L)).astype(np.uint8)
    return [f"q{i}" for i in range(n)], codes, quals, lens


@pytest.fixture(scope="module")
def indexes():
    """(genome, JAX FM index of the reversed genome on its device path,
    the port's) of the 12 kbp genome, and the same of the genome with a
    400-base segment appended again (threshold k-MEMs with two loci)."""
    out = {}
    g = _genome()
    for name, text in (("plain", g), ("rep", np.concatenate(
            [g, g[1000:1400]]))):
        rev = text[::-1].copy()
        out[name] = (text, jidx.build_fmindex(rev).device(),
                     tidx.build_fmindex(rev))
    return out


def _smem_reads(genome, seed):
    """24 reads of up to 60 bases: genome windows with a substitution at 30
    (two long SMEMs), windows with substitutions every 7 bases, random
    reads (many short maximal matches: past the 16 slots at min_len 5) and
    ragged lengths, some 0."""
    rng = np.random.default_rng(seed)
    R, W = 24, 60
    reads = rng.integers(0, 4, (R, W)).astype(np.int32)
    for i in range(12):
        p = int(rng.integers(0, len(genome) - W))
        reads[i] = genome[p:p + W]
        reads[i, 30] = (reads[i, 30] + 1) % 4
        if i % 3 == 0:
            reads[i, 3::7] = (reads[i, 3::7] + 2) % 4
    lens = np.full(R, W, np.int32)
    lens[18:] = rng.integers(0, W, R - 18)
    lens[23] = 0
    return reads, lens


def _jnp(*xs):
    return [jnp.asarray(x) for x in xs]


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _assert_fields_equal(jres, tres):
    for f in jres._fields:
        assert np.array_equal(np.asarray(getattr(jres, f)),
                              getattr(tres, f).numpy()), f


@pytest.mark.parametrize("min_intv", [1, 2, 3])
def test_smem_extend_lengths(indexes, min_intv):
    text, jf, tf = indexes["rep"]
    reads, lens = _smem_reads(text, seed=min_intv)
    want = jmem.smem_extend_lengths(jf, *_jnp(reads, lens), min_intv=min_intv)
    got = tmem.smem_extend_lengths(tf, *_t(reads, lens), min_intv=min_intv)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("min_len,slots,hits", [(19, 16, 4), (5, 16, 4),
                                                (12, 3, 2)])
def test_find_smems_batch(indexes, min_len, slots, hits):
    text, jf, tf = indexes["plain"]
    reads, lens = _smem_reads(text, seed=min_len)
    want = jmem.find_smems_batch(jf, *_jnp(reads, lens), min_len=min_len,
                                 max_smems=slots, hits_per_smem=hits)
    got = tmem.find_smems_batch(tf, *_t(reads, lens), min_len=min_len,
                                max_smems=slots, hits_per_smem=hits)
    _assert_fields_equal(want, got)
    if min_len == 5:
        assert (got.overflow > 0).sum() >= 6   # reads past the S slots


@pytest.mark.parametrize("min_intv", [2, 3])
def test_find_threshold_kmems_batch(indexes, min_intv):
    text, jf, tf = indexes["rep"]
    reads, lens = _smem_reads(text, seed=7)
    reads[0] = text[1100:1160]                  # inside the repeat
    lens[0] = 60
    kw = dict(min_len=10, min_intv=min_intv, max_mems=8, hits_per_mem=4)
    want = jmem.find_threshold_kmems_batch(jf, *_jnp(reads, lens), **kw)
    got = tmem.find_threshold_kmems_batch(tf, *_t(reads, lens), **kw)
    _assert_fields_equal(want, got)
    assert bool(got.valid[0].any())


def _anchors(seed, B=40, A=64):
    """Anchors on a small grid, so scores tie and spans overlap: qbeg in
    [0, 60), lengths 15-30, tpos on a few diagonals near three loci, about
    a quarter invalid (with tpos 0, as the SMEM stage leaves them). In
    every other row the first 24 anchors lie on one exact diagonal (a
    strong chain), so the other loci's chains score below half of it and
    the overlap filter drops them."""
    rng = np.random.default_rng(seed)
    qbeg = rng.integers(0, 60, (B, A)).astype(np.int32)
    qend = (qbeg + rng.integers(15, 31, (B, A))).astype(np.int32)
    loci = rng.integers(0, 5000, (B, 3))
    pick = loci[np.arange(B)[:, None], rng.integers(0, 3, (B, A))]
    tpos = (pick + qbeg + rng.integers(-3, 4, (B, A))).astype(np.int32)
    valid = rng.random((B, A)) < 0.75
    strong = np.arange(24) * 3
    qbeg[::2, :24] = strong
    qend[::2, :24] = strong + 20
    tpos[::2, :24] = loci[::2, :1] + 7000 + strong
    valid[::2, :24] = True
    tpos = np.where(valid, tpos, 0).astype(np.int32)
    return qbeg, qend, tpos, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_chain_anchors(seed):
    qbeg, qend, tpos, valid = _anchors(seed)
    want = jchain.chain_anchors(*_jnp(qbeg, qend, tpos, valid))
    args = _t(qbeg, qend, tpos, valid)
    keep = [a.clone() for a in args]
    got = tchain.chain_anchors(*args)
    _assert_fields_equal(want, got)
    assert all(torch.equal(a, b) for a, b in zip(args, keep))


@pytest.mark.parametrize("seed,k", [(0, 2), (1, 3), (2, 4)])
def test_chain_anchors_topk(seed, k):
    qbeg, qend, tpos, valid = _anchors(seed)
    want = jchain.chain_anchors_topk(*_jnp(qbeg, qend, tpos, valid), k)
    got = tchain.chain_anchors_topk(*_t(qbeg, qend, tpos, valid), k)
    _assert_fields_equal(want, got)
    # the overlap filter dropped chains of the strong rows
    assert not bool(got.valid[::2, 1:].all())


def _params(pkg):
    cls = jpipe.MemParams if pkg == "jax" else tpipe.MemParams
    return cls(max_read_len=L, min_seed_len=15, max_dist=MAX_DIST)


def _batches(batch):
    """The reads in batches of BATCH, the last padded with zero-length
    reads as ``fastq_batches`` pads it: every JAX call of this file (and
    the ``mem`` app's in ``test_mem_cli``) sees the same shapes, so each
    branch of ``mem_align_core`` is traced once."""
    names, codes, quals, lens = batch
    for i in range(0, len(names), BATCH):
        pad = BATCH - len(names[i:i + BATCH])
        yield (names[i:i + BATCH] + [""] * pad,
               *(np.pad(x[i:i + BATCH], ((0, pad),) + ((0, 0),) * (x.ndim - 1))
                 for x in (codes, quals, lens)))


def _fields(results):
    """Each field's rows of every batch, concatenated."""
    return {k: np.concatenate([np.asarray(r[k]) for r in results])
            for k in results[0]}


def _jax_map(recs, batch):
    """The JAX mapper over the batches: (mem_align_core's fields, SAM
    lines)."""
    jm = jpipe.MemMapper.build(JReference.from_records(recs),
                               _params("jax"))
    sam, res = [], []
    for b in _batches(batch):
        sam += [r.line() for r in jm.map_batch(JBatch(*b))]
        res.append(jpipe.mem_align_core(
            jm.fmi_rev, jm.genome_words, jnp.int32(jm.n_genome),
            jnp.asarray(b[1]), jnp.asarray(b[3]), jm.params))
    return _fields(res), sam


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    g = _dup_genome()
    recs = [("chrD", codes_to_string(g, Alphabet.DNA))]
    batch = _reads(g)
    tmp = tmp_path_factory.mktemp("mem")
    (tmp / "ref.fa").write_text(f">chrD\n{recs[0][1]}\n")
    names, codes, quals, lens = batch
    (tmp / "reads.fq").write_text("".join(
        f"@{n}\n{codes_to_string(codes[i, :lens[i]], Alphabet.DNA)}\n+\n"
        f"{(quals[i, :lens[i]] + 33).tobytes().decode()}\n"
        for i, n in enumerate(names)))
    return recs, batch, tmp


@pytest.fixture(scope="module")
def jax_runs(dataset):
    """The JAX kernel branch's mem_align_core fields and SAM records, then
    its ``mem`` command line on the same batches (the trace reused), then
    the CPU (scan) branch's."""
    from nvbio_tpu.__main__ import main

    recs, batch, tmp = dataset
    with mem_kernel_branch():
        kernel = _jax_map(recs, batch)
        assert main(["mem", str(tmp / "ref.fa"), str(tmp / "reads.fq"),
                     "-o", str(tmp / "jax.sam"), *CLI_FLAGS]) == 0
    jpipe.mem_align_core.clear_cache()
    scan = _jax_map(recs, batch)
    jpipe.mem_align_core.clear_cache()
    return kernel, scan


@pytest.fixture(scope="module")
def port_run(dataset):
    recs, batch, _ = dataset
    tm = tpipe.MemMapper.build(TReference.from_records(recs),
                               _params("torch"), device="cpu")
    sam, res = [], []
    for b in _batches(batch):
        sam += [r.line() for r in tm.map_batch(TBatch(*b))]
        res.append({k: v.numpy() for k, v in tm.dispatch(TBatch(*b)).items()})
    return _fields(res), sam


def test_mem_align_core_fields(dataset, jax_runs, port_run):
    (jres, _), _ = jax_runs
    tres, _ = port_run
    lens = np.concatenate([b[3] for b in _batches(dataset[1])])
    assert set(jres) == set(tres)
    for k in jres:
        want, got = jres[k], tres[k]
        if k == "rc_reads":   # the JAX reversal leaves the tail undefined
            inside = np.arange(L)[None, :] < lens[:, None]
            want, got = want * inside, got * inside
        assert want.shape == got.shape, k
        assert np.array_equal(want, got), k


def test_map_batch_records(jax_runs, port_run):
    (_, want), _ = jax_runs
    _, got = port_run
    assert got == want
    recs = [ln.split("\t") for ln in got]
    assert sum(int(r[1]) & 0x100 > 0 for r in recs) >= 3      # secondaries
    assert any(t.startswith("XA:Z:") for r in recs for t in r[11:])
    assert sum("S" in r[5] for r in recs) >= 8                 # soft clips
    assert sum(int(r[1]) & 0x4 > 0 for r in recs) >= 1         # unmapped


def test_cpu_branch_agrees(jax_runs):
    """On these reads the JAX CPU branch (scan walk, ops START->END) and
    its kernel branch write the same records and every field but the op
    order."""
    (kres, ksam), (sres, ssam) = jax_runs
    assert ssam == ksam
    for k in kres:
        if k != "ops":
            assert np.array_equal(kres[k], sres[k]), k
    n = kres["n_ops"]
    for b, c in zip(*np.nonzero(n)):
        m = n[b, c]
        assert np.array_equal((kres["ops"][b, c, :m] & 3)[::-1],
                              sres["ops"][b, c, :m] & 3), (b, c)


def test_mem_cli(dataset, jax_runs, monkeypatch):
    from nvbio_tpu_torch.__main__ import main

    _, _, tmp = dataset
    monkeypatch.setattr(sys, "stderr", io.StringIO())
    assert main(["mem", str(tmp / "ref.fa"), str(tmp / "reads.fq"), "-o",
                 str(tmp / "port.sam"), *CLI_FLAGS, "--device", "cpu"]) == 0

    def lines(name):
        return [ln for ln in (tmp / name).read_text().splitlines()
                if not ln.startswith("@PG")]

    want = lines("jax.sam")
    assert sum(not ln.startswith("@") for ln in want) >= N_READS
    assert lines("port.sam") == want


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_mem_needs_a_card_unless_asked():
    ref = TReference.from_records([("c", "ACGT" * 50)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.MemMapper.build(ref, _params("torch"))
