"""Port parity of all-mapping (``--all``): nvbio_tpu_torch on the CPU
against nvbio_tpu's kernel path (Pallas in interpret mode) —
``align_batch_all`` and ``align_paired_all`` field by field,
``map_batch_all`` and ``map_pair_batch_all`` on SAM records, end-to-end
and local — on a genome with exact and near repeats, so reads and pairs
have several loci, and pair loci tie.

In local mode the port's paired-end CIGARs carry the mates' soft clips,
which the JAX package leaves out; the records are otherwise identical."""

import re
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvbio_tpu.alphabet import Alphabet, codes_to_string
from nvbio_tpu.bowtie import paired as jpaired
from nvbio_tpu.bowtie import pipeline as jpipe
from nvbio_tpu.bowtie.params import MapParams as JMapParams
from nvbio_tpu.io.fastq import batch_from_records as j_batch
from nvbio_tpu.io.reference import Reference as JReference
from nvbio_tpu_torch.bowtie import paired as tpaired
from nvbio_tpu_torch.bowtie import pipeline as tpipe
from nvbio_tpu_torch.bowtie.params import MapParams as TMapParams
from nvbio_tpu_torch.io.fastq import batch_from_records as t_batch
from nvbio_tpu_torch.io.reference import Reference as TReference
from nvbio_tpu_torch.utils.simgenome import sample_pairs
from tests.jax_kernel_path import kernel_path

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

L = 80
PARAMS = dict(max_read_len=L, seed_len=16, seed_stride=10, hits_per_seed=4,
              max_dist=5, maxins=400)
RUNS = [(kind, mode) for kind in ("se", "pe") for mode in ("e2e", "local")]


def all_dataset(seed=23, n=60):
    """Two contigs over a 40 kbp genome in which 1.5 kbp at 3000 recurs
    exactly at 25000 and with 3 substitutions at 31000; single-end reads
    (a third from the repeat, 1% substitutions, a 1 bp deletion in some,
    odd reads reverse-complemented, one read N in every seventh) and FR
    pairs (half inside the repeat, so their two pair loci tie)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, 40000).astype(np.uint8)
    codes[25000:26500] = codes[3000:4500]
    codes[31000:32500] = codes[3000:4500]
    codes[[31200, 31700, 32300]] = (codes[[31200, 31700, 32300]] + 1) % 4
    recs = [("c1", codes_to_string(codes[:22000])),
            ("c2", codes_to_string(codes[22000:]))]

    def quals():
        return "".join(chr(33 + int(x)) for x in rng.integers(2, 41, L))

    reads = []
    for i in range(n):
        p = int(rng.integers(3000, 4400) if i % 3 == 0
                else rng.integers(0, 40000 - L - 2))
        r = codes[p:p + L + 1].astype(np.int32)
        if i % 5 == 2:
            r = np.delete(r, 37)
        r = r[:L]
        sub = rng.random(L) < 0.01
        r = np.where(sub, (r + 1) % 4, r)
        s = codes_to_string(r.astype(np.uint8))
        if i % 7 == 0:
            s = s[:20] + "N" + s[21:]
        if i % 2:
            s = s[::-1].translate(str.maketrans("ACGTN", "TGCAN"))
        reads.append((f"r{i}_{p}", s, quals()))

    half = n // 2
    r1a, r2a, *_ = sample_pairs(codes[3000:4500], half, L, 150, 350,
                                seed=seed, subst_rate=0.0)
    r1b, r2b, *_ = sample_pairs(codes, n - half, L, 150, 350, seed=seed + 1,
                                subst_rate=0.01)
    r1, r2 = np.concatenate([r1a, r1b]), np.concatenate([r2a, r2b])
    mates = tuple(
        [(f"p{i}", codes_to_string(np.asarray(x[i], np.uint8)), quals())
         for i in range(n)] for x in (r1, r2))
    return recs, reads, mates


def _params(pkg, mode):
    if pkg == "jax":
        cls, kw = JMapParams, dict(PARAMS, extension="pallas")
    else:
        cls, kw = TMapParams, dict(PARAMS)
    return cls.local(**kw) if mode == "local" else cls(**kw)


def _jax_run(dataset, kind, mode):
    recs, reads, (m1, m2) = dataset
    jm = jpipe.ReadMapper.build(JReference.from_records(recs),
                                _params("jax", mode))
    if kind == "se":
        jb = j_batch(reads, L, Alphabet.DNA_N)
        res = jpipe.align_batch_all(
            jm.index, jm.genome_words, jm.n_genome_dev,
            jnp.asarray(jb.codes.astype(np.int32)), jnp.asarray(jb.lengths),
            jnp.asarray(jb.quals), jm.params)
        sam = jm.map_batch_all(jb)
    else:
        jb1, jb2 = (j_batch(r, L, Alphabet.DNA_N) for r in (m1, m2))
        res = jpaired.align_paired_all(
            jm.index, jm.genome_words, jm.n_genome_dev,
            *(jnp.asarray(x) for b in (jb1, jb2)
              for x in (b.codes, b.lengths, b.quals)), jm.params)
        sam = jpaired.map_pair_batch_all(jm, jb1, jb2)
    return jax.device_get(res), [r.line() for r in sam]


@pytest.fixture(scope="module")
def dataset():
    return all_dataset()


@pytest.fixture(scope="module")
def jax_runs(dataset):
    """The four JAX runs, traced and compiled on parallel threads."""
    with kernel_path(), ThreadPoolExecutor(len(RUNS)) as pool:
        futures = {r: pool.submit(_jax_run, dataset, *r) for r in RUNS}
        return {r: f.result() for r, f in futures.items()}


@pytest.fixture(scope="module", params=RUNS, ids=lambda r: "-".join(r))
def mapped(request, dataset, jax_runs):
    kind, mode = request.param
    recs, reads, (m1, m2) = dataset
    tm = tpipe.ReadMapper.build(TReference.from_records(recs),
                                _params("torch", mode), device="cpu")
    if kind == "se":
        tb = t_batch(reads, L, Alphabet.DNA_N)
        res = tm.dispatch_all(tb)
        sam = tm.format_batch_all(tb, res)
    else:
        tb1, tb2 = (t_batch(r, L, Alphabet.DNA_N) for r in (m1, m2))
        res = tpaired.dispatch_pair_batch_all(tm, tb1, tb2)
        sam = tpaired.format_pair_batch_all(tm, tb1, tb2, res)
    jres, jsam = jax_runs[request.param]
    return dict(kind=kind, mode=mode, jres=jres, tres=res, jsam=jsam,
                tsam=[r.line() for r in sam])


def _assert_fields_equal(td, jd, what):
    for k in sorted(jd):
        if isinstance(jd[k], dict):
            _assert_fields_equal(td[k], jd[k], f"{what}.{k}")
            continue
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]),
                                      err_msg=f"{what}.{k}")


def test_align_all_field_by_field(mapped):
    jres, tres = mapped["jres"], mapped["tres"]
    assert set(jres) <= set(tres)
    _assert_fields_equal(tres, jres, mapped["kind"])   # ops: END->START
    keep = tres["keep"].numpy()
    assert (keep.sum(axis=1) >= 2).sum() >= 5      # reads with secondaries
    if mapped["kind"] == "pe":
        # the pairs inside the repeat: their first two slots tie, each at
        # its own locus, in the order jax.lax.top_k gives them
        ps = tres["pair_score"].numpy()
        ties = keep[:, 1] & (ps[:, 0] == ps[:, 1])
        assert ties[:30].sum() >= 15


def _cigar_query_len(cigar):
    return sum(int(n) for n, op in re.findall(r"(\d+)([MIS=X])", cigar))


def test_map_all_sam_identical(mapped):
    jsam, tsam = mapped["jsam"], mapped["tsam"]
    assert len(tsam) == len(jsam)
    if mapped["kind"] == "pe" and mapped["mode"] == "local":
        for t, j in zip(tsam, jsam):   # all but the port's soft clips
            tf, jf = t.split("\t"), j.split("\t")
            assert tf[:5] + tf[6:] == jf[:5] + jf[6:]
            assert re.sub(r"^\d+S|\d+S$", "", tf[5]) == jf[5]
    else:
        assert tsam == jsam
    flags = [int(line.split("\t")[1]) for line in tsam]
    assert sum(f & 0x100 != 0 for f in flags) >= 10       # secondaries
    for line in tsam:
        f = line.split("\t")
        if f[5] != "*" and f[9] != "*":
            assert _cigar_query_len(f[5]) == len(f[9]), line


def test_top_k_stable_orders_ties_like_lax_top_k(rng):
    """Rows of tied values (NEG_INF cells and equal pair sums): the port's
    top-K gives jax.lax.top_k's values and indices."""
    x = rng.integers(-3, 3, size=(64, 100)).astype(np.int32) * 10
    x[:, ::3] = -(1 << 24)
    x[:8] = -(1 << 24)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 4)
    got_v, got_i = tpaired.top_k_stable(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
