"""Port parity of mapping at any band and of mate rescue at any read width:
the packed-window entries of K4 (``myers_semiglobal_windows``) and K3
(``banded_score_windows``) against the contract forms and the Pallas
kernels in interpret mode, K4's plain version at wide patterns and other
alphabets, the single-end mapper at max_dist 1 and 10, and the paired-end
mapper with rescue at 150-base reads, each against nvbio_tpu's kernel path
on the CPU. Integer outputs and SAM records: exactly equal (the PE-local
CIGARs with the soft clips the port adds, as test_torch_paired.py states)."""

import re
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvbio_tpu import packed as jpacked
from nvbio_tpu.align.pallas_kernels import (
    banded_score_semiglobal_pallas,
    myers_semiglobal_pallas,
)
from nvbio_tpu.align.types import GotohScoring as JScoring
from nvbio_tpu.alphabet import Alphabet, codes_to_string
from nvbio_tpu.bowtie import paired as jpaired
from nvbio_tpu.bowtie.params import MapParams as JMapParams
from nvbio_tpu.bowtie.pipeline import ReadMapper as JReadMapper
from nvbio_tpu.io.fastq import batch_from_records as j_batch
from nvbio_tpu.io.reference import Reference as JReference
from nvbio_tpu_torch.align import kernels as K
from nvbio_tpu_torch.align.types import GotohScoring
from nvbio_tpu_torch.bowtie import paired as tpaired
from nvbio_tpu_torch.bowtie.params import MapParams as TMapParams
from nvbio_tpu_torch.bowtie.pipeline import ReadMapper as TReadMapper
from nvbio_tpu_torch.io.fastq import batch_from_records as t_batch
from nvbio_tpu_torch.io.reference import Reference as TReference
from nvbio_tpu_torch.packed import extract_window, pack, words_to_tensor
from nvbio_tpu_torch.utils.simgenome import sample_pairs
from tests.jax_kernel_path import kernel_path

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

SW = (0, -6, -8, -3, -8, -3)       # bowtie2 end-to-end
LOCAL = (2, -6, -8, -3, -8, -3)    # bowtie2 --local


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.int32)


def _genome_windows(rng, B, M, T, n=3000):
    """A packed genome of n symbols (its last word part-filled), window
    starts of which the first eight run past its end (past its last word
    too), patterns planted in half the windows with a few substitutions,
    ragged lengths."""
    genome = rng.integers(0, 4, size=n, dtype=np.uint8)
    words = pack(genome, 2)
    starts = rng.integers(0, n - T, size=B)
    starts[:8] = n - rng.integers(1, T, size=8)
    starts[0] = n - 1
    pats = rng.integers(0, 4, size=(B, M))
    for b in range(8, B, 2):
        s = int(starts[b] + rng.integers(0, T - M))
        pats[b] = genome[s:s + M]
    pats = np.where(rng.random((B, M)) < 0.03, (pats + 1) % 4, pats)
    plens = rng.integers(M // 2, M + 1, size=B)
    plens[8:11] = [0, 1, M]
    tlens = np.minimum(n - starts, T)
    tlens[11:14] = [0, 3, T]
    tlens[0] = T                       # past the genome's last word
    return words, starts, pats, plens, tlens


def _jax_windows(words, starts, T):
    return np.asarray(jpacked.extract_window_aligned(
        jnp.asarray(words), jnp.asarray(starts, np.int32), T, 2))


@pytest.mark.parametrize("M", [60, 150])
def test_myers_windows_plain_matches_contract_and_pallas(rng, M):
    B, T = 40, M + 90
    words, starts, pats, plens, tlens = _genome_windows(rng, B, M, T)
    tw = words_to_tensor(words, "cpu")
    st = torch.from_numpy(starts)
    got = K.myers_semiglobal_windows(_t(pats), _t(plens), tw, st, _t(tlens),
                                     T)
    win = extract_window(tw, st, T)
    np.testing.assert_array_equal(win.numpy(), _jax_windows(words, starts, T))
    contract = K.myers_semiglobal(_t(pats), _t(plens), win, _t(tlens))
    want = myers_semiglobal_pallas(jnp.asarray(pats), jnp.asarray(plens),
                                   jnp.asarray(win.numpy()),
                                   jnp.asarray(tlens), interpret=True)
    for g, c, w in zip(got, contract, want):
        np.testing.assert_array_equal(g.numpy(), c.numpy())
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0].numpy()[8::2] <= 8).mean() >= 0.5   # the planted copies


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("with_mm", [False, True])
def test_banded_score_windows_plain_matches_contract_and_pallas(
        rng, local, with_mm):
    B, M, W = 40, 50, 21
    TW = M + W - 1
    words, starts, pats, plens, tlens = _genome_windows(rng, B, M, TW)
    pats[rng.random((B, M)) < 0.02] = 4                 # read Ns
    mm = -rng.integers(1, 7, size=(B, M)) if with_mm else None
    sc = LOCAL if local else SW
    tw = words_to_tensor(words, "cpu")
    st = torch.from_numpy(starts)
    tmm = None if mm is None else _t(mm)
    got = K.banded_score_windows(_t(pats), _t(plens), tw, st, _t(tlens),
                                 GotohScoring(*sc), W, tmm, local=local)
    win = extract_window(tw, st, TW)
    contract = K.banded_score(_t(pats), _t(plens), win, _t(tlens),
                              GotohScoring(*sc), W, tmm, local=local)
    want = banded_score_semiglobal_pallas(
        jnp.asarray(pats), jnp.asarray(plens),
        jnp.asarray(_jax_windows(words, starts, TW)), jnp.asarray(tlens),
        JScoring(*sc), W, None if mm is None else jnp.asarray(mm),
        block=128, interpret=True, local=local)
    for g, c, w in zip(got, contract, want):
        np.testing.assert_array_equal(g.numpy(), c.numpy())
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("M,n_symbols", [(150, 4), (256, 4), (150, 5),
                                         (256, 21)])
def test_myers_plain_matches_pallas_at_wide_patterns_and_alphabets(
        rng, M, n_symbols):
    """5 and 8 words; protein-sized alphabets (codes outside 1..n-1 read
    as 0 in the text, outside 0..n-1 match nothing in the pattern)."""
    B, T = 24, M + 70
    pats = rng.integers(0, n_symbols + 1, size=(B, M)).astype(np.int32)
    txts = rng.integers(0, n_symbols + 2, size=(B, T)).astype(np.int32)
    for b in range(0, B, 2):
        s = int(rng.integers(0, T - M))
        txts[b, s:s + M] = pats[b]
    plens = rng.integers(M // 2, M + 1, size=B).astype(np.int32)
    plens[[1, 3]] = [0, 33]
    tlens = rng.integers(M // 2, T + 1, size=B).astype(np.int32)
    tlens[5] = 0
    want = myers_semiglobal_pallas(
        jnp.asarray(pats), jnp.asarray(plens), jnp.asarray(txts),
        jnp.asarray(tlens), n_symbols=n_symbols, interpret=True)
    got = K.myers_semiglobal(_t(pats), _t(plens), _t(txts), _t(tlens),
                             n_symbols=n_symbols)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert K.myers_route(M, n_symbols) == (
        "registers" if n_symbols == 4 else "generic")


# ---------------------------------------------------------------------------
# the mappers
# ---------------------------------------------------------------------------

SE_L = 80
SE_PARAMS = dict(max_read_len=SE_L, seed_len=16, seed_stride=10,
                 hits_per_seed=4)


def _se_dataset(seed=15, n_reads=90):
    """One contig; reads exact, with 3 SNPs, a 1-2 bp deletion or
    insertion, or random; odd reads reverse-complemented."""
    rng = np.random.default_rng(seed)
    G = 25000
    codes = rng.integers(0, 4, G).astype(np.uint8)
    recs = [("c1", codes_to_string(codes))]
    reads = []
    for i in range(n_reads):
        p = int(rng.integers(0, G - SE_L - 10))
        r = list(codes[p:p + SE_L + 5])
        kind = i % 5
        if kind == 1:
            for m in rng.integers(0, SE_L, 3):
                r[m] = (r[m] + 1) % 4
        elif kind == 2:
            del r[30:30 + 1 + i % 2]
        elif kind == 3:
            r[40:40] = [2] * (1 + i % 2)
        elif kind == 4:
            r = list(rng.integers(0, 4, SE_L))
        s = codes_to_string(np.array(r[:SE_L], np.uint8))
        if i % 2:
            s = s[::-1].translate(str.maketrans("ACGTN", "TGCAN"))
        q = "".join(chr(33 + int(x)) for x in rng.integers(2, 41, SE_L))
        reads.append((f"r{i}_{p}", s, q))
    return recs, reads


def _jax_se(recs, reads, max_dist):
    jm = JReadMapper.build(JReference.from_records(recs), JMapParams(
        **SE_PARAMS, max_dist=max_dist, extension="pallas"))
    jb = j_batch(reads, SE_L, Alphabet.DNA_N)
    return [r.line() for r in jm.format_batch(jb, jm.dispatch(jb))]


@pytest.fixture(scope="module")
def se_runs():
    """The JAX kernel path at each band, traced on parallel threads."""
    recs, reads = _se_dataset()
    with kernel_path(), ThreadPoolExecutor(2) as pool:
        futures = {md: pool.submit(_jax_se, recs, reads, md)
                   for md in (1, 10)}
        return recs, reads, {md: f.result() for md, f in futures.items()}


@pytest.mark.parametrize("max_dist", [1, 10])
def test_se_mapper_at_any_band_matches_jax(se_runs, max_dist):
    """Bands 3 and 21, outside the precompiled five."""
    recs, reads, jsam = se_runs
    tp = TMapParams(**SE_PARAMS, max_dist=max_dist)
    assert tp.band not in K.SUPPORTED_BANDS
    tm = TReadMapper.build(TReference.from_records(recs), tp, device="cpu")
    tb = t_batch(reads, SE_L, Alphabet.DNA_N)
    tsam = [r.line() for r in tm.format_batch(tb, tm.dispatch(tb))]
    assert tsam == jsam[max_dist]
    flags = [int(line.split("\t")[1]) for line in tsam]
    assert sum(not f & 4 for f in flags) >= 50


PE_L = 150
PE_PARAMS = dict(max_read_len=PE_L, seed_len=16, seed_stride=12,
                 hits_per_seed=4, max_dist=5, maxins=500)


def _pe_dataset(seed=23, n_pairs=40):
    """FR pairs of 150-base mates (fragments 250-450); every fourth mate 2
    has a substitution every 10 bases (no seed: only rescue places it),
    every fourth is random (unplaceable)."""
    rng = np.random.default_rng(seed)
    G = 30000
    codes = rng.integers(0, 4, G).astype(np.uint8)
    recs = [("c1", codes_to_string(codes))]
    r1, r2, _, _, _, _ = sample_pairs(codes, n_pairs, PE_L, 250, 450,
                                      seed=seed, subst_rate=0.01)
    reads1, reads2 = [], []
    for i in range(n_pairs):
        a, b = r1[i].copy(), r2[i].copy()
        if i % 4 == 1:
            b[9::10] = (b[9::10] + 1) % 4
        elif i % 4 == 3:
            b = rng.integers(0, 4, PE_L)
        q = ["".join(chr(33 + int(x)) for x in rng.integers(2, 41, PE_L))
             for _ in range(2)]
        reads1.append((f"p{i}", codes_to_string(np.asarray(a, np.uint8)),
                       q[0]))
        reads2.append((f"p{i}", codes_to_string(np.asarray(b, np.uint8)),
                       q[1]))
    return recs, reads1, reads2


def _pe_params(pkg, local):
    cls = JMapParams if pkg == "jax" else TMapParams
    kw = dict(PE_PARAMS, **({"extension": "pallas"} if pkg == "jax" else {}))
    return cls.local(**kw) if local else cls(**kw)


def _jax_pe(recs, reads1, reads2, local):
    jm = JReadMapper.build(JReference.from_records(recs),
                           _pe_params("jax", local))
    jb1, jb2 = (j_batch(r, PE_L, Alphabet.DNA_N) for r in (reads1, reads2))
    return [r.line() for r in jpaired.map_pair_batch(jm, jb1, jb2)]


@pytest.fixture(scope="module")
def pe_runs():
    data = _pe_dataset()
    with kernel_path(), ThreadPoolExecutor(2) as pool:
        futures = {lo: pool.submit(_jax_pe, *data, lo) for lo in (False,
                                                                  True)}
        return data, {lo: f.result() for lo, f in futures.items()}


@pytest.mark.parametrize("local", [False, True])
def test_pe_mapper_rescues_150_base_reads_as_jax(pe_runs, local):
    (recs, reads1, reads2), jsam = pe_runs
    tm = TReadMapper.build(TReference.from_records(recs),
                           _pe_params("torch", local), device="cpu")
    tb1, tb2 = (t_batch(r, PE_L, Alphabet.DNA_N) for r in (reads1, reads2))
    res = tpaired.dispatch_pair_batch(tm, tb1, tb2)
    tsam = [r.line() for r in tpaired.format_pair_batch(tm, tb1, tb2, res)]
    want = jsam[local]
    assert len(tsam) == len(want) == 2 * len(reads1)
    if local:   # identical but for the soft clips the port adds
        for t, j in zip(tsam, want):
            tf, jf = t.split("\t"), j.split("\t")
            assert tf[:5] + tf[6:] == jf[:5] + jf[6:]
            assert re.sub(r"^\d+S|\d+S$", "", tf[5]) == jf[5]
    else:
        assert tsam == want
    rescued = res[2]["rescued2"].numpy()
    assert rescued[1::4].mean() >= 0.8    # the seedless mates
