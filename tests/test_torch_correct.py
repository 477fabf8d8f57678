"""Port parity of ``correct`` (CPU): nvbio_tpu_torch's Bloom hashes and
filters, the three Lighter phases (``sample_kmers``, ``mark_trusted``,
``correct_reads``) and the ``correct`` command line against nvbio_tpu's,
bit for bit: hash values and filter positions on keys with the high bit
set and on the 0xFFFFFFFF sentinel, both filters' bytes after each phase,
the corrected reads, the canonical k-mer keys at k <= 16, the occurrence
id's wrap at 2^32, and the corrected FASTQ's bytes."""

import importlib
import io
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvbio_tpu.alphabet import Alphabet, codes_to_string
from nvbio_tpu_torch import bloom as tbloom
from nvbio_tpu_torch import lighter as tlighter

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

jbloom = importlib.import_module("nvbio_tpu.bloom")
jlighter = importlib.import_module("nvbio_tpu.lighter")

L = 60            # the reads' max_read_len
BITS = 1 << 13    # small filters keep the genomes, and the batches, few
BATCH = 256


def _keys():
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    keys[:4] = (0xFFFFFFFF, 0x80000000, 0, 0x7FFFFFFF)
    keys[4:2048] |= np.uint32(0x80000000)        # the high bit set
    return keys


def test_hashes_equal():
    keys = _keys()
    tk = torch.from_numpy(keys.astype(np.int64))
    for fn in ("hash1", "hash2"):
        want = np.asarray(getattr(jbloom, fn)(jnp.asarray(keys)))
        assert np.array_equal(getattr(tbloom, fn)(tk).numpy(), want), fn
        assert np.array_equal(getattr(tbloom, fn)(keys),
                              getattr(jbloom, fn)(keys)), fn


@pytest.mark.parametrize("n_bits,k", [(BITS, 3), (1000003, 4), (64, 2)])
def test_bloom_positions_equal(n_bits, k):
    keys = _keys()
    want = np.asarray(jbloom.ByteBloomFilter(None, n_bits, k)._pos(
        jnp.asarray(keys)))
    got = tbloom.bit_positions(torch.from_numpy(keys.astype(np.int64)), k,
                               n_bits)
    assert np.array_equal(got.numpy(), want)
    bf = jbloom.BloomFilter.empty(n_bits, k)
    bf.insert(keys[::2])
    tf = tbloom.BloomFilter.empty(n_bits, k)
    tf.insert(keys[::2])
    assert np.array_equal(tf.words, bf.words)
    want_in = np.asarray(bf.contains(keys))
    assert np.array_equal(tf.contains(keys), want_in)
    assert np.array_equal(
        tf.contains(torch.from_numpy(keys.astype(np.int64))).numpy(), want_in)
    jb = jbloom.ByteBloomFilter.empty(n_bits, k).insert(jnp.asarray(keys[1::3]))
    tb = tbloom.ByteBloomFilter.empty(n_bits, k, "cpu").insert(
        torch.from_numpy(keys[1::3].astype(np.int64)))
    assert np.array_equal(tb.bytes_.numpy(), np.asarray(jb.bytes_))
    assert np.array_equal(tb.pack().words, jb.pack().words)


def _reads(seed, n_genome, cov=30, ragged=True):
    """(truth, reads, lengths): reads of 40-60 bases (``ragged``; a few of
    length 0 and a few shorter than k) or of 60, from a seeded genome at
    ``cov``x, half reverse-complemented, with ~1% substitutions; int32,
    zero past each length."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n_genome).astype(np.uint8)
    n = n_genome * cov // L
    lens = np.full(n, L, np.int32)
    if ragged:
        lens = rng.integers(40, L + 1, n).astype(np.int32)
        lens[:3] = (0, 10, 16)
    truth = g[rng.integers(0, n_genome - L, n)[:, None] + np.arange(L)]
    rc = rng.random(n) < 0.5
    truth[rc] = 3 - truth[rc, ::-1]
    reads = truth.copy()
    flat = reads.reshape(-1)
    k = int(rng.binomial(flat.size, 0.01))
    idx = rng.integers(0, flat.size, k)
    flat[idx] = (flat[idx] + rng.integers(1, 4, k).astype(np.uint8)) % 4
    inside = np.arange(L)[None, :] < lens[:, None]
    return (np.where(inside, truth, 0).astype(np.int32),
            np.where(inside, reads, 0).astype(np.int32), lens)


def _params(pkg, **kw):
    cls = jlighter.LighterParams if pkg == "jax" else tlighter.LighterParams
    return cls(**{**dict(k=17, bloom_bits_a=BITS, bloom_bits_b=BITS,
                         max_read_len=L), **kw})


def _batches(reads, lens):
    """(read offset, reads, lengths) in batches of BATCH, the last padded
    with zero-length reads as ``fastq_batches`` pads it: every JAX call of
    this file (and the ``correct`` app's in ``test_correct_cli``) sees the
    same shapes, so each phase is traced once."""
    for i in range(0, len(reads), BATCH):
        r, n = reads[i:i + BATCH], lens[i:i + BATCH]
        pad = BATCH - len(r)
        yield i, np.pad(r, ((0, pad), (0, 0))), np.pad(n, (0, pad))


def _three_passes(pkg, reads, lens):
    """One package's passes over the batches, as the app runs them:
    (filter A, filter B, corrected reads, corrections a read)."""
    if pkg == "jax":
        P, lib = _params("jax"), jlighter

        def empty():
            return jbloom.ByteBloomFilter.empty(BITS, 3).bytes_

        def arr(x):
            return jnp.asarray(x)
    else:
        P, lib = _params("torch"), tlighter

        def empty():
            return torch.zeros(BITS, dtype=torch.uint8)

        def arr(x):
            return torch.from_numpy(x)

    a = empty()
    for off, r, n in _batches(reads, lens):
        a = lib.sample_kmers(a, arr(r), arr(n), off, P)
    b = empty()
    for _, r, n in _batches(reads, lens):
        b = lib.mark_trusted(a, b, arr(r), arr(n), P)
    out = [lib.correct_reads(b, arr(r), arr(n), P)
           for _, r, n in _batches(reads, lens)]
    corrected = np.concatenate([np.asarray(c) for c, _ in out])
    n_corr = np.concatenate([np.asarray(c) for _, c in out])
    return (np.array(a), np.array(b), corrected[:len(reads)],
            n_corr[:len(reads)])


@pytest.fixture(scope="module")
def phases():
    """Both packages' three passes over 440 ragged reads (2 batches)."""
    truth, reads, lens = _reads(seed=11, n_genome=1320, cov=20)
    return (_three_passes("jax", reads, lens),
            _three_passes("torch", reads, lens))


@pytest.mark.parametrize("what", ["a", "b", "corrected", "n_corr"])
def test_phases_equal(phases, what):
    i = ("a", "b", "corrected", "n_corr").index(what)
    want, got = phases[0][i], phases[1][i]
    assert np.array_equal(want, got), what
    if what in ("a", "b"):
        assert 0 < got.mean() < 0.5          # filled, not saturated
    if what == "n_corr":
        assert got.sum() > 0                 # some reads corrected


@pytest.mark.parametrize("k", [13, 16, 17])
def test_kmer_keys_equal(k):
    _, reads, lens = _reads(seed=k, n_genome=600)
    wk, wv = jlighter._kmer_keys(jnp.asarray(reads), jnp.asarray(lens), k)
    gk, gv = tlighter._kmer_keys(torch.from_numpy(reads),
                                 torch.from_numpy(lens), k)
    assert np.array_equal(gk.numpy(), np.asarray(wk))
    assert np.array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("offset", [80_000_000, 2**32 - 3])
def test_occurrence_id_wraps(offset):
    """``occ_id`` = (read + offset) * max_read_len + window wraps at 2^32
    (past ~71.6 M reads at 60 bases; at 2^32 - 3 the read index itself
    wraps): the sampled filter equals the JAX package's uint32 one."""
    _, r, n = next(_batches(*_reads(seed=5, n_genome=600)[1:]))
    want = jlighter.sample_kmers(
        jbloom.ByteBloomFilter.empty(BITS, 3).bytes_, jnp.asarray(r),
        jnp.asarray(n), np.uint32(offset), _params("jax"))
    tp = _params("torch")
    got = tlighter.sample_kmers(torch.zeros(BITS, dtype=torch.uint8),
                                torch.from_numpy(r), torch.from_numpy(n),
                                offset, tp)
    assert np.array_equal(got.numpy(), np.asarray(want))
    plain = tlighter.sample_kmers(torch.zeros(BITS, dtype=torch.uint8),
                                  torch.from_numpy(r), torch.from_numpy(n),
                                  0, tp)
    assert not torch.equal(got, plain)


def test_correct_cli(tmp_path, monkeypatch):
    """Both command lines on the same FASTQ (batches of 256, the last one
    padded; reads of 40-60 bases): the same corrected FASTQ bytes."""
    from nvbio_tpu.__main__ import main as jmain
    from nvbio_tpu_torch.__main__ import main as tmain

    _, reads, lens = _reads(seed=2, n_genome=1320, cov=20)
    rng = np.random.default_rng(2)
    fq = "".join(
        f"@r{i} extra\n{codes_to_string(reads[i, :n], Alphabet.DNA)}\n+\n"
        f"{''.join(chr(33 + int(q)) for q in rng.integers(2, 41, n))}\n"
        for i, n in enumerate(lens.tolist()))
    (tmp_path / "reads.fq").write_text(fq)
    common = ["-k", "17", "--bloom-bits", str(BITS), "--batch", str(BATCH),
              "--max-read-len", str(L)]
    monkeypatch.setattr(sys, "stderr", io.StringIO())
    assert jmain(["correct", str(tmp_path / "reads.fq"), "-o",
                  str(tmp_path / "jax.fq"), *common]) == 0
    assert tmain(["correct", str(tmp_path / "reads.fq"), "-o",
                  str(tmp_path / "port.fq"), *common, "--device",
                  "cpu"]) == 0
    want = (tmp_path / "jax.fq").read_bytes()
    assert (tmp_path / "port.fq").read_bytes() == want
    seqs = want.decode().splitlines()[1::4]
    assert len(seqs) == int((lens > 0).sum())
    given = [codes_to_string(reads[i, :n], Alphabet.DNA)
             for i, n in enumerate(lens.tolist()) if n]
    assert seqs != given                     # some bases corrected


@pytest.mark.parametrize("n_genome,fewer", [(2200, False), (280, True)])
def test_filter_size_decides_the_outcome(n_genome, fewer):
    """Reads of 60 bases at 30x with ~1% substitutions through 2^13-bit
    filters: over a 2.2 kbp genome (about the k-mers per bit of the app's
    default 2^24 bits for a 4.6 Mbp genome) both filters saturate and
    both packages leave MORE substituted bases than they were given; over
    280 bp (~30 bits a genome k-mer) fewer. The corrected reads are equal
    in both cases."""
    truth, reads, lens = _reads(seed=3, n_genome=n_genome, ragged=False)
    want = _three_passes("jax", reads, lens)
    got = _three_passes("torch", reads, lens)
    for w, g in zip(want, got):
        assert np.array_equal(w, g)
    before = int((reads != truth).sum())
    after = int((got[2] != truth).sum())
    assert (after < before) == fewer, (before, after)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_correct_needs_a_card_unless_asked():
    _, reads, lens = _reads(seed=1, n_genome=600)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlighter.correct_batch(reads, lens, _params("torch"))
