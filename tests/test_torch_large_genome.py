"""Large-genome (uint32) q-gram positions in the port.

The port's blocked counting-sort builder (``build_qgram_index_large``)
against the JAX package's, and a q-gram index forced to uint32 positions
through ``QGramIndex.from_arrays`` (the tables a JAX ``.qgram.npz`` holds
from 2^31 symbols) mapping exactly as the int32 index through the port's
``ReadMapper`` — with ``mid_pos`` too, its uint32 0xFFFFFFFF sentinel read
as -1 on the 1-mismatch reseed pass, which half of the reads need (a
substitution planted in every seed window). The JAX side is its numpy
builders only; no JAX mapper runs.
"""

import numpy as np
import pytest
import torch

from nvbio_tpu.qgram import build_qgram_index_large as j_large
from nvbio_tpu_torch.qgram import (
    QGramIndex,
    build_qgram_index,
    build_qgram_index_large,
)

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

L = 80


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(123)


@pytest.mark.parametrize("flags", [False, True])
def test_blocked_large_builder_matches_jax(rng, flags, monkeypatch):
    codes = rng.integers(0, 4, size=50021, dtype=np.uint8)
    n_flags = None
    if flags:
        n_flags = np.zeros(len(codes), bool)
        n_flags[1000:1030] = True
        n_flags[40000] = True
    want = j_large(codes, 8, chunk=4096, n_flags=n_flags)
    got = build_qgram_index_large(codes, 8, chunk=4096, n_flags=n_flags)
    native = build_qgram_index(codes, 8, n_flags=n_flags)

    def no_toolchain(*args, **kwargs):
        raise OSError("no g++")

    from nvbio_tpu_torch import native as native_lib

    monkeypatch.setattr(native_lib, "qgram_build", no_toolchain)
    whole = build_qgram_index(codes, 8, n_flags=n_flags)   # one block
    np.testing.assert_array_equal(got.offsets.numpy(),
                                  np.asarray(want.offsets, np.int64))
    np.testing.assert_array_equal(got.positions.numpy(),
                                  np.asarray(want.positions, np.int64))
    mid = np.asarray(want.mid_pos).astype(np.int64)
    mid[mid == np.iinfo(np.int32).max] = -1
    np.testing.assert_array_equal(got.mid_pos.numpy(), mid)
    for other in (native, whole):
        for f in ("offsets", "positions", "mid_pos"):
            assert torch.equal(getattr(other, f), getattr(got, f)), f


def _genome_and_reads(rng, seed_len, seed_stride, n=60000, n_reads=64,
                      mut=0.02):
    """(genome codes, reads): 80 bp reads, every other one with a
    substitution in each seed window of the grid (only the 1-mismatch
    reseed pass can place it), the rest with 2% substitutions; one read in
    four reverse-complemented."""
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    reads = []
    for i in range(n_reads):
        p = int(rng.integers(0, n - L))
        r = codes[p:p + L].copy()
        if i % 2 == 0:
            for j in range(seed_len // 2, L, seed_stride):
                r[j] = (r[j] + 1) % 4
        else:
            nmut = rng.binomial(L, mut)
            mp = rng.integers(0, L, nmut)
            r[mp] = (r[mp] + rng.integers(1, 4, nmut)) % 4
        if i % 4 == 1:
            r = (3 - r)[::-1]
        reads.append((f"r{i}_{p}", r))
    return codes, reads


@pytest.mark.parametrize("with_mid", [False, True])
def test_uint32_positions_map_as_int32(rng, with_mid, monkeypatch):
    from nvbio_tpu_torch.alphabet import Alphabet, codes_to_string
    from nvbio_tpu_torch.bowtie import pipeline
    from nvbio_tpu_torch.bowtie.params import MapParams
    from nvbio_tpu_torch.bowtie.pipeline import ReadMapper
    from nvbio_tpu_torch.io.fastq import batch_from_records
    from nvbio_tpu_torch.io.reference import Reference

    params = MapParams(max_read_len=L, seed_len=20, seed_stride=12,
                       hits_per_seed=4, max_dist=5, reseed_frac=1.0)
    codes, reads = _genome_and_reads(rng, params.seed_len,
                                     params.seed_stride)
    ref = Reference.from_records([("chrL", codes_to_string(codes))])
    batch = batch_from_records(
        [(name, codes_to_string(r), "I" * L) for name, r in reads], L,
        Alphabet.DNA_N)
    idx32 = build_qgram_index(codes, params.qgram_q)
    assert idx32.offsets.dtype == torch.int32
    mid_u = None
    if with_mid:
        mid_u = idx32.mid_pos.numpy().astype(np.int64)
        mid_u[mid_u < 0] = 0xFFFFFFFF
        mid_u = mid_u.astype(np.uint32)
    else:
        idx32 = QGramIndex(idx32.q, idx32.offsets, idx32.positions, idx32.n)
    idxu = QGramIndex.from_arrays(
        idx32.q, idx32.n, idx32.offsets.numpy().astype(np.uint32),
        idx32.positions.numpy().astype(np.uint32), mid_u)
    assert idxu.positions.dtype == torch.int64
    if with_mid:
        assert idxu.mid_pos.dtype == torch.int64
        assert torch.equal(idxu.mid_pos, idx32.mid_pos.to(torch.int64))
        assert int((idxu.mid_pos == -1).sum()) > 0

    seen = []
    lookup = pipeline.midpos_lookup

    def counted(index, keys):
        pos, nonempty = lookup(index, keys)
        seen.append((index.mid_pos.dtype, int(nonempty.sum()),
                     int((~nonempty).sum())))
        return pos, nonempty

    monkeypatch.setattr(pipeline, "midpos_lookup", counted)
    lines = []
    for idx in (idx32, idxu):
        mapper = ReadMapper.build(ref, params, index=idx, device="cpu")
        lines.append([r.line() for r in mapper.map_batch(batch)])
    assert len(lines[0]) == len(reads)
    assert lines[1] == lines[0]
    if with_mid:
        # both indexes took the one-gather 1-mismatch lookup, with hits and
        # empty buckets among the mutated keys
        assert {s[0] for s in seen} == {torch.int32, torch.int64}
        assert all(s[1] > 0 and s[2] > 0 for s in seen)
    else:
        assert not seen
    fields = [ln.split("\t") for ln in lines[0]]
    placed = sum(int(f[3]) - 1 == int(f[0].split("_")[1]) for f in fields)
    assert placed >= 0.9 * len(reads)
