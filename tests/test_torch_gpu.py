"""On a CUDA card: the port's kernels against their plain versions and the
mappers (single-end, paired-end, local) on cuda against the same on cpu. Imports no JAX, so it also runs
where only torch is installed:

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest

Without a card every test skips (the kernels have no CPU mode)."""

import numpy as np
import pytest
import torch

from nvbio_tpu_torch.align import kernels as K
from nvbio_tpu_torch.align.types import GotohScoring
from nvbio_tpu_torch.packed import extract_window, pack, words_to_tensor

SW = GotohScoring(0, -6, -8, -3, -8, -3)
ED = GotohScoring(0, -1, -1, -1, -1, -1)
LAZY = GotohScoring(1, -2, -5, -1, -2, -4)   # te < to: K1's lazy-F branch
LOCAL = GotohScoring(2, -6, -8, -3, -8, -3)  # bowtie2 --local


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(rng, B, C, L, W, dev, n=200_000):
    genome = rng.integers(0, 4, size=n, dtype=np.uint8)
    md = (W - 1) // 2
    starts = rng.integers(md, n - 2 * L, size=B)
    pats = genome[starts[:, None] + np.arange(L)].astype(np.int32)
    sub = rng.random((B, L)) < 0.05
    pats = np.where(sub, (pats + rng.integers(1, 4, size=(B, L))) % 4, pats)
    pats[rng.random((B, L)) < 0.01] = 4
    lens = rng.integers(L // 2, L + 1, size=B).astype(np.int32)
    lens[:3] = [0, 1, L]
    rc = np.where(pats > 3, 4, 3 - pats)[:, ::-1].copy()
    w0 = rng.integers(0, n, size=(B, C))
    w0[:, 0] = starts - md
    w0[:16, C - 1] = n - rng.integers(1, L + W + 2, size=16)
    w0 = np.clip(w0, 0, n - 1)
    wlens = np.minimum(n - w0, L + W - 1)
    mm = -rng.integers(2, 7, size=(B, L)).astype(np.int32)

    def t(a, dt=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dt).to(dev)

    return dict(reads=t(pats), rc=t(rc), lens=t(lens),
                w0=t(w0, torch.int64), wlens=t(wlens), mm=t(mm),
                mm_rc=t(mm[:, ::-1]), words=words_to_tensor(pack(genome, 2),
                                                            dev), n=n)


@pytest.mark.gpu
@pytest.mark.parametrize("W", K.SUPPORTED_BANDS)
@pytest.mark.parametrize("scoring", [SW, ED, LAZY])
def test_cuda_kernels_bit_equal_to_plain(W, scoring):
    dev = _card()
    rng = np.random.default_rng(W)
    B, C, L = 3000, 6, 3 * W + 5
    d = _inputs(rng, B, C, L, W, dev)
    args = (d["reads"], d["rc"], d["lens"], d["w0"], d["wlens"], d["words"],
            scoring, W, C // 2, d["mm"], d["mm_rc"])
    before = K.banded_score_cands.launches
    for got, want in zip(K.banded_score_cands(*args),
                         K.banded_score_cands_plain(*args)):
        assert torch.equal(got, want)
    assert K.banded_score_cands.launches == before + 1
    w0 = d["w0"][:, 0].contiguous()
    texts = extract_window(d["words"], w0, L + W - 1)
    tl = (d["n"] - w0).clamp(max=L + W - 1).to(torch.int32)
    targs = (d["reads"], d["lens"], texts, tl, scoring, W, d["mm"])
    for got, want in zip(K.banded_traceback(*targs),
                         K.banded_traceback_plain(*targs)):
        assert torch.equal(got, want)


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.int32).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [20, 40, 70, 100, 128])
def test_myers_kernel_bit_equal_to_plain(M):
    dev = _card()
    rng = np.random.default_rng(M)
    B, T = 3000, 300
    pats = rng.integers(0, 4, size=(B, M))
    txts = rng.integers(0, 4, size=(B, T))
    for b in range(0, B, 2):
        s = int(rng.integers(0, T - M))
        txts[b, s:s + M] = pats[b]
    pats[rng.random((B, M)) < 0.02] = 4
    txts[rng.random((B, T)) < 0.01] = 7        # outside 0..3: reads as 0
    plens = rng.integers(0, M + 1, size=B)
    plens[:8] = 0
    tlens = rng.integers(0, T + 1, size=B)
    args = (_t(pats, dev), _t(plens, dev), _t(txts, dev), _t(tlens, dev))
    before = K.myers_semiglobal.launches
    got = K.myers_semiglobal(*args)
    assert K.myers_semiglobal.launches == before + 1
    for g, w in zip(got, K.myers_semiglobal_plain(*args)):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("W", K.SUPPORTED_BANDS)
@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("scoring", [SW, LOCAL, LAZY])
def test_banded_score_kernel_bit_equal_to_plain(W, local, scoring):
    dev = _card()
    rng = np.random.default_rng(W + 100 * local)
    B, M = 3000, 3 * W + 5
    TW = M + W - 1
    pats = rng.integers(0, 5, size=(B, M))
    txts = rng.integers(0, 4, size=(B, TW))
    for b in range(0, B, 2):
        ln = int(rng.integers(W, M))
        txts[b, 3:3 + ln] = np.minimum(pats[b, :ln], 3)
    plens = rng.integers(0, M + 1, size=B)
    tlens = rng.integers(0, TW + 1, size=B)
    mm = -rng.integers(1, 7, size=(B, M))
    args = (_t(pats, dev), _t(plens, dev), _t(txts[:, :TW - 2], dev),
            _t(tlens, dev), scoring, W, _t(mm, dev))
    for g, w in zip(K.banded_score(*args, local=local),
                    K.banded_score_plain(*args, local=local)):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("W", K.SUPPORTED_BANDS)
@pytest.mark.parametrize("scoring", [LOCAL, LAZY])
def test_local_traceback_kernel_bit_equal_to_plain(W, scoring):
    dev = _card()
    rng = np.random.default_rng(W)
    d = _inputs(rng, 3000, 2, 3 * W + 5, W, dev)
    L = d["reads"].shape[1]
    tails = torch.from_numpy(rng.integers(0, 4, size=(3000, 8))).to(dev)
    reads = d["reads"].clone()
    reads[::3, -8:] = tails[::3].to(torch.int32)     # walks that stop early
    w0 = d["w0"][:, 0].contiguous()
    texts = extract_window(d["words"], w0, L + W - 1)
    tl = (d["n"] - w0).clamp(max=L + W - 1).to(torch.int32)
    targs = (reads, d["lens"], texts, tl, scoring, W, d["mm"])
    for got, want in zip(K.banded_traceback(*targs, local=True),
                         K.banded_traceback_plain(*targs, local=True)):
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_do_not_take():
    dev = _card()
    rng = np.random.default_rng(1)
    d = _inputs(rng, 64, 4, 20, 7, dev)
    args = [d["reads"], d["rc"], d["lens"], d["w0"], d["wlens"], d["words"],
            SW, 7, 2, d["mm"], d["mm_rc"]]
    with pytest.raises(ValueError):
        K.banded_score_cands(*args[:7], 13, *args[8:])   # no W=13 build
    with pytest.raises(TypeError):
        K.banded_score_cands(d["reads"], d["rc"], d["lens"],
                             d["w0"].to(torch.int32), *args[4:])
    with pytest.raises(ValueError):
        K.banded_score_cands(d["reads"][:, ::2], *args[1:])
    z = torch.zeros((64, 130), dtype=torch.int32, device=dev)
    n = z[:, 0].contiguous()
    p40 = z[:, :40].contiguous()
    with pytest.raises(ValueError):                     # more than 4 words
        K.myers_semiglobal(z, n, z, n)
    with pytest.raises(ValueError):
        K.myers_semiglobal(p40, n, z.to(torch.int64), n)
    with pytest.raises(ValueError):
        K.banded_score(p40, n, z, n, SW, 13)             # no W=13 build
    with pytest.raises(TypeError):
        K.banded_score(p40, n.to(torch.int64), z, n, SW, 7, local=True)
    with pytest.raises(ValueError):
        K.banded_score(z[:, :40], n, z, n, SW, 7)        # not contiguous


@pytest.mark.gpu
def test_mapper_on_cuda_equals_mapper_on_cpu():
    _card()
    from nvbio_tpu_torch.bowtie.params import MapParams
    from nvbio_tpu_torch.bowtie.pipeline import ReadMapper
    from nvbio_tpu_torch.io.fastq import ReadBatch
    from nvbio_tpu_torch.io.reference import Reference
    from nvbio_tpu_torch.utils.simgenome import repeat_rich_genome, sample_reads

    genome = repeat_rich_genome(1_500_000, seed=3)
    ref = Reference(["g"], np.array([0, len(genome)], np.int64), genome,
                    np.zeros(0, np.uint32))
    reads, _, _ = sample_reads(genome, 2048, 100, seed=4, subst_rate=0.03)
    rng = np.random.default_rng(5)
    batch = ReadBatch([f"r{i}" for i in range(2048)], reads.astype(np.uint8),
                      rng.integers(5, 41, size=reads.shape).astype(np.uint8),
                      np.full(2048, 100, np.int32))
    params = MapParams(max_read_len=100, hits_per_seed=6)
    gpu = ReadMapper.build(ref, params, device="cuda")
    cpu = ReadMapper.build(ref, params, device="cpu")
    assert [r.line() for r in gpu.map_batch(batch)] == \
        [r.line() for r in cpu.map_batch(batch)]


def _pe_and_local_batches():
    from nvbio_tpu_torch.io.fastq import ReadBatch
    from nvbio_tpu_torch.utils.simgenome import (
        repeat_rich_genome,
        sample_pairs,
        sample_reads,
    )

    genome = repeat_rich_genome(1_500_000, seed=3)
    r1, r2, _, _, _, _ = sample_pairs(genome, 1024, 100, 200, 500, seed=6,
                                      subst_rate=0.02)
    r2[::10, 9::15] = (r2[::10, 9::15] + 1) % 4      # seedless mates
    reads, _, _ = sample_reads(genome, 1024, 100, seed=7, subst_rate=0.02)
    reads[::3, -15:] = np.random.default_rng(8).integers(0, 4, (342, 15))
    rng = np.random.default_rng(5)

    def batch(codes, tag):
        n = len(codes)
        return ReadBatch([f"{tag}{i}" for i in range(n)],
                         codes.astype(np.uint8),
                         rng.integers(5, 41, size=codes.shape).astype(
                             np.uint8), np.full(n, 100, np.int32))

    return genome, batch(r1, "p"), batch(r2, "p"), batch(reads, "l")


@pytest.mark.gpu
def test_pe_and_local_mappers_on_cuda_equal_cpu():
    _card()
    from nvbio_tpu_torch.bowtie.paired import map_pair_batch
    from nvbio_tpu_torch.bowtie.params import MapParams
    from nvbio_tpu_torch.bowtie.pipeline import ReadMapper
    from nvbio_tpu_torch.io.reference import Reference

    genome, b1, b2, bl = _pe_and_local_batches()
    ref = Reference(["g"], np.array([0, len(genome)], np.int64), genome,
                    np.zeros(0, np.uint32))
    pe = MapParams(max_read_len=100, hits_per_seed=6)
    loc = MapParams.local(max_read_len=100, hits_per_seed=6)
    for params in (pe, loc):
        gpu = ReadMapper.build(ref, params, device="cuda")
        cpu = ReadMapper.build(ref, params, device="cpu", index=gpu.index.to(
            "cpu"))
        assert [r.line() for r in map_pair_batch(gpu, b1, b2)] == \
            [r.line() for r in map_pair_batch(cpu, b1, b2)]
        if params is loc:
            assert [r.line() for r in gpu.map_batch(bl)] == \
                [r.line() for r in cpu.map_batch(bl)]
