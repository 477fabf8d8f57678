"""On a CUDA card: the port's kernels against their plain versions and the
mappers (single-end, paired-end, local, the full-matrix mate traceback,
all-mapping, FM-index seeding, randomized hit selection), the FM search,
the FM index, the blockwise BWT, the BWTE engine and the Q-Group index
built on the card against the same on cpu, and the Q-Group index built on
the card past 2^31 bases, and the dedup vote's kernel against its plain
version. Imports no
JAX, so it also runs where only torch is installed:

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest

Without a card every test skips (the kernels have no CPU mode). Bands
outside ``K.SUPPORTED_BANDS`` build their own libraries, once for the
module (``K.build(bands=EXTRA_BANDS)``, in parallel)."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from nvbio_tpu_torch.align import kernels as K
from nvbio_tpu_torch.align.types import GotohScoring
from nvbio_tpu_torch.packed import (extract_window, pack, unpack,
                                    words_to_tensor)
from nvbio_tpu_torch.tools.k5_operands import guard_operands

SW = GotohScoring(0, -6, -8, -3, -8, -3)
ED = GotohScoring(0, -1, -1, -1, -1, -1)
LAZY = GotohScoring(1, -2, -5, -1, -2, -4)   # te < to: K1's lazy-F branch
LOCAL = GotohScoring(2, -6, -8, -3, -8, -3)  # bowtie2 --local
TB_NAMES = ("score", "k_best", "ops", "n_ops", "k_final", "nm", "i_end",
            "i_start")
# bands built at first use: max_dist 1, 6, 10 and 20
EXTRA_BANDS = (3, 13, 21, 41)
BANDS = K.SUPPORTED_BANDS + EXTRA_BANDS


@pytest.fixture(scope="module", autouse=True)
def _extra_band_builds():
    """The extra bands' libraries, built together before the first test."""
    if torch.cuda.is_available():
        K.build(bands=EXTRA_BANDS)


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
@pytest.mark.parametrize("W", BANDS)
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


# K1's slot pairs: odd halves (a padded pair), an empty forward half
K1_SLOTS = [(7, 3), (5, 5), (6, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("W", K.SUPPORTED_BANDS)
@pytest.mark.parametrize("C,nch", K1_SLOTS)
def test_k1_pairs_ends_lengths_and_guard(W, C, nch):
    """K1 with odd slot halves, windows at the genome's end, plen 0, 1, L
    and over L, and penalties the packed path's guard refuses (int8
    overflow on some reads; gap scores that rule it out for all), so the
    int32 rescoring runs beside the packed path."""
    dev = _card()
    rng = np.random.default_rng(10 * W + C)
    B, L = 1001, 2 * W + 9
    d = _inputs(rng, B, C, L, W, dev)
    lens = d["lens"].clone()
    lens[3] = L + 4
    mm = d["mm"].clone()
    mm[::7] = -torch.from_numpy(rng.integers(100, 1000, size=(len(
        range(0, B, 7)), L))).to(torch.int32).to(dev)
    mm_rc = mm.flip(1).contiguous()
    assert K.k1_packed_limit(SW, W) > 0
    for sc in (SW, LAZY, GotohScoring(0, -6, -5000, -3, -5000, -3)):
        args = (d["reads"], d["rc"], lens, d["w0"], d["wlens"], d["words"],
                sc, W, nch, mm, mm_rc)
        before = K.banded_score_cands.launches
        got = K.banded_score_cands(*args)
        assert K.banded_score_cands.launches == before + 1
        for g, w in zip(got, K.banded_score_cands_plain(*args)):
            assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("W", K.SUPPORTED_BANDS)
@pytest.mark.parametrize("C,nch", K1_SLOTS)
def test_local_cands_kernel_bit_equal_to_plain(W, C, nch):
    """K1's LOCAL instantiation (the local branch's candidate scoring):
    odd slot halves, windows at the genome's end, plen 0, 1, L and over L,
    penalties past int8 on some reads and gap scores that rule the packed
    path out for all, beside the presets."""
    dev = _card()
    rng = np.random.default_rng(20 * W + C)
    B, L = 1001, 2 * W + 9
    d = _inputs(rng, B, C, L, W, dev)
    lens = d["lens"].clone()
    lens[3] = L + 4
    mm = d["mm"].clone()
    mm[::7] = -torch.from_numpy(rng.integers(100, 1000, size=(len(
        range(0, B, 7)), L))).to(torch.int32).to(dev)
    mm_rc = mm.flip(1).contiguous()
    for sc in (LOCAL, GotohScoring(2, -2, -5, -1, -2, -4),
               GotohScoring(2, -6, -5000, -3, -5000, -3)):
        args = (d["reads"], d["rc"], lens, d["w0"], d["wlens"], d["words"],
                sc, W, nch, mm, mm_rc)
        before = K.banded_score_cands.launches
        got = K.banded_score_cands(*args, local=True)
        assert K.banded_score_cands.launches == before + 1
        want = K.banded_score_cands_plain(*args, local=True)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert (got[0][lens > 0] >= 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("W", BANDS)
@pytest.mark.parametrize("group", K.K2_GROUPS)
@pytest.mark.parametrize("local", [False, True])
def test_k2_at_each_group_size(W, group, local):
    """K2 and K2-LOCAL with one and with four lanes per read, at a batch
    that is a multiple of neither the group nor the block (a band under 5
    refuses 4 lanes: a lane holds two cells)."""
    dev = _card()
    rng = np.random.default_rng(W + 1000 * group + local)
    B = 1001
    d = _inputs(rng, B, 2, 3 * W + 5, W, dev)
    L = d["reads"].shape[1]
    reads = d["reads"].clone()
    reads[::3, -8:] = torch.from_numpy(rng.integers(0, 4, size=(
        len(range(0, B, 3)), 8))).to(torch.int32).to(dev)
    w0 = d["w0"][:, 0].contiguous()
    texts = extract_window(d["words"], w0, L + W - 1)
    tl = (d["n"] - w0).clamp(max=L + W - 1).to(torch.int32)
    tl[5:9] = torch.tensor([0, 3, W, L], dtype=torch.int32, device=dev)
    sc = LOCAL if local else SW
    targs = (reads, d["lens"], texts, tl, sc, W, d["mm"])
    if group > 1 and W < K.K2_MIN_GROUP_BAND:
        with pytest.raises(ValueError):
            K.banded_traceback(*targs, local=local, group=group)
        assert K.k2_group(B, 1, W) == 1
        return
    before = K.banded_traceback.launches
    got = K.banded_traceback(*targs, local=local, group=group)
    assert K.banded_traceback.launches == before + 1
    want = K.banded_traceback_plain(*targs, local=local)
    for name, g, w in zip(TB_NAMES, got, want):
        assert torch.equal(g, w), \
            f"{name}: first differences at {(g != w).nonzero()[:4].tolist()}"


@pytest.mark.gpu
@pytest.mark.parametrize("M", [20, 40, 70, 100, 128, 150, 256, 512])
def test_myers_kernel_bit_equal_to_plain(M):
    dev = _card()
    rng = np.random.default_rng(M)
    B, T = 3000, max(300, M + 50)
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
@pytest.mark.parametrize("M,n_symbols", [(100, 5), (150, 21), (600, 4)])
def test_myers_generic_kernel_bit_equal_to_plain(M, n_symbols):
    """Alphabets other than DNA and patterns over 512 take the generic
    instantiation (its state in a global scratch)."""
    dev = _card()
    rng = np.random.default_rng(M + n_symbols)
    B, T = 700, M + 60
    assert K.myers_route(M, n_symbols) == "generic"
    pats = rng.integers(0, n_symbols + 1, size=(B, M))
    txts = rng.integers(0, n_symbols + 2, size=(B, T))
    for b in range(0, B, 2):
        s = int(rng.integers(0, T - M))
        txts[b, s:s + M] = pats[b]
    plens = rng.integers(0, M + 1, size=B)
    tlens = rng.integers(0, T + 1, size=B)
    args = (_t(pats, dev), _t(plens, dev), _t(txts, dev), _t(tlens, dev),
            n_symbols)
    for g, w in zip(K.myers_semiglobal(*args),
                    K.myers_semiglobal_plain(*args)):
        assert torch.equal(g, w)


def _window_inputs(rng, B, M, T, dev, n=300_000):
    """Rescue-shaped operands: a packed genome, mates planted in windows
    that hold them, windows that run past the genome's end."""
    genome = rng.integers(0, 4, size=n, dtype=np.uint8)
    starts = rng.integers(0, n - T, size=B)
    starts[:32] = n - rng.integers(1, T + 40, size=32)
    starts = np.clip(starts, 0, n - 1)
    pats = rng.integers(0, 4, size=(B, M))
    for b in range(32, B, 2):
        s = int(starts[b] + rng.integers(0, T - M))
        pats[b] = genome[s:s + M]
    pats = np.where(rng.random((B, M)) < 0.02, (pats + 1) % 4, pats)
    plens = rng.integers(M // 2, M + 1, size=B)
    plens[32:36] = [0, 1, M, M]
    tlens = np.minimum(n - starts, T)
    tlens[36:40] = [0, 3, T, T + 7]
    return (words_to_tensor(pack(genome, 2), dev), _t(pats, dev),
            _t(plens, dev), torch.from_numpy(starts).to(dev), _t(tlens, dev))


@pytest.mark.gpu
@pytest.mark.parametrize("M", [100, 150, 512])
def test_myers_windows_kernel_bit_equal_to_plain(M):
    dev = _card()
    rng = np.random.default_rng(M + 7)
    T = 400 + M
    words, pats, plens, starts, tlens = _window_inputs(rng, 2000, M, T, dev)
    args = (pats, plens, words, starts, tlens, T)
    before = K.myers_semiglobal_windows.launches
    got = K.myers_semiglobal_windows(*args)
    assert K.myers_semiglobal_windows.launches == before + 1
    for g, w in zip(got, K.myers_semiglobal_windows_plain(*args)):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("W", [7, 21, 31])
@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("with_mm", [False, True])
def test_banded_score_windows_kernel_bit_equal_to_plain(W, local, with_mm):
    dev = _card()
    rng = np.random.default_rng(W + 10 * local + 100 * with_mm)
    M = 100
    TW = M + W - 1
    words, pats, plens, starts, tlens = _window_inputs(rng, 2000, M, TW, dev)
    mm = _t(-rng.integers(1, 7, size=(2000, M)), dev) if with_mm else None
    args = (pats, plens, words, starts, tlens, LOCAL if local else SW, W, mm)
    before = K.banded_score_windows.launches
    got = K.banded_score_windows(*args, local=local)
    assert K.banded_score_windows.launches == before + 1
    for g, w in zip(got, K.banded_score_windows_plain(*args, local=local)):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("W", BANDS)
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
    for got, want in zip(K.banded_score_cands(*args[:7], 13, *args[8:]),
                         K.banded_score_cands_plain(*args[:7], 13,
                                                    *args[8:])):
        assert torch.equal(got, want)                  # W=13: its own build
    with pytest.raises(TypeError):
        K.banded_score_cands(d["reads"], d["rc"], d["lens"],
                             d["w0"].to(torch.int32), *args[4:])
    with pytest.raises(ValueError):
        K.banded_score_cands(d["reads"][:, ::2], *args[1:])
    z = torch.zeros((64, 130), dtype=torch.int32, device=dev)
    n = z[:, 0].contiguous()
    p40 = z[:, :40].contiguous()
    for got, want in zip(K.myers_semiglobal(z, n, z, n),   # 5 words
                         K.myers_semiglobal_plain(z, n, z, n)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError):
        K.myers_semiglobal(p40, n, z.to(torch.int64), n)
    for got, want in zip(K.banded_score(p40, n, z, n, SW, 13),
                         K.banded_score_plain(p40, n, z, n, SW, 13)):
        assert torch.equal(got, want)                  # W=13: its own build
    with pytest.raises(TypeError):
        K.banded_score(p40, n.to(torch.int64), z, n, SW, 7, local=True)
    with pytest.raises(ValueError):
        K.banded_score(z[:, :40], n, z, n, SW, 7)        # not contiguous
    with pytest.raises(ValueError):                      # no group of 3
        K.banded_traceback(p40, n, z, n, SW, 7, group=3)


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


# K2-WIDE at the bands of the full-matrix traceback: M of 12, 100, 128 and
# 512 bases (T = L + W - 1 text columns, W = T + M). 38, 230 and 286 keep
# their directions in shared memory, 1054 (276 KB a read) in the global
# scratch: kernels.wide_route
WIDE_CASES = {38: 12, 230: 100, 286: 128, 1054: 512}
WIDE_ROUTES = {38: "shared", 230: "shared", 286: "shared", 1054: "global"}


def _full_matrix_inputs(rng, B, W, M, dev):
    """batch_traceback_full's operands: patterns planted in their text
    (a 1-9 bp deletion or insertion in some, 2% substitutions), the text
    left-padded by M code-8 symbols; ragged lengths, a penalty plane."""
    T = W - M
    txt = rng.integers(0, 4, size=(B, T))
    pats = rng.integers(0, 4, size=(B, M))
    for b in range(B):
        s0 = int(rng.integers(0, max(T - M, 1)))
        seg = txt[b, s0:s0 + M + 9]
        if b % 3 == 1:
            cut = int(rng.integers(5, M - 5))
            gap = int(rng.integers(1, 10))
            seg = np.concatenate([seg[:cut], seg[cut + gap:]])
        elif b % 3 == 2:
            cut = int(rng.integers(5, M - 5))
            seg = np.concatenate([seg[:cut], rng.integers(0, 4, 4), seg[cut:]])
        n = min(M, len(seg))
        pats[b, :n] = seg[:n]
    pats = np.where(rng.random((B, M)) < 0.02, (pats + 1) % 4, pats)
    texts = np.concatenate([np.full((B, M), 8), txt], axis=1)
    plens = rng.integers(M // 2, M + 1, size=B)
    plens[:2] = [0, 1]
    tlens = M + rng.integers(T // 2, T + 1, size=B)
    mm = -rng.integers(2, 7, size=(B, M))
    return tuple(_t(x, dev) for x in (pats, plens, texts, tlens, mm))


@pytest.mark.gpu
@pytest.mark.parametrize("W", sorted(WIDE_CASES))
@pytest.mark.parametrize("local", [False, True])
def test_wide_traceback_kernel_bit_equal_to_plain(W, local):
    dev = _card()
    rng = np.random.default_rng(W + local)
    M = WIDE_CASES[W]
    assert K.wide_route(M, W) == WIDE_ROUTES[W]
    B = 256 if W > 512 else 2001
    pats, plens, texts, tlens, mm = _full_matrix_inputs(rng, B, W, M, dev)
    sc = LOCAL if local else SW
    args = (pats, plens, texts, tlens, sc, W, mm)
    before = K.banded_traceback_wide.launches
    got = K.banded_traceback_wide(*args, local=local)
    assert K.banded_traceback_wide.launches == before + 1
    want = K.banded_traceback_wide_plain(*args, local=local)
    for name, g, w in zip(TB_NAMES, got, want):
        assert torch.equal(g, w), \
            f"{name}: first differences at {(g != w).nonzero()[:4].tolist()}"
    ops = got[2]
    assert ((ops & 3) >= 2).any()                 # gaps were walked


@pytest.mark.gpu
@pytest.mark.parametrize("W,M", [(29, 12), (200, 60), (300, 100)])
def test_wide_traceback_at_bands_not_compiled_in(W, M):
    """Bands other than 230, 286 and 1054 test the band edge at run time."""
    dev = _card()
    rng = np.random.default_rng(W)
    args = (*_full_matrix_inputs(rng, 999, W, M, dev),)
    pats, plens, texts, tlens, mm = args
    for local, sc in ((False, SW), (True, LOCAL)):
        targs = (pats, plens, texts, tlens, sc, W, mm)
        for name, g, w in zip(TB_NAMES,
                              K.banded_traceback_wide(*targs, local=local),
                              K.banded_traceback_wide_plain(*targs,
                                                            local=local)):
            assert torch.equal(g, w), f"{name} local={local}"


@pytest.mark.gpu
@pytest.mark.parametrize("W", [7, 17, 31, *EXTRA_BANDS])
@pytest.mark.parametrize("flags", range(8))
def test_regtile_kernel_bit_equal_to_plain(W, flags):
    """Every flag at the compiled bands and at bands built at first use:
    bit for bit against the plain version, and the pairs the packed loop
    took (``packed_count``) are those ``k5_packed_pairs`` admits. The
    operands (``guard_operands``) mix admitted and refused halves; block
    rows 0 and 7 draw plen from [0, L + 1] and tlen from [0, TWp]."""
    dev = _card()
    rng = np.random.default_rng(100 * W + flags)
    seq_f, full_text, uniform = bool(flags & 1), bool(flags & 2), \
        bool(flags & 4)
    G, L = 4, 100
    ops = [_t(x, dev) for x in guard_operands(rng, G, L, W,
                                               uniform_plen=uniform,
                                               full_text=full_text)]
    for scoring in (SW, LAZY, ED):
        kw = dict(scoring=scoring, band=W, length=L, seq_f=seq_f,
                  full_text=full_text, uniform_plen=uniform)
        guard = dict(kw)
        del guard["seq_f"]
        admitted = int(K.k5_packed_pairs(*ops, **guard).sum())
        assert 0 < admitted < G * 512
        cnt = torch.zeros(1, dtype=torch.int32, device=dev)
        before = K.regtile_score_blocked.launches
        got = K.regtile_score_blocked(*ops, packed_count=cnt, **kw)
        assert K.regtile_score_blocked.launches == before + 1
        for g, w in zip(got, K.regtile_score_blocked_plain(*ops, **kw)):
            assert torch.equal(g, w), \
                f"first differences at {(g != w).nonzero()[:4].tolist()}"
        assert int(cnt) == admitted


@pytest.mark.gpu
@pytest.mark.parametrize("W,M", [(1153, 12), (1224, 512)])
def test_wide_traceback_past_the_compiled_cells(W, M):
    """Bands past 32 x 36 build their own cells per lane at first use:
    1224 is pe_full_traceback at M = 512 with max_dist = 100."""
    dev = _card()
    rng = np.random.default_rng(W)
    B = 128 if M > 100 else 500
    pats, plens, texts, tlens, mm = _full_matrix_inputs(rng, B, W, M, dev)
    for local, sc in ((False, SW), (True, LOCAL)):
        targs = (pats, plens, texts, tlens, sc, W, mm)
        for name, g, w in zip(TB_NAMES,
                              K.banded_traceback_wide(*targs, local=local),
                              K.banded_traceback_wide_plain(*targs,
                                                            local=local)):
            assert torch.equal(g, w), f"{name} local={local}"


@pytest.mark.gpu
def test_new_wrappers_refuse_what_the_kernels_do_not_take():
    dev = _card()
    rng = np.random.default_rng(2)
    pats, plens, texts, tlens, mm = _full_matrix_inputs(rng, 64, 230, 100,
                                                        dev)
    with pytest.raises(ValueError):                   # no band
        K.banded_traceback_wide(pats, plens, texts, tlens, SW, 0)
    with pytest.raises(TypeError):
        K.banded_traceback_wide(pats, plens.to(torch.int64), texts, tlens,
                                SW, 230)
    with pytest.raises(ValueError):                   # texts on the host
        K.banded_traceback_wide(pats, plens, texts.cpu(), tlens, SW, 230)
    with pytest.raises(ValueError):
        K.banded_traceback_wide(pats[:, ::2], plens, texts, tlens, SW, 230)
    z = torch.zeros((2, 104, 8, 128), dtype=torch.int32, device=dev)
    n = torch.zeros((2, 1, 8, 128), dtype=torch.int32, device=dev)
    t = torch.zeros((2, 104 + 31, 8, 128), dtype=torch.int32, device=dev)
    kw = dict(scoring=SW, length=100)
    for got, want in zip(                             # W=13: its own build
            K.regtile_score_blocked(z, n, t[:, :112].contiguous(), n, z,
                                    band=13, **kw),
            K.regtile_score_blocked_plain(z, n, t[:, :112], n, z, band=13,
                                          **kw)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError):                   # 3 does not divide 100
        K.regtile_score_blocked(z, n, t, n, z, band=31, unroll=3, **kw)
    with pytest.raises(TypeError):
        K.regtile_score_blocked(z, n, t, n, z.to(torch.int64), band=31, **kw)
    with pytest.raises(ValueError):                   # the mismatch plane
        K.regtile_score_blocked(z, n, t, n, z.cpu(), band=31, **kw)


@pytest.mark.gpu
def test_full_traceback_and_all_mappers_on_cuda_equal_cpu():
    _card()
    import dataclasses

    from nvbio_tpu_torch.bowtie.paired import (
        map_pair_batch,
        map_pair_batch_all,
    )
    from nvbio_tpu_torch.bowtie.params import MapParams
    from nvbio_tpu_torch.bowtie.pipeline import ReadMapper
    from nvbio_tpu_torch.io.reference import Reference

    genome, b1, b2, bl = _pe_and_local_batches()
    ref = Reference(["g"], np.array([0, len(genome)], np.int64), genome,
                    np.zeros(0, np.uint32))
    base = MapParams(max_read_len=100, hits_per_seed=6)
    for params in (dataclasses.replace(base, pe_full_traceback=True),
                   base, MapParams.local(max_read_len=100, hits_per_seed=6)):
        gpu = ReadMapper.build(ref, params, device="cuda")
        cpu = ReadMapper.build(ref, params, device="cpu",
                               index=gpu.index.to("cpu"))
        if params.pe_full_traceback:
            runs = [lambda m: map_pair_batch(m, b1, b2)]
        else:
            runs = [lambda m: m.map_batch_all(bl),
                    lambda m: map_pair_batch_all(m, b1, b2)]
        for run in runs:
            assert [r.line() for r in run(gpu)] == \
                [r.line() for r in run(cpu)]


@pytest.mark.gpu
def test_any_band_and_wide_rescue_mappers_on_cuda_equal_cpu():
    """Single-end at max_dist 10 (band 21, built at first use) and
    paired-end with rescue at 150-base reads (K4 over 5 words)."""
    _card()
    from nvbio_tpu_torch.bowtie.paired import map_pair_batch
    from nvbio_tpu_torch.bowtie.params import MapParams
    from nvbio_tpu_torch.bowtie.pipeline import ReadMapper
    from nvbio_tpu_torch.io.fastq import ReadBatch
    from nvbio_tpu_torch.io.reference import Reference
    from nvbio_tpu_torch.utils.simgenome import (
        repeat_rich_genome,
        sample_pairs,
        sample_reads,
    )

    genome = repeat_rich_genome(1_500_000, seed=3)
    ref = Reference(["g"], np.array([0, len(genome)], np.int64), genome,
                    np.zeros(0, np.uint32))
    rng = np.random.default_rng(9)

    def batch(codes, tag):
        n, L = codes.shape
        return ReadBatch([f"{tag}{i}" for i in range(n)],
                         codes.astype(np.uint8),
                         rng.integers(5, 41, size=codes.shape).astype(
                             np.uint8), np.full(n, L, np.int32))

    reads, _, _ = sample_reads(genome, 1024, 100, seed=10, subst_rate=0.03)
    se = MapParams(max_read_len=100, hits_per_seed=6, max_dist=10)
    gpu = ReadMapper.build(ref, se, device="cuda")
    cpu = ReadMapper.build(ref, se, device="cpu", index=gpu.index.to("cpu"))
    b = batch(reads, "s")
    assert [r.line() for r in gpu.map_batch(b)] == \
        [r.line() for r in cpu.map_batch(b)]
    r1, r2, _, _, _, _ = sample_pairs(genome, 512, 150, 250, 500, seed=11,
                                      subst_rate=0.02)
    r2[::10, 9::15] = (r2[::10, 9::15] + 1) % 4      # seedless mates
    pe = MapParams(max_read_len=150, hits_per_seed=6)
    gpu = ReadMapper.build(ref, pe, device="cuda")
    cpu = ReadMapper.build(ref, pe, device="cpu", index=gpu.index.to("cpu"))
    b1, b2 = batch(r1, "p"), batch(r2, "p")
    assert [r.line() for r in map_pair_batch(gpu, b1, b2)] == \
        [r.line() for r in map_pair_batch(cpu, b1, b2)]


def _se_files(d, n=1024):
    """A 2 Mbp genome written as g.pac/.ann/.amb and n reads of 100 bp
    (1% substitutions) as se.fq; returns the genome."""
    from nvbio_tpu_torch.io.pac import save_reference_pac
    from nvbio_tpu_torch.io.reference import Reference
    from nvbio_tpu_torch.utils.simgenome import sample_reads, write_fastq

    genome = np.random.default_rng(21).integers(0, 4, size=2_000_000,
                                                dtype=np.uint8)
    save_reference_pac(Reference(["g"], np.array([0, len(genome)], np.int64),
                                 genome), str(d / "g"))
    reads, _, _ = sample_reads(genome, n, 100, seed=22, subst_rate=0.01)
    quals = np.random.default_rng(23).integers(5, 41, size=reads.shape)
    write_fastq(str(d / "se.fq"), [f"r{i}" for i in range(n)], reads, quals)
    return genome


@pytest.mark.gpu
def test_se_cli_on_cuda_equals_cpu(tmp_path):
    """``map`` on a .pac prefix with -o x.bam, --debug-output, --report and
    --mapq-filter: identical BAM records, debug bytes and report on cuda
    and on cpu."""
    _card()
    from nvbio_tpu_torch.__main__ import main
    from nvbio_tpu_torch.io.bam import read_bam

    _se_files(tmp_path)
    out = {}
    for dev in ("cuda", "cpu"):
        t = str(tmp_path / dev)
        assert main(["map", str(tmp_path / "g"), str(tmp_path / "se.fq"),
                     "--max-read-len", "100", "--hits-per-seed", "6",
                     "--batch", "512", "--mapq-filter", "10", "-o",
                     f"{t}.bam", "--debug-output", f"{t}.dbg", "--report",
                     f"{t}.html", *(["--device", "cpu"] if dev == "cpu"
                                    else [])]) == 0
        html = (tmp_path / f"{dev}.html").read_text()
        out[dev] = (read_bam(f"{t}.bam")[1],
                    (tmp_path / f"{dev}.dbg").read_bytes(),
                    html[html.index("<h2>Mapping"):html.index("<h2>Stages")])
    assert len(out["cuda"][0]) == 1024
    assert out["cuda"] == out["cpu"]


def _mapper_and_batches(n_batches=3, n=512):
    from nvbio_tpu_torch.bowtie.params import MapParams
    from nvbio_tpu_torch.bowtie.pipeline import ReadMapper
    from nvbio_tpu_torch.io.fastq import ReadBatch
    from nvbio_tpu_torch.io.reference import Reference
    from nvbio_tpu_torch.utils.simgenome import repeat_rich_genome, \
        sample_reads

    genome = repeat_rich_genome(1_500_000, seed=4)
    ref = Reference(["g"], np.array([0, len(genome)], np.int64), genome,
                    np.zeros(0, np.uint32))
    mapper = ReadMapper.build(ref, MapParams(max_read_len=100,
                                             hits_per_seed=6), device="cuda")
    rng = np.random.default_rng(5)
    batches = []
    for i in range(n_batches):
        reads, _, _ = sample_reads(genome, n, 100, seed=30 + i,
                                   subst_rate=0.03)
        batches.append(ReadBatch(
            [f"b{i}_{j}" for j in range(n)], reads.astype(np.uint8),
            rng.integers(5, 41, size=reads.shape).astype(np.uint8),
            np.full(n, 100, np.int32)))
    return mapper, batches


@pytest.mark.gpu
def test_overlapped_loop_equals_map_batch_on_cuda():
    _card()
    from nvbio_tpu_torch.apps.map_app import map_single_end

    mapper, batches = _mapper_and_batches()
    got = []
    stages = map_single_end(mapper, batches, got.append)
    want = [r for b in batches for r in mapper.map_batch(b)]
    assert [r.line() for r in got] == [r.line() for r in want]
    assert [s.calls for s in stages] == [3, 3, 3]


@pytest.mark.gpu
def test_fetched_host_arrays_outlive_the_next_batch():
    """A batch's host arrays stay its own while the next batch is
    dispatched and fetched into fresh pinned buffers: no array of batch 1
    shares memory with batch 2's or changes, and batch 1 formats to
    map_batch's records."""
    _card()
    mapper, (b1, b2, _) = _mapper_and_batches()
    h1 = mapper.fetch(mapper.dispatch(b1)).wait()   # only the arrays kept
    snap = {k: v.copy() for k, v in h1.items()}
    fetched = mapper.fetch(mapper.dispatch(b2))
    assert all(t.is_pinned() for t in fetched.tensors.values())
    h2 = fetched.wait()
    for k in h1:
        assert not np.shares_memory(h1[k], h2[k]), k
        np.testing.assert_array_equal(h1[k], snap[k], err_msg=k)
    assert not all(np.array_equal(h1[k], h2[k]) for k in h1)
    assert [r.line() for r in mapper.format_fetched(b1, h1)] == \
        [r.line() for r in mapper.map_batch(b1)]


@pytest.mark.gpu
@pytest.mark.parametrize("n", [65536, 100003])
def test_fm_search_on_cuda_equals_cpu(n):
    """The FM index on the card (with its k = 8 table built there) against
    the same index on the CPU (no table): ranks at every position, locate
    of every row (0, ``primary``, n among them), backward search of text
    substrings (the text's ends included) and random seeds, and the
    1-mismatch top-K search. The text's end falls on a 64-symbol block at
    n = 65536."""
    dev = _card()
    R = importlib.import_module("nvbio_tpu_torch.fmi.rank")
    from nvbio_tpu_torch.fmi import search as S
    from nvbio_tpu_torch.fmi.index import attach_ftab, build_fmindex

    rng = np.random.default_rng(n)
    text = rng.integers(0, 4, size=n, dtype=np.uint8)
    cpu = build_fmindex(text)
    gpu = attach_ftab(cpu.to(dev), k=8)
    i = torch.arange(n + 1)
    for c in range(4):
        assert torch.equal(
            R.rank(gpu.rank_rows, torch.full_like(i, c).to(dev),
                   i.to(dev)).cpu(),
            R.rank(cpu.rank_rows, torch.full_like(i, c), i))
    pos, done = S.locate_core(gpu, i.to(dev))
    want, wdone = S.locate_core(cpu, i)
    assert torch.equal(pos.cpu(), want) and bool(done.all())
    assert torch.equal(done.cpu(), wdone)
    Q, Ls = 4096, 22
    qs = rng.integers(0, 4, size=(Q, Ls))
    starts = rng.integers(0, n - Ls, Q // 2)
    starts[:2] = (0, n - Ls)
    qs[: Q // 2] = text[starts[:, None] + np.arange(Ls)]
    lens = rng.integers(0, Ls + 1, Q)
    lens[: Q // 2] = Ls
    q, ql = torch.from_numpy(qs), torch.from_numpy(lens)
    lo, hi = S.backward_search_core(gpu, q.to(dev), ql.to(dev))
    wlo, whi = S.backward_search_core(cpu, q, ql)
    ne = whi > wlo
    assert torch.equal((hi > lo).cpu(), ne) and bool(ne[: Q // 2].all())
    assert torch.equal(lo.cpu()[ne], wlo[ne])
    assert torch.equal(hi.cpu()[ne], whi[ne])
    got = S.search_1mm_hybrid_topk(gpu, q.to(dev), ql.to(dev), 11, K=8)
    want = S.search_1mm_hybrid_topk(cpu, q, ql, 11, K=8)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def _fm_walk_queries(rng, text, L, k):
    """(Q, L) int32 queries, half text substrings (both text ends among
    them), half random with N and negative codes, and their int32
    lengths: 0, 1, k - 1, k, k + 1, L and L + 2 (past the row) among
    them, the rest random in [0, L]."""
    n, Q = len(text), 1024
    qs = rng.integers(0, 4, size=(Q, L)).astype(np.int32)
    starts = rng.integers(0, n - L, Q // 2)
    starts[:2] = (0, n - L)
    qs[: Q // 2] = text[starts[:, None] + np.arange(L)]
    qs[Q // 2:][rng.random((Q // 2, L)) < 0.05] = 4
    qs[Q // 2:][rng.random((Q // 2, L)) < 0.01] = -1
    lens = rng.integers(0, L + 1, Q).astype(np.int32)
    lens[: Q // 4] = L
    edge = [0, 1, max(k - 1, 0), k, k + 1, L, L + 2]
    lens[Q // 4: Q // 4 + len(edge)] = edge
    lens[Q // 2: Q // 2 + len(edge)] = edge
    return qs, lens


@pytest.mark.gpu
@pytest.mark.parametrize("sa_interval", [4, 8, 16])
@pytest.mark.parametrize("ftab_k", [0, 6])
def test_fm_walk_kernels_equal_plain(sa_interval, ftab_k):
    """The FM walks' kernels (``csrc/fm_search.cu``) against their plain
    versions on the same index on the card, bit for bit on every output:
    backward search with and without the k-symbol table (lengths 0, below
    k, k, L and past L; int32 and int64 queries and lengths), locate of
    every row (0, ``primary`` and n among them), also with the walk cut to
    half the sampling interval (unresolved rows), the 1-mismatch top-K search
    at K = 1, 8 and 33 (more than its A x 3 = 21 branches); one launch a
    call; and the steps counter held while a profiler records."""
    dev = _card()
    from torch.profiler import ProfilerActivity, profile

    from nvbio_tpu_torch.fmi import search as S
    from nvbio_tpu_torch.fmi.index import attach_ftab, build_fmindex
    from nvbio_tpu_torch.utils import timers

    n, L = 20011, 24
    rng = np.random.default_rng(100 * sa_interval + ftab_k)
    text = rng.integers(0, 4, size=n, dtype=np.uint8)
    index = build_fmindex(text, sa_interval=sa_interval).to(dev)
    if ftab_k:
        index = attach_ftab(index, k=ftab_k)
    qs, lens = _fm_walk_queries(rng, text, L, ftab_k)
    q, ql = torch.from_numpy(qs).to(dev), torch.from_numpy(lens).to(dev)

    def same(got, want):
        torch.cuda.synchronize()
        return all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(got, want))

    for qq, ll in ((q, ql), (q.long(), ql.long()), (q[:, :ftab_k], ql)):
        n0 = K.fm_backward_search.launches
        got = S.backward_search_core(index, qq, ll)
        assert K.fm_backward_search.launches == n0 + 1
        assert same(got, S.backward_search_core_plain(index, qq, ll))
    rows = torch.cat([torch.arange(n + 1), torch.tensor(
        [index.primary, -3, n + 5])]).to(dev)
    got = S.locate_core(index, rows)
    want = S.locate_core_plain(index, rows)
    assert same(got, want) and bool(want[1].all())
    cut = dataclasses.replace(index, sa_interval=sa_interval // 2)
    got = S.locate_core(cut, rows)
    want = S.locate_core_plain(cut, rows)
    assert same(got, want) and 0 < int(want[1].sum()) < rows.numel()
    for top_k, n_approx in ((1, 11), (8, 11), (33, 7)):
        got = S.search_1mm_hybrid_topk(index, q, ql, n_approx, K=top_k)
        want = S.search_1mm_hybrid_topk_plain(index, q, ql, n_approx,
                                              K=top_k)
        assert got[2].shape == (len(qs), min(top_k, 3 * min(n_approx, L)))
        assert same(got, want) and bool((want[3] > want[2]).any())
    timers.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        S.locate_core(index, rows)
    c = timers.counters()
    timers.reset_counters()
    assert c["fm_steps_fixed"] == rows.numel() * sa_interval
    assert 0 < c["fm_steps"] <= c["fm_steps_fixed"]


@pytest.mark.gpu
def test_fm_seeded_mappers_on_cuda_equal_cpu(tmp_path):
    """``map --seeding fmi`` on cuda (FM index built on the fly, its k = 11
    table on the card) and on cpu for 256 reads: identical BAM records;
    paired-end with rescue through the mappers: identical SAM records."""
    _card()
    from nvbio_tpu_torch.__main__ import main
    from nvbio_tpu_torch.bowtie.paired import map_pair_batch
    from nvbio_tpu_torch.bowtie.params import MapParams
    from nvbio_tpu_torch.bowtie.pipeline import ReadMapper
    from nvbio_tpu_torch.io.bam import read_bam
    from nvbio_tpu_torch.io.fastq import ReadBatch
    from nvbio_tpu_torch.io.reference import Reference
    from nvbio_tpu_torch.utils.simgenome import sample_pairs

    genome = _se_files(tmp_path, n=256)
    out = {}
    for dev in ("cuda", "cpu"):
        t = str(tmp_path / f"{dev}.bam")
        assert main(["map", str(tmp_path / "g"), str(tmp_path / "se.fq"),
                     "--seeding", "fmi", "--max-read-len", "100",
                     "--hits-per-seed", "6", "--batch", "256", "-o", t,
                     *(["--device", "cpu"] if dev == "cpu" else [])]) == 0
        out[dev] = read_bam(t)[1]
    assert len(out["cuda"]) == 256 and out["cuda"] == out["cpu"]

    ref = Reference(["g"], np.array([0, len(genome)], np.int64), genome,
                    np.zeros(0, np.uint32))
    pe = MapParams(max_read_len=100, hits_per_seed=6, seeding="fmi")
    gpu = ReadMapper.build(ref, pe, device="cuda")
    assert gpu.index.ftab_k == 11
    cpu = ReadMapper.build(ref, pe, device="cpu",
                           index=gpu.index.to("cpu").without_ftab())
    r1, r2, _, _, _, _ = sample_pairs(genome, 256, 100, 200, 500, seed=12,
                                      subst_rate=0.01)
    r2[::10, 9::15] = (r2[::10, 9::15] + 1) % 4      # seedless mates
    rng = np.random.default_rng(13)
    b1, b2 = (ReadBatch([f"p{i}" for i in range(256)], r.astype(np.uint8),
                        rng.integers(5, 41, size=r.shape).astype(np.uint8),
                        np.full(256, 100, np.int32)) for r in (r1, r2))
    assert [r.line() for r in map_pair_batch(gpu, b1, b2)] == \
        [r.line() for r in map_pair_batch(cpu, b1, b2)]


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 27, 65536, 300003])
def test_device_fm_build_on_cuda_equals_host(n):
    """``build_fmindex_device`` on the card against the host SA-IS build:
    every table, rank and SSA rows included, on a random text with planted
    repeats (ties past the 26-symbol bootstrap); the SA alone equals SA-IS;
    ``fmindex_from_bwt`` on the card equals the host build."""
    dev = _card()
    from nvbio_tpu_torch.fmi.index import build_fmindex, fmindex_from_bwt
    from nvbio_tpu_torch.index import device_sa as D
    from nvbio_tpu_torch.index.sa import suffix_array

    rng = np.random.default_rng(n)
    text = rng.integers(0, 4, size=n, dtype=np.uint8)
    for _ in range(min(20, n // 2000)):
        s, d = rng.integers(0, n - 1000, 2)
        text[d:d + 1000] = text[s:s + 1000]
    stats = {}
    got = D.build_fmindex_device(text, device=dev, stats=stats)
    want = build_fmindex(text)
    assert got.device.type == dev.type and got.primary == want.primary
    for f in ("bwt_words", "occ", "count", "ssa_marks", "ssa_cum",
              "ssa_vals", "rank_rows", "ssa_rows"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    np.testing.assert_array_equal(D.suffix_array_device(text, dev),
                                  suffix_array(text, method="native"))
    bwt, primary = D.bwt_device(text, dev)
    again = fmindex_from_bwt(bwt, primary, device=dev)
    assert torch.equal(again.rank_rows.cpu(), want.rank_rows)
    if n >= 65536:
        assert stats["tied_rows"] > 0


@pytest.mark.gpu
def test_randomized_selection_on_cuda_equals_cpu():
    """``select_mode="randomized"`` on cuda and on cpu (q-gram, FM,
    paired-end): the threefry draws and the SumTree CDF give the same bits
    on both devices, so the SAM records are identical."""
    dev = _card()
    from nvbio_tpu_torch import sumtree, threefry
    from nvbio_tpu_torch.bowtie.paired import map_pair_batch
    from nvbio_tpu_torch.bowtie.params import MapParams
    from nvbio_tpu_torch.bowtie.pipeline import ReadMapper
    from nvbio_tpu_torch.io.fastq import ReadBatch
    from nvbio_tpu_torch.io.reference import Reference
    from nvbio_tpu_torch.utils.simgenome import sample_pairs, sample_reads

    key = threefry.fold_in(threefry.prng_key(0x5E1EC7), 3)
    u = threefry.uniform(key, (2, 1001, 24), dev)
    assert torch.equal(u.cpu(), threefry.uniform(key, (2, 1001, 24), "cpu"))
    w = torch.rand(1001, 7) * (torch.rand(1001, 7) < 0.5)
    assert torch.equal(sumtree.sample_columns(w.to(dev), u[0]).cpu(),
                       sumtree.sample_columns(w, u[0].cpu()))

    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, size=400_000, dtype=np.uint8)
    genome[200_000:260_000] = genome[:60_000]
    ref = Reference(["g"], np.array([0, len(genome)], np.int64), genome,
                    np.zeros(0, np.uint32))
    reads, _, _ = sample_reads(genome, 512, 100, seed=6, subst_rate=0.02)
    batch = ReadBatch([f"r{i}" for i in range(512)], reads.astype(np.uint8),
                      rng.integers(5, 41, size=reads.shape).astype(np.uint8),
                      np.full(512, 100, np.int32))
    for seeding in ("qgram", "fmi"):
        prm = MapParams(max_read_len=100, hits_per_seed=6, seeding=seeding,
                        select_mode="randomized")
        gpu = ReadMapper.build(ref, prm, device=dev)
        cpu = ReadMapper.build(ref, prm, device="cpu",
                               index=gpu.index.to("cpu"))
        assert [r.line() for r in gpu.map_batch(batch)] == \
            [r.line() for r in cpu.map_batch(batch)], seeding
    r1, r2, _, _, _, _ = sample_pairs(genome, 256, 100, 200, 500, seed=8,
                                      subst_rate=0.01)
    b1, b2 = (ReadBatch([f"p{i}" for i in range(256)], r.astype(np.uint8),
                        rng.integers(5, 41, size=r.shape).astype(np.uint8),
                        np.full(256, 100, np.int32)) for r in (r1, r2))
    prm = MapParams(max_read_len=100, hits_per_seed=6,
                    select_mode="randomized")
    gpu = ReadMapper.build(ref, prm, device=dev)
    cpu = ReadMapper.build(ref, prm, device="cpu", index=gpu.index.to("cpu"))
    assert [r.line() for r in map_pair_batch(gpu, b1, b2)] == \
        [r.line() for r in map_pair_batch(cpu, b1, b2)]


@pytest.mark.gpu
@pytest.mark.parametrize("n", [17, 100003, 2_000_000])
def test_blockwise_bwt_on_cuda_equals_cpu(n):
    """``blockwise_bwt`` on the card against the same call on the CPU and
    the host SA-IS BWT, through several superblocks and blocks, on a text
    with planted repeats (deepening, then the host paths)."""
    dev = _card()
    from nvbio_tpu_torch.fmi.index import bwt_from_sa
    from nvbio_tpu_torch.index.blockwise import blockwise_bwt
    from nvbio_tpu_torch.index.sa import suffix_array

    rng = np.random.default_rng(n)
    text = rng.integers(0, 4, size=n, dtype=np.uint8)
    for _ in range(min(20, n // 2000)):
        s, d = rng.integers(0, n - 1000, 2)
        text[d:d + 1000] = text[s:s + 1000]
    knobs = dict(chunk=max(16, n // 3), sb_cap=max(64, n // 3),
                 blk=max(32, n // 16))
    want, wprim = bwt_from_sa(text, suffix_array(text))
    for kw in ({}, {"host_tie_cap": 0}, {"host_tie_cap": 0,
                                          "max_deepen": 2}):
        got, prim, st = blockwise_bwt(text, device=dev, **knobs, **kw)
        cpu, cprim, cst = blockwise_bwt(text, device="cpu", **knobs, **kw)
        assert prim == cprim == wprim
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(cpu, want)
        for k in ("superblocks", "blocks", "sb_sizes", "deepen_rounds",
                  "host_tie_small", "host_tie_fallbacks"):
            assert st[k] == cst[k], k


@pytest.mark.gpu
@pytest.mark.parametrize("block_sa", ["device", "host"])
def test_bwte_device_on_cuda_equals_cpu(block_sa):
    """``BwteDevice`` on the card against the same engine on the CPU and
    the host BCR oracle: blocks of uniform reads, some duplicated, and a
    block of identical reads."""
    dev = _card()
    from nvbio_tpu_torch.index.bwte_device import BwteDevice
    from nvbio_tpu_torch.index.setbwt import mse_bwt

    rng = np.random.default_rng(11)
    reads = rng.integers(0, 4, size=(3000, 60), dtype=np.uint8)
    reads[::50] = reads[1::50]
    reads[2000:2100] = reads[0]
    out = []
    for d in (dev, "cpu"):
        eng = BwteDevice(capacity=reads.size + len(reads), n_strings=3000,
                         device=d)
        for i in range(0, 3000, 700):
            eng.add_block(reads[i:i + 700], block_sa=block_sa)
        assert eng.M.device.type == torch.device(d).type
        out.append(eng.finalize())
    want, wtags = mse_bwt(reads)
    for bwt, tags in out:
        np.testing.assert_array_equal(bwt, want)
        np.testing.assert_array_equal(tags, wtags)


@pytest.mark.gpu
def test_setbwt_device_method_on_cuda(tmp_path):
    """``setbwt --incremental --method device`` on the card writes the
    files of the same run on the CPU."""
    _card()
    from nvbio_tpu_torch.__main__ import main

    rng = np.random.default_rng(12)
    reads = rng.integers(0, 4, size=(2000, 75))
    with open(tmp_path / "r.fq", "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{''.join('ACGT'[c] for c in r)}\n+\n"
                    f"{'I' * 75}\n")
    for name, extra in (("card", []), ("host", ["--device", "cpu"])):
        assert main(["setbwt", str(tmp_path / "r.fq"), str(tmp_path / name),
                     "--incremental", "600", "--method", "device", "--txt",
                     "--lz4", *extra]) == 0
    for ext in ("npz", "txt", "lz4"):
        assert (tmp_path / f"card.setbwt.{ext}").read_bytes() == \
            (tmp_path / f"host.setbwt.{ext}").read_bytes(), ext


@pytest.mark.gpu
def test_assembly_graph_on_cuda_equals_cpu():
    """The k-mer scan on the card: the same graph and haplotypes."""
    import dataclasses

    from nvbio_tpu_torch.assembly import (build_debruijn_graph,
                                          haplotype_support,
                                          k_best_haplotypes)

    dev = _card()
    rng = np.random.default_rng(31)
    ref = rng.integers(0, 4, 400, dtype=np.uint8)
    alt = ref.copy()
    alt[200] = (alt[200] + 1) % 4
    rows = [ref] + [(alt if i % 2 else ref)[s:s + 80]
                    for i, s in enumerate(rng.integers(100, 300, 60))]
    codes = np.full((len(rows), 400), 4, np.uint8)
    for i, r in enumerate(rows):
        codes[i, :len(r)] = r
    codes[5, 10] = 4
    lengths = np.array([len(r) for r in rows], np.int32)
    rid = np.zeros(len(rows), np.int32)
    is_ref = np.arange(len(rows)) == 0
    quals = rng.integers(20, 41, codes.shape).astype(np.uint8)
    quals[7, 30:40] = 3                    # low qualities gate a few k-mers
    g = [build_debruijn_graph(codes, lengths, rid, is_ref, quals, k=k,
                              device=d)
         for d in (dev, "cpu") for k in (15, 25)]
    for a, b in ((g[0], g[2]), (g[1], g[3])):
        for f in dataclasses.fields(a):
            np.testing.assert_array_equal(getattr(a, f.name),
                                          getattr(b, f.name))
    haps = k_best_haplotypes(g[0])
    assert len(haps[0]) >= 2
    s = haplotype_support(haps, codes, lengths, rid, is_ref)
    assert int(s[0].support.sum()) > 0


@pytest.mark.gpu
def test_fm_library_on_cuda_equals_cpu():
    """search_1mm, the hybrid and k-mismatch searches, bidirectional
    extension, the suffix trie, the q-gram set index and the protein FM
    index (n a multiple of 32) on the card against the same on cpu."""
    import dataclasses

    from nvbio_tpu_torch import qgram, trie
    from nvbio_tpu_torch.fmi import bidir, protein, search
    from nvbio_tpu_torch.fmi.index import build_fmindex

    dev = _card()
    rng = np.random.default_rng(32)
    text = rng.integers(0, 4, 20000, dtype=np.uint8)
    f_cpu, r_cpu = build_fmindex(text), build_fmindex(text[::-1].copy())
    f_gpu, r_gpu = f_cpu.to(dev), r_cpu.to(dev)
    q = np.stack([text[p:p + 16] for p in rng.integers(0, 19900, 256)])
    q[::2, 3] = (q[::2, 3] + 1) % 4
    ql = np.full(256, 16, np.int32)
    for fn in (lambda f: search.search_1mm(f, q, ql),
               lambda f: search.search_1mm_hybrid(f, q, ql, 8),
               lambda f: search.search_kmm(f, q, ql, 2, 8)):
        for a, b in zip(fn(f_gpu), fn(f_cpu)):
            np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())
    c = torch.from_numpy(rng.integers(0, 4, 256))
    ga = bidir.extend_forward(f_gpu, r_gpu, *bidir.init_interval(f_gpu,
                                                                 (256,)),
                              c.to(dev))
    ca = bidir.extend_forward(f_cpu, r_cpu, *bidir.init_interval(f_cpu,
                                                                 (256,)), c)
    for a, b in zip(ga, ca):
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())
    t = [trie.SuffixTrie.build(text[:3000], max_depth=8, device=d)
         for d in (dev, "cpu")]
    for fld in dataclasses.fields(t[0]):
        np.testing.assert_array_equal(getattr(t[0], fld.name),
                                      getattr(t[1], fld.name))
    si = qgram.build_qgram_set_index(q.astype(np.uint8), ql, 11, 2)
    keys = torch.from_numpy(np.asarray(si.qgrams)[::3].copy())
    for a, b in zip(qgram.set_index_range(si.to(dev), keys.to(dev)),
                    qgram.set_index_range(si, keys)):
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())
    prot = rng.integers(0, 24, 4096, dtype=np.uint8)
    pf = protein.build_protein_fmindex(prot)
    pq = np.stack([prot[p:p + 6] for p in rng.integers(0, 4000, 128)])
    pl = np.full(128, 6)
    got = protein.protein_count(pf.to(dev), pq, pl).cpu().numpy()
    np.testing.assert_array_equal(got, protein.protein_count(pf, pq,
                                                             pl).numpy())
    assert (got >= 1).all()


@pytest.mark.gpu
@pytest.mark.parametrize("q", [8, 12, 16])
def test_qgroup_card_build_equals_host(q):
    """The Q-Group index built on the card from the packed genome (whole,
    and in small chunks and partitions) holds the host build's tables bit
    for bit."""
    from nvbio_tpu_torch import qgram
    from nvbio_tpu_torch.utils.simgenome import repeat_rich_genome

    dev = _card()
    codes = repeat_rich_genome(1_500_003, seed=q)
    host = qgram.build_qgroup_index(codes, q)
    words = words_to_tensor(pack(codes, 2), dev)
    for kw in ({}, dict(chunk=1 << 18, rows=1 << 16)):
        card = qgram.build_qgroup_index_device(words, len(codes), q, **kw)
        for name in ("I", "S", "SS", "P"):
            assert torch.equal(getattr(card, name).cpu(), getattr(host, name))


@pytest.mark.gpu
@pytest.mark.parametrize("q", [8, 16])
def test_qgroup_card_build_n_runs_and_large_buckets(q):
    """On the card, with N runs left out (``n_mask``: at both ends, across
    a mask word, 200 kbp inside) and a poly-A run and a (CA)n tandem of
    200 kbp each, larger than a partition: the build holds the host
    build's tables, its ``n_flags`` leaving out the same q-grams."""
    from nvbio_tpu_torch import qgram
    from nvbio_tpu_torch.utils.simgenome import repeat_rich_genome

    dev = _card()
    codes = repeat_rich_genome(1_500_003, seed=q + 1)
    codes[100_000:300_000] = 0
    codes[400_000:600_000:2], codes[400_001:600_000:2] = 1, 0
    flags = np.zeros(len(codes), bool)
    for a, b in ((0, 7), (63, 65), (700_000, 900_000),
                 (len(codes) - 9, len(codes))):
        flags[a:b] = True
    codes = np.where(flags, 0, codes).astype(np.uint8)
    bits = np.zeros(-(-len(codes) // 32) * 32, bool)
    bits[:len(codes)] = flags
    mask = np.packbits(bits, bitorder="little").view(np.uint32)
    host = qgram.build_qgroup_index(codes, q, n_flags=flags)
    card = qgram.build_qgroup_index_device(
        words_to_tensor(pack(codes, 2), dev), len(codes), q,
        n_mask=words_to_tensor(mask, dev), chunk=1 << 18, rows=1 << 16)
    for name in ("I", "S", "SS", "P"):
        assert torch.equal(getattr(card, name).cpu(), getattr(host, name))


def _plant(words, p: int, kmer) -> None:
    """Write the symbols ``kmer`` at position ``p`` of packed ``words``."""
    wi = p >> 4
    have = words[wi:wi + 2].cpu().numpy().view(np.uint32)
    sym = unpack(have, 16 * len(have), 2)
    sym[p & 15:(p & 15) + len(kmer)] = kmer
    words[wi:wi + len(have)] = torch.from_numpy(
        pack(sym, 2).view(np.int32)).to(words.device)


@pytest.mark.gpu
def test_qgroup_card_build_past_2_31():
    """A genome of 2^31 + 2^24 random bases with 16-mers planted past 2^31
    (one across it): the card build peaks at most 4 GiB over its tables
    (4 bytes an entry); each planted 16-mer is located at its position;
    and the whole table is right: its rows are every position once, in
    (key, position) order, each inside its key's range."""
    from nvbio_tpu_torch import qgram

    dev = _card()
    n = 2**31 + 2**24
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    words = torch.randint(-2**31, 2**31, ((n + 15) // 16,),
                          dtype=torch.int32, device=dev, generator=gen)
    rng = np.random.default_rng(22)
    at = [2**31 - 7, 2**31 + 40, 2**31 + 2**23 + 11, n - 16]
    kmers = rng.integers(0, 4, (len(at), 16)).astype(np.uint8)
    for p, km in zip(at, kmers):
        _plant(words, p, km)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    idx = qgram.build_qgroup_index_device(words, n, 16)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    tables = 4 * sum(t.numel() for t in (idx.I, idx.S, idx.SS, idx.P))
    assert peak <= tables + 4 * 2**30, (peak, tables)
    npos = n - 15
    assert idx.P.numel() == npos and idx.P.dtype == torch.int32

    keys = torch.tensor([int(qgram.qgram_keys(km, 16)[0]) for km in kmers],
                        device=dev)
    lo, hi = qgram.qgroup_range(idx, keys)
    for i, p in enumerate(at):
        rows = torch.arange(int(lo[i]), int(hi[i]), device=dev)
        pos = qgram.qgroup_locate(idx, rows, 0)
        assert p in pos.tolist() and len(pos) < 8, (p, pos.tolist(), lo[i], hi[i])
        assert (qgram.packed_qgram_keys(words, pos, 16) == keys[i]).all()

    step = 1 << 26
    for a in range(0, npos, step):
        rows = torch.arange(max(a - 1, 0), min(a + step, npos), device=dev)
        pos = qgram.qgroup_locate(idx, rows, 0)
        k = qgram.packed_qgram_keys(words, pos, 16)
        assert ((pos >= 0) & (pos < npos)).all()
        assert ((k[1:] > k[:-1])
                | ((k[1:] == k[:-1]) & (pos[1:] > pos[:-1]))).all()
        sample = torch.randint(0, len(rows), (1 << 16,), device=dev,
                               generator=gen)
        klo, khi = qgram.qgroup_range(idx, k[sample])
        r = rows[sample]
        assert ((klo <= r) & (r < khi)).all()


# the dedup vote's card shapes: (n, n_reps) of the mapper's calls, then the
# edges (whole warps of 32, the shared-memory route past 256 columns, past
# 48 KB of it, and the largest row the kernel takes)
VOTE_PATH = [(36, 8), (54, 8), (8, 2), (36, 2), (48, 2)]
VOTE_EDGES = [(1, 1), (1, 2), (31, 8), (32, 8), (33, 8), (64, 8), (65, 8),
              (256, 8), (257, 8), (300, 8), (5000, 8)]


def _vote_equal(pv, valid, tol, n_reps):
    n0 = K.vote_reps.launches
    got = K.vote_reps(pv, valid, tol, n_reps)
    assert K.vote_reps.launches == n0 + 1
    want = K.vote_reps_plain(pv, valid, tol, n_reps)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("n,n_reps", VOTE_PATH + VOTE_EDGES)
def test_vote_kernel_equals_plain(n, n_reps):
    """``csrc/vote_reps.cu`` against ``vote_reps_plain`` on the card, bit
    for bit: the edge rows of ``tools/vote_operands.edge_rows`` (all
    invalid, neighbours tol and tol + 1 apart, a member left of sel, ties,
    fewer clusters than reps, a cluster of 40, positions past 2^31) and
    clustered rows past 2^31 (4096; 8 at 5000 columns), at tol 30 and 0;
    one launch a call; the rounds counter while a profiler records, at most
    the plain rounds."""
    dev = _card()
    from torch.profiler import ProfilerActivity, profile

    from nvbio_tpu_torch.bowtie import pipeline
    from nvbio_tpu_torch.tools.vote_operands import (TOL, edge_rows,
                                                     path_operands)
    from nvbio_tpu_torch.utils import timers

    pv, valid, _ = edge_rows(n)
    pv, valid = pv.to(dev), valid.to(dev)
    for tol in (TOL, 0):
        _vote_equal(pv, valid, tol, n_reps)
    rows = 4096 if n <= 300 else 8
    for fill in (0.1, 0.9):
        pv, valid = path_operands(rows, n, fill, n + n_reps, dev)
        reps, ok = _vote_equal(pv, valid, TOL, n_reps)
        assert bool((reps[ok] >= 2**31).any())
    timers.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        pipeline._vote_reps(pv, valid, TOL, n_reps)
    c = timers.counters()
    timers.reset_counters()
    assert c["vote_rounds_fixed"] == rows * n_reps
    assert 0 < c["vote_rounds"] <= c["vote_rounds_fixed"]


@pytest.mark.gpu
def test_vote_kernel_at_its_largest_row():
    """The largest row the kernel holds (``K.VOTE_MAX_COLS`` columns, its
    shared memory near 227 KB) equals the plain version; one more column
    is refused with the limit in the message."""
    dev = _card()
    from nvbio_tpu_torch.tools.vote_operands import TOL, path_operands

    n = K.VOTE_MAX_COLS
    pv, valid = path_operands(2, n, 0.5, 7, dev)
    _vote_equal(pv, valid, TOL, 8)
    pv, valid = path_operands(2, n + 1, 0.5, 7, dev)
    with pytest.raises(ValueError, match=str(n)):
        K.vote_reps(pv, valid, TOL, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("seeding", ["qgram", "fmi"])
def test_read_candidates_vote_kernel_equals_plain_route(seeding,
                                                        monkeypatch):
    """One reseed-pass ``read_candidates`` call on the card (its
    within-seed vote over the 1-mismatch loci, then both strands' dedup):
    two vote launches, and every output equal to the same call with the
    vote's plain version in the kernel's place."""
    dev = _card()
    from nvbio_tpu_torch.bowtie import pipeline
    from nvbio_tpu_torch.bowtie.params import MapParams
    from nvbio_tpu_torch.io.fastq import ReadBatch
    from nvbio_tpu_torch.io.reference import Reference
    from nvbio_tpu_torch.utils.simgenome import sample_reads

    rng = np.random.default_rng(23)
    genome = rng.integers(0, 4, size=400_000, dtype=np.uint8)
    genome[200_000:260_000] = genome[:60_000]
    ref = Reference(["g"], np.array([0, len(genome)], np.int64), genome,
                    np.zeros(0, np.uint32))
    prm = MapParams(max_read_len=150, hits_per_seed=4, seeding=seeding)
    mapper = pipeline.ReadMapper.build(ref, prm, device=dev)
    reads, _, _ = sample_reads(genome, 1024, 150, seed=24, subst_rate=0.03)
    batch = ReadBatch([f"r{i}" for i in range(1024)], reads.astype(np.uint8),
                      rng.integers(5, 41, size=reads.shape).astype(np.uint8),
                      np.full(1024, 150, np.int32))
    codes, lens, quals = mapper.batch_tensors(batch)

    def cands():
        return pipeline.read_candidates(
            mapper.index, mapper.genome_words, mapper.n_genome, codes, lens,
            quals, prm, seed_phase=7, approx_1mm=True)

    n0 = K.vote_reps.launches
    got = cands()
    assert K.vote_reps.launches == n0 + 2
    monkeypatch.setattr(pipeline, "vote_reps",
                        lambda pv, valid, tol, n_reps, rounds=None:
                        K.vote_reps_plain(pv, valid, tol, n_reps))
    want = cands()
    torch.cuda.synchronize()
    assert got.keys() == want.keys()
    for k in got:
        assert (got[k] is None and want[k] is None) or \
            torch.equal(got[k], want[k]), k
    assert bool(got["valid"].any())
