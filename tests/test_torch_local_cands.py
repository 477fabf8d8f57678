"""Local-mode candidate scoring (``kernels.banded_score_cands(...,
local=True)``) and K2-WIDE's route, on the CPU.

1. The plain LOCAL candidate scorer against the JAX package's local branch
   (nvbio_tpu/bowtie/pipeline.py:546-581) run on its own operands:
   ``extract_window_aligned`` windows, forward and reverse-complement slots
   and per-position penalties through ``banded_score_semiglobal_pallas(...,
   local=True)`` in interpret mode. Integer outputs: exactly equal.
2. The kernel's packed LOCAL loop, emulated in 16-bit arithmetic (every add
   wraps at 16 bits, as the DPX u16x2 add-max does): wherever the guard
   ``kernels.k1_packed_limit`` admits a fast candidate, it equals the int32
   plain version; where the guard refuses, it can differ.
3. Where K2-WIDE keeps its directions, at the full-matrix bands of the
   documented read lengths.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from nvbio_tpu import packed as jpacked
from nvbio_tpu.align.pallas_kernels import banded_score_semiglobal_pallas
from nvbio_tpu.align.types import GotohScoring as JScoring
from nvbio_tpu_torch.align import kernels as K
from nvbio_tpu_torch.align.types import GotohScoring
from nvbio_tpu_torch.packed import pack, words_to_tensor
from tests.test_torch_k1_packed import i8, w16

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

NEG16 = K.K1_NEG16
LOCAL = (2, -6, -8, -3, -8, -3)       # bowtie2 --local
LAZY = (2, -2, -5, -1, -2, -4)        # te < to: the lazy F
W = 11


def _t(a, dt=torch.int32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dt)


def _operands(rng, B, C, L, W, n, mm_max=6):
    """A genome, reads from it (substitutions, Ns, ragged lengths with 0
    and 1), their reverse complements and penalties reversed within the
    read, windows at the truth, near it, at random and at or past the
    genome's end."""
    genome = rng.integers(0, 4, size=n, dtype=np.uint8)
    md = (W - 1) // 2
    starts = rng.integers(md, n - 2 * L, size=B)
    reads = genome[starts[:, None] + np.arange(L)].astype(np.int64)
    reads = np.where(rng.random((B, L)) < 0.06, rng.integers(0, 5, (B, L)),
                     reads)
    lens = rng.integers(L // 2, L + 1, size=B)
    lens[:3] = [0, 1, L]
    rc = np.zeros_like(reads)
    mm = -rng.integers(1, mm_max + 1, size=(B, L))
    mm_rc = np.zeros_like(mm)
    for b in range(B):
        r = reads[b, :lens[b]][::-1]
        rc[b, :lens[b]] = np.where(r > 3, 4, 3 - r)
        mm_rc[b, :lens[b]] = mm[b, :lens[b]][::-1]
    w0 = rng.integers(0, n, size=(B, C))
    w0[:, 0] = starts - md
    w0[:, 1] = np.clip(starts - md + rng.integers(-4, 5, size=B), 0, n - 1)
    w0[-4:, -1] = n - np.array([1, 3, L, L + W - 2])
    wlens = np.minimum(n - w0, L + W - 1)
    return genome, reads, rc, lens, mm, mm_rc, w0, wlens


@pytest.mark.parametrize("nch_of", ["half", "none", "all"])
@pytest.mark.parametrize("scoring", [LOCAL, LAZY])
def test_local_cands_plain_matches_the_jax_local_branch(nch_of, scoring):
    """Slots split fwd/rc, all rc (nch 0) and all fwd (nch C); reads of
    length 0, 1 and under L; windows at the genome's end."""
    rng = np.random.default_rng(len(nch_of) - scoring[2])
    B, C, L, n = 40, 6, 30, 4000
    nch = {"half": C // 2, "none": 0, "all": C}[nch_of]
    genome, reads, rc, lens, mm, mm_rc, w0, wlens = _operands(rng, B, C, L,
                                                              W, n)
    words = jpacked.pack(genome, 2)
    TW = L + W - 1
    win = jpacked.extract_window_aligned(
        jnp.asarray(words), jnp.asarray(w0.reshape(-1).astype(np.int32)),
        TW, 2)
    flip = (np.arange(C) >= nch)[None, :, None]
    pats = np.where(flip, rc[:, None], reads[:, None]).reshape(B * C, L)
    pens = np.where(flip, mm_rc[:, None], mm[:, None]).reshape(B * C, L)
    want_s, want_k = banded_score_semiglobal_pallas(
        jnp.asarray(pats.astype(np.int32)),
        jnp.asarray(np.repeat(lens, C).astype(np.int32)), win,
        jnp.asarray(wlens.reshape(-1).astype(np.int32)), JScoring(*scoring),
        W, jnp.asarray(pens.astype(np.int32)), block=128, interpret=True,
        local=True)
    got_s, got_k = K.banded_score_cands(
        _t(reads), _t(rc), _t(lens), _t(w0, torch.int64), _t(wlens),
        words_to_tensor(pack(genome, 2), "cpu"), GotohScoring(*scoring), W,
        nch, _t(mm), _t(mm_rc), local=True)
    np.testing.assert_array_equal(got_s.numpy().reshape(-1),
                                  np.asarray(want_s))
    np.testing.assert_array_equal(got_k.numpy().reshape(-1),
                                  np.asarray(want_k))
    assert (got_s.numpy()[lens > 0] >= 0).all()
    assert (got_s.numpy()[lens > 10, 0] > 0).all()


def emulate_local_packed(pats, mms, texts, plens, scoring: GotohScoring,
                         W: int):
    """The kernel's packed LOCAL recurrence for N candidates: patterns and
    penalties (N, L), texts (N, >= L+W-1), lengths (N,) all >= 1 (a length
    over L scores L rows). F is fed the unfloored H0, H = max(H0, F, 0) and
    FIN = max(FIN, H0, F) from 0. Returns (score, kbest, admitted): the
    16-bit result and whether the guard keeps it."""
    match, po, pe, to, te = (scoring.match, scoring.pattern_gap_open,
                             scoring.pattern_gap_ext, scoring.text_gap_open,
                             scoring.text_gap_ext)
    seq_f = te >= to
    pats, mms, texts = (np.asarray(a, np.int64) for a in (pats, mms, texts))
    N, L = pats.shape
    rows = np.minimum(np.asarray(plens, np.int64), L)
    H = np.zeros((N, W), np.int64)
    E = np.full((N, W), NEG16, np.int64)
    FIN = np.zeros((N, W), np.int64)
    neg = np.full(N, NEG16, np.int64)
    live = np.arange(L)[None, :] < rows[:, None]
    gain = np.where(live, np.maximum(np.maximum(mms, match), 0), 0)
    total = gain.sum(axis=1)
    mag = np.maximum(np.abs(mms), abs(match))
    big = np.where(live, mag, 0).max(axis=1, initial=abs(match))
    for r in range(L):
        p = pats[:, r]
        on = r < rows
        for k in range(W):
            sub = i8(np.where(p == texts[:, r + k], match, mms[:, r]))
            er = (np.maximum(w16(E[:, k + 1] + pe), w16(H[:, k + 1] + po))
                  if k + 1 < W else neg)
            h0 = np.maximum(w16(H[:, k] + sub), er)
            if seq_f:
                f = neg if k == 0 else np.maximum(w16(fprev + te),
                                                  w16(hprev + to))
                fprev, hprev = f, h0
            elif k == 0:
                g = w16(h0 + to)
                f = neg
            else:
                f = w16(g + w16(te * (k - 1)))
                g = np.maximum(w16(h0 + w16(to - te * k)), g)
            FIN[:, k] = np.where(on, np.maximum(FIN[:, k],
                                                np.maximum(h0, f)),
                                 FIN[:, k])
            H[:, k] = np.where(on, np.maximum(np.maximum(h0, f), 0), H[:, k])
            E[:, k] = np.where(on, er, E[:, k])
    lim = K.k1_packed_limit(scoring, W)
    admitted = (lim >= 0) & (total <= lim) & (big <= 127) & (big <= lim)
    return FIN.max(axis=1), FIN.argmax(axis=1), admitted


def _packed_case(rng, B, C, L, W, scoring, mm_max, n=30_000):
    """The plain LOCAL outputs and the emulation's on the fast candidates
    (window spanning every scored row's band, length >= 1)."""
    genome, reads, rc, lens, mm, mm_rc, w0, wlens = _operands(
        rng, B, C, L, W, max(n, 3 * L + 100), mm_max)
    lens[0] = L
    nch = C // 2
    score, kbest = K.banded_score_cands_plain(
        _t(reads), _t(rc), _t(lens), _t(w0, torch.int64), _t(wlens),
        words_to_tensor(pack(genome, 2), "cpu"), scoring, W, nch, _t(mm),
        _t(mm_rc), local=True)
    rows = np.minimum(lens, L)
    fast = (wlens >= rows[:, None] + W - 1) & (lens[:, None] >= 1)
    bb, cc = np.nonzero(fast)
    is_rc = cc >= nch
    pats = np.where(is_rc[:, None], rc[bb], reads[bb])
    pens = np.where(is_rc[:, None], mm_rc[bb], mm[bb])
    texts = genome[np.minimum(w0[bb, cc][:, None] + np.arange(L + W - 1),
                              len(genome) - 1)]
    emu = emulate_local_packed(pats, pens, texts, lens[bb], scoring, W)
    return (score.numpy()[bb, cc], kbest.numpy()[bb, cc]), emu


@pytest.mark.parametrize("band", K.SUPPORTED_BANDS)
@pytest.mark.parametrize("scoring", [LOCAL, LAZY])
def test_local_packed_equals_int32_at_the_presets(band, scoring):
    rng = np.random.default_rng(band - scoring[2])
    (score, kbest), (es, ek, ok) = _packed_case(
        rng, 24, 6, 40, band, GotohScoring(*scoring), 6)
    assert ok.all()
    np.testing.assert_array_equal(es, score)
    np.testing.assert_array_equal(ek, kbest)


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**31 - 1),
       band=st.sampled_from(K.SUPPORTED_BANDS),
       L=st.integers(4, 72),
       match=st.integers(0, 5),
       mm_max=st.sampled_from([1, 6, 40, 127]),
       gaps=st.tuples(st.integers(-30, 0), st.integers(-12, 0),
                      st.integers(-30, 0), st.integers(-12, 0)))
def test_local_packed_equals_int32_wherever_the_guard_admits(
        seed, band, L, match, mm_max, gaps):
    po, pe, to, te = gaps
    scoring = GotohScoring(match, -max(mm_max // 2, 1), po, pe, to, te)
    rng = np.random.default_rng(seed)
    (score, kbest), (es, ek, ok) = _packed_case(rng, 6, 4, L, band, scoring,
                                                mm_max)
    # read 0 has length L and slot 0 at its truth: a fast candidate whose
    # gains sum to at most L * match and whose magnitudes are <= mm_max
    lim = K.k1_packed_limit(scoring, band)
    if L * match <= lim and max(mm_max, match) <= min(lim, 127):
        assert ok.any()
    np.testing.assert_array_equal(es[ok], score[ok])
    np.testing.assert_array_equal(ek[ok], kbest[ok])


def test_local_packed_can_differ_where_the_guard_refuses():
    """Gains past the 16-bit range (up to 600 matching rows of +100): the guard
    refuses those reads, and the 16-bit result is wrong on some of them --
    so the kernel rescores them in int32."""
    rng = np.random.default_rng(11)
    L = 600
    sc = GotohScoring(100, -6, -60, -30, -60, -30)
    (score, kbest), (es, ek, ok) = _packed_case(rng, 16, 4, L, 31, sc, 6,
                                                n=3 * L + 2000)
    no = ~ok
    assert no.sum() >= 8
    assert (es[no] != score[no]).any() or (ek[no] != kbest[no]).any()


@pytest.mark.parametrize("M,band,route", [
    (12, 38, "shared"), (100, 230, "shared"), (128, 286, "shared"),
    (512, 1054, "global"), (512, 31, "shared"), (200, 1054, "global")])
def test_wide_route_by_pattern_rows_and_band(M, band, route):
    """K2-WIDE keeps a read's direction nibbles in shared memory where its
    rows fit (M x row bytes <= WIDE_SMEM_READ_BYTES), in a global scratch
    beyond; the cells per lane are the fewest that hold the band, and a
    row holds the nibbles of the lanes that hold band cells."""
    nc = K.wide_cells(band)
    assert 32 * nc >= band
    assert all(32 * c < band for c in K.WIDE_CELLS_PER_LANE if c < nc)
    rb = K.wide_row_bytes(band)
    assert rb % 2 == 0 and band <= 2 * rb < band + 2 * nc
    assert K.wide_route(M, band) == route
    assert (M * rb <= K.WIDE_SMEM_READ_BYTES) == (route == "shared")


def test_wide_cells_refuse_what_no_instantiation_holds():
    """A band under 1 is refused; a band past the widest precompiled cells
    per lane (once refused) gets ceil(band/32) cells rounded up to whole
    half-words of nibbles, in its own library: 1224 is the full-matrix
    traceback of a 512-base read at max_dist 100."""
    with pytest.raises(ValueError):
        K.wide_cells(0)
    assert K.wide_cells(K.WIDE_MAX_BAND) == 36
    assert K.wide_cells(K.WIDE_MAX_BAND + 1) == 40
    assert K.wide_cells(1224) == 40 and K.wide_cells(2049) == 68
    assert K.wide_row_bytes(1224) == 620
    assert K.wide_route(512, 1224) == "global"
    assert K._target("banded_traceback_wide", 1224) == (
        "banded_traceback_wide_w1224",
        ("-DNVBT_EXTRA_BAND=1224", "-DNVBT_EXTRA_NC=40"))
    assert K.wide_cells(230) == 8 and K.wide_row_bytes(230) == 116
