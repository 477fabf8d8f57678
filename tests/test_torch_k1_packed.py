"""K1's packed path, argued on the CPU: two candidates scored in the 16-bit
halves of a register, NEG_INF replaced by NEG16 = -2^14, the substitution
score read from an int8 table. ``emulate_packed`` repeats that arithmetic
(every add wraps at 16 bits, as the DPX u16x2 add-max does) for one
candidate; on every fast candidate (window spanning every row's band, 1 <=
plen <= L) that the guard ``kernels.k1_packed_limit`` admits it equals the
int32 plain version, and where the guard refuses it can differ."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from nvbio_tpu_torch.align import kernels as K
from nvbio_tpu_torch.align.types import NEG_INF, GotohScoring
from nvbio_tpu_torch.packed import pack, words_to_tensor

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

NEG16 = K.K1_NEG16


def w16(x):
    return ((x + 32768) & 0xFFFF) - 32768


def i8(x):
    return ((x + 128) & 0xFF) - 128


def emulate_packed(pats, mms, texts, plens, scoring: GotohScoring, W: int):
    """K1's packed recurrence for N candidates: patterns and penalties (N,
    L), texts (N, >= L+W-1), lengths (N,) all in [1, L]. Returns (score,
    kbest, admitted): the 16-bit result and whether the guard keeps it."""
    match, po, pe, to, te = (scoring.match, scoring.pattern_gap_open,
                             scoring.pattern_gap_ext, scoring.text_gap_open,
                             scoring.text_gap_ext)
    seq_f = te >= to
    pats, mms, texts = (np.asarray(a, np.int64) for a in (pats, mms, texts))
    plens = np.asarray(plens, np.int64)
    N, L = pats.shape
    H = np.zeros((N, W), np.int64)
    E = np.full((N, W), NEG16, np.int64)
    fin = np.zeros((N, W), np.int64)
    mag = np.maximum(np.abs(mms), abs(match))
    live = np.arange(L)[None, :] < plens[:, None]
    total = np.where(live, mag, 0).sum(axis=1)
    big = np.where(live, mag, 0).max(axis=1, initial=abs(match))
    for r in range(L):
        p = pats[:, r]
        # the row's byte table, as int8: match where t is the pattern symbol
        for k in range(W):
            sub = i8(np.where(p == texts[:, r + k], match, mms[:, r]))
            if k + 1 < W:
                er = np.maximum(w16(E[:, k + 1] + pe), w16(H[:, k + 1] + po))
            else:
                er = np.full(N, NEG16, np.int64)
            h0 = np.maximum(w16(H[:, k] + sub), er)
            if seq_f:
                f = (np.full(N, NEG16, np.int64) if k == 0 else
                     np.maximum(w16(fprev + te), w16(hprev + to)))
                fprev, hprev = f, h0
            elif k == 0:
                g = w16(h0 + to)
                f = np.full(N, NEG16, np.int64)
            else:
                f = w16(g + w16(te * (k - 1)))
                g = np.maximum(w16(h0 + w16(to - te * k)), g)
            H[:, k] = np.maximum(h0, f)
            E[:, k] = er
        fin = np.where((plens == r + 1)[:, None], H, fin)
    lim = K.k1_packed_limit(scoring, W)
    admitted = (lim >= 0) & (total <= lim) & (big <= 127)
    return fin.max(axis=1), fin.argmax(axis=1), admitted


def _case(rng, B, C, L, W, scoring, mm_max, n=30_000):
    """Reads from a genome (substitutions, Ns), windows at the truth, near
    it, at random and at the genome's end; per-position penalties in
    [-mm_max, -1]. Returns the plain K1 outputs and the emulation's on the
    fast candidates."""
    genome = rng.integers(0, 4, size=n, dtype=np.uint8)
    md = (W - 1) // 2
    starts = rng.integers(md, n - 2 * L, size=B)
    reads = genome[starts[:, None] + np.arange(L)].astype(np.int64)
    reads = np.where(rng.random((B, L)) < 0.08, rng.integers(0, 5, (B, L)),
                     reads)
    lens = rng.integers(1, L + 1, size=B)
    lens[0] = L
    rc = np.zeros_like(reads)
    for b in range(B):
        r = reads[b, :lens[b]][::-1]
        rc[b, :lens[b]] = np.where(r > 3, 4, 3 - r)
    mm = -rng.integers(1, mm_max + 1, size=(B, L))
    mm_rc = np.zeros_like(mm)
    for b in range(B):
        mm_rc[b, :lens[b]] = mm[b, :lens[b]][::-1]
    w0 = rng.integers(0, n, size=(B, C))
    w0[:, 0] = starts - md
    w0[:, 1] = np.clip(starts - md + rng.integers(-4, 5, size=B), 0, n - 1)
    w0[-1, -1] = n - 3
    wlens = np.minimum(n - w0, L + W - 1)
    nch = C // 2
    t = lambda a, dt=torch.int32: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a)).to(dt)
    score, kbest = K.banded_score_cands_plain(
        t(reads), t(rc), t(lens), t(w0, torch.int64), t(wlens),
        words_to_tensor(pack(genome, 2), "cpu"), scoring, W, nch, t(mm),
        t(mm_rc))
    fast = wlens >= lens[:, None] + W - 1
    bb, cc = np.nonzero(fast)
    is_rc = cc >= nch
    pats = np.where(is_rc[:, None], rc[bb], reads[bb])
    pens = np.where(is_rc[:, None], mm_rc[bb], mm[bb])
    texts = genome[np.minimum(w0[bb, cc][:, None] + np.arange(L + W - 1),
                              n - 1)]
    emu = emulate_packed(pats, pens, texts, lens[bb], scoring, W)
    return (score.numpy()[bb, cc], kbest.numpy()[bb, cc]), emu


SCORINGS = {
    "sw": GotohScoring(0, -6, -8, -3, -8, -3),
    "ed": GotohScoring(0, -1, -1, -1, -1, -1),
    "lazy": GotohScoring(1, -2, -5, -1, -2, -4),
}


@pytest.mark.parametrize("W", K.SUPPORTED_BANDS)
@pytest.mark.parametrize("name", sorted(SCORINGS))
def test_packed_equals_int32_at_the_presets(W, name):
    rng = np.random.default_rng(W + 7 * len(name))
    (score, kbest), (es, ek, ok) = _case(rng, 24, 6, 40, W, SCORINGS[name],
                                         6)
    assert ok.all()
    np.testing.assert_array_equal(es, score)
    np.testing.assert_array_equal(ek, kbest)


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**31 - 1),
       W=st.sampled_from(K.SUPPORTED_BANDS),
       L=st.integers(4, 72),
       match=st.integers(0, 3),
       mm_max=st.sampled_from([1, 6, 40, 127]),
       gaps=st.tuples(st.integers(-30, 0), st.integers(-12, 0),
                      st.integers(-30, 0), st.integers(-12, 0)))
def test_packed_equals_int32_wherever_the_guard_admits(seed, W, L, match,
                                                       mm_max, gaps):
    po, pe, to, te = gaps
    scoring = GotohScoring(match, -max(mm_max // 2, 1), po, pe, to, te)
    rng = np.random.default_rng(seed)
    (score, kbest), (es, ek, ok) = _case(rng, 6, 4, L, W, scoring, mm_max)
    # read 0 has length L and slot 0 at its truth: a fast candidate whose
    # magnitudes sum to at most L * max(mm_max, match)
    if L * max(mm_max, match) <= K.k1_packed_limit(scoring, W):
        assert ok.any()
    np.testing.assert_array_equal(es[ok], score[ok])
    np.testing.assert_array_equal(ek[ok], kbest[ok])


@pytest.mark.parametrize("mm_max,L,gap", [(1000, 30, 3), (127, 600, 60)])
def test_packed_can_differ_where_the_guard_refuses(mm_max, L, gap):
    """Penalties past int8 (1000), or scores past NEG16 (600 rows of
    mismatches up to 127 and gap extensions of 60): the guard refuses the
    longer reads, and the 16-bit result is wrong on some of them -- so the
    kernel rescores them in int32."""
    rng = np.random.default_rng(mm_max)
    sc = GotohScoring(0, -6, -2 * gap, -gap, -2 * gap, -gap)
    (score, kbest), (es, ek, ok) = _case(rng, 16, 4, L, 31, sc, mm_max,
                                         n=3 * L + 2000)
    no = ~ok
    assert no.sum() >= 8
    assert (es[no] != score[no]).any() or (ek[no] != kbest[no]).any()


def test_packed_limit():
    assert K.k1_packed_limit(SCORINGS["sw"], 31) == \
        K.K1_PACKED_RANGE - (8 + 3 + 8 + 31 * 3)
    assert K.k1_packed_limit(GotohScoring(0, -6, -8, 3, -8, -3), 31) == -1
    assert K.k1_packed_limit(GotohScoring(128, -6, -8, -3, -8, -3), 31) == -1
    assert K.k1_packed_limit(GotohScoring(0, -6, -9000, -3, -8, -3), 31) == -1
    assert NEG16 < -K.K1_PACKED_RANGE and NEG_INF < NEG16
