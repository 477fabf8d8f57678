"""K5's packed loop, argued on the CPU: two neighbouring alignments of a
block row scored in the 16-bit halves of a register (DPX u16x2 add-max,
values biased by 2^15, NEG_INF replaced by NEG16 = -2^14), the substitution
score of both halves one PRMT over two per-row byte tables selected by the
text pair, the shorter half's FIN taken at its own row.
``emulate_pairs`` repeats that arithmetic word for word (32-bit adds carry
across the halves, DPX adds wrap at 16 bits); on every pair that the guard
``kernels.k5_packed_pairs`` admits it equals the int32 plain version
``regtile_score_blocked_plain``, and where the guard refuses (penalties past
int8 or past the limit, text codes outside [0, 4)) it can differ."""

import itertools

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from nvbio_tpu_torch.align import kernels as K
from nvbio_tpu_torch.align.types import GotohScoring
from nvbio_tpu_torch.bowtie.params import MapParams
from nvbio_tpu_torch.tools.k5_operands import L_BENCH, bench_operands

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

M16, M32 = 0xFFFF, 0xFFFFFFFF
BIAS2, NEG2 = 0x80008000, 0x40004000   # 0 and NEG16 in both biased halves

SCORINGS = {
    "end-to-end": MapParams().scoring,
    "local": MapParams.local().scoring,
    "ed": GotohScoring(0, -1, -1, -1, -1, -1),
    "lazy": GotohScoring(1, -2, -5, -1, -2, -4),     # te < to
}


def addmax16(a, b, c):
    """__viaddmax_u16x2: per 16-bit half max((a + b) mod 2^16, c)."""
    lo = np.maximum((a + b) & M16, c & M16)
    hi = np.maximum(((a >> 16) + (b >> 16)) & M16, (c >> 16) & M16)
    return lo | (hi << 16)


def prmt(a, b, sel):
    """prmt.b32 d, a, b, sel: byte i of d is byte (nibble i & 7) of {b, a},
    or its sign replicated where bit 3 of the nibble is set."""
    out = np.zeros_like(a)
    for i in range(4):
        nib = (sel >> (4 * i)) & 0xF
        sh = 8 * (nib & 3)
        byte = np.where((nib & 4) == 0, a >> sh, b >> sh) & 0xFF
        byte = np.where((nib & 8) != 0, np.where(byte & 0x80, 0xFF, 0), byte)
        out |= byte << (8 * i)
    return out


def sub_table(p, mmv, match4):
    """A half's byte table: byte c is match where c is its pattern code."""
    mm4 = (mmv & 0xFF) * 0x01010101
    put = np.where((p >= 0) & (p < 4), 0xFF << (8 * np.clip(p, 0, 3)), 0)
    return (mm4 & ~put & M32) | (match4 & put)


def reduce_half(H, sh):
    v = ((H >> sh) & M16) - 0x8000
    return v.max(axis=1), v.argmax(axis=1)


def pairs(x, rows):
    """(G, rows, 8, 128) -> (G*512, rows, 2): pair j of block g is
    alignments 2j, 2j+1."""
    G = x.shape[0]
    return x.reshape(G, rows, 512, 2).transpose(0, 2, 1, 3).reshape(
        G * 512, rows, 2).astype(np.int64)


def emulate_pairs(ops, scoring: GotohScoring, W: int, L: int, seq_f: bool,
                  uniform_plen: bool):
    """The packed loop of regtile_score_blocked.cu over every pair of the
    blocked operands, no mask (the guard asks for spanning texts). Returns
    (score, kbest) as (G, 1, 8, 128) int64; pairs with a half without a FIN
    row hold garbage (the kernel never takes them)."""
    pats, plen, txts, tlen, mm = ops
    G, Lp, TWp = pats.shape[0], pats.shape[1], txts.shape[1]
    P, MM, T = pairs(pats, Lp), pairs(mm, Lp), pairs(txts, TWp)
    N = G * 512
    match, po, pe, to, te = (scoring.match, scoring.pattern_gap_open,
                             scoring.pattern_gap_ext, scoring.text_gap_open,
                             scoring.text_gap_ext)
    seq_f = seq_f and te >= to
    pl = plen.reshape(N, 2).astype(np.int64)
    rows = (np.full((N, 2), L) if uniform_plen
            else np.where((pl >= 1) & (pl <= L), pl, 0))
    R = rows.max(axis=1)
    cap = np.where(rows[:, 0] != rows[:, 1], rows.min(axis=1), 0)
    cap_sh = np.where(rows[:, 1] < rows[:, 0], 16, 0)
    po_w, to_w = (po * 0x10001) & M32, (to * 0x10001) & M32
    pe_h, te_h = (pe & M16) * 0x10001, (te & M16) * 0x10001
    match4 = (match & 0xFF) * 0x01010101
    sel = (T[:, :, 0] * 0x11 + T[:, :, 1] * 0x1100 + 0xC480) & M32
    H = np.full((N, W), BIAS2, np.int64)
    E = np.full((N, W), NEG2, np.int64)
    cs = np.zeros(N, np.int64)
    ck = np.zeros(N, np.int64)
    for r in range(int(R.max(initial=0))):
        tlo = sub_table(P[:, r, 0], MM[:, r, 0], match4)
        thi = sub_table(P[:, r, 1], MM[:, r, 1], match4)
        Hn, En = H.copy(), E.copy()
        fprev = hprev = g = None
        for k in range(W):
            sub = prmt(tlo, thi, sel[:, r + k])
            er = (addmax16(En[:, k + 1], pe_h, (Hn[:, k + 1] + po_w) & M32)
                  if k + 1 < W else np.full(N, NEG2, np.int64))
            h0 = addmax16(Hn[:, k], sub, er)
            if seq_f:
                f = (np.full(N, NEG2, np.int64) if k == 0 else
                     addmax16(fprev, te_h, (hprev + to_w) & M32))
                fprev, hprev = f, h0
            elif k == 0:
                g = (h0 + to_w) & M32
                f = np.full(N, NEG2, np.int64)
            else:
                f = (g + ((te * (k - 1)) & M32) * 0x10001) & M32
                g = addmax16(h0, ((to - te * k) & M16) * 0x10001, g)
            Hn[:, k] = addmax16(h0, 0, f)
            En[:, k] = er
        live = (r < R)[:, None]
        H, E = np.where(live, Hn, H), np.where(live, En, E)
        at = cap == r + 1
        if at.any():
            for sh in (0, 16):
                s, kb = reduce_half(H, sh)
                pick = at & (cap_sh == sh)
                cs, ck = np.where(pick, s, cs), np.where(pick, kb, ck)
    s0, k0 = reduce_half(H, 0)
    s1, k1 = reduce_half(H, 16)
    lo_cap, hi_cap = (cap > 0) & (cap_sh == 0), (cap > 0) & (cap_sh == 16)
    score = np.stack([np.where(lo_cap, cs, s0), np.where(hi_cap, cs, s1)], 1)
    kbest = np.stack([np.where(lo_cap, ck, k0), np.where(hi_cap, ck, k1)], 1)
    return score.reshape(G, 1, 8, 128), kbest.reshape(G, 1, 8, 128)


def blocked(rng, G, L, W, *, full_text, uniform_plen, mm_max=6,
            codes=4, spanning=0.8):
    """Blocked operands: half the texts hold their pattern at an offset,
    pattern codes in [0, 5) (N), per-row penalties in [-mm_max, -1],
    ragged lengths unless a flag asserts them; most texts span their
    pattern's band so the guard has pairs to admit."""
    Lp = (L + 7) // 8 * 8
    TWp = Lp + W
    pats = rng.integers(0, 5, (G, Lp, 8, 128))
    txts = rng.integers(0, codes, (G, TWp, 8, 128))
    txts[..., ::2] = np.pad(np.minimum(pats[:, :L], 3),
                            ((0, 0), (2, TWp - L - 2), (0, 0), (0, 0)))[
        ..., ::2]
    mm = -rng.integers(1, mm_max + 1, (G, Lp, 8, 128))
    if uniform_plen:
        plen = np.full((G, 1, 8, 128), L)
    else:
        plen = rng.integers(L // 2, L + 1, (G, 1, 8, 128))
        plen[:, :, 0, :8] = [0, 1, L + 1, L + 5, 1, L, 0, 0]
    if full_text:
        tlen = np.full((G, 1, 8, 128), TWp)
    else:
        tlen = np.where(rng.random((G, 1, 8, 128)) < spanning,
                        np.full((G, 1, 8, 128), TWp),
                        rng.integers(0, TWp + 1, (G, 1, 8, 128)))
    return tuple(x.astype(np.int32) for x in (pats, plen, txts, tlen, mm))


def check(ops, scoring, W, L, seq_f, full_text, uniform_plen):
    """The emulation against the int32 plain version on every admitted
    pair; returns (admitted, emulated, plain) per alignment, flat."""
    t_ops = [torch.from_numpy(x) for x in ops]
    kw = dict(scoring=scoring, band=W, length=L, full_text=full_text,
              uniform_plen=uniform_plen)
    ok = K.k5_packed_pairs(*t_ops, **kw).numpy().reshape(-1)
    ok = np.repeat(ok, 2)
    want = K.regtile_score_blocked_plain(*t_ops, seq_f=seq_f, **kw)
    got = emulate_pairs(ops, scoring, W, L, seq_f, uniform_plen)
    got = [g.reshape(-1) for g in got]
    want = [w.numpy().reshape(-1).astype(np.int64) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[ok], w[ok])
    return ok, got, want


@pytest.mark.parametrize("W", [7, 17, 31, 41])
@pytest.mark.parametrize("seq_f,uniform_plen",
                         list(itertools.product([True, False], repeat=2)))
def test_packed_equals_int32_at_the_presets(W, seq_f, uniform_plen):
    L = 40
    for i, name in enumerate(sorted(SCORINGS)):
        full_text = bool((W + i) % 2)
        rng = np.random.default_rng(1000 * W + 10 * i + 2 * seq_f
                                    + uniform_plen)
        ops = blocked(rng, 1, L, W, full_text=full_text,
                      uniform_plen=uniform_plen)
        ok, _, _ = check(ops, SCORINGS[name], W, L, seq_f, full_text,
                         uniform_plen)
        # every pair with a FIN row on both halves and spanning texts
        assert ok.mean() > (0.9 if full_text else 0.5), name


def test_bench_operands_take_the_packed_loop_at_every_pair():
    """bench.py's GCUPS operands (``k5_operands.bench_operands``: random
    codes in [0, 4), the flat mismatch plane, every pattern L long, every
    text spanning) at W = 31 and 17, on two blocks: every pair is admitted
    under every preset."""
    for W in (31, 17):
        t_ops = bench_operands(W, "cpu", MapParams().scoring.mismatch, G=2)
        for sc in SCORINGS.values():
            ok = K.k5_packed_pairs(*t_ops, scoring=sc, band=W,
                                   length=L_BENCH, full_text=True,
                                   uniform_plen=True)
            assert bool(ok.all())


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**31 - 1),
       W=st.sampled_from([7, 17, 31, 41]),
       L=st.integers(2, 48),
       match=st.integers(0, 3),
       mm_max=st.sampled_from([1, 6, 40, 127, 200]),
       gaps=st.tuples(st.integers(-30, 0), st.integers(-12, 0),
                      st.integers(-30, 0), st.integers(-12, 0)),
       flags=st.tuples(st.booleans(), st.booleans(), st.booleans()))
def test_packed_equals_int32_wherever_the_guard_admits(seed, W, L, match,
                                                       mm_max, gaps, flags):
    po, pe, to, te = gaps
    seq_f, full_text, uniform_plen = flags
    scoring = GotohScoring(match, -max(mm_max // 2, 1), po, pe, to, te)
    rng = np.random.default_rng(seed)
    ops = blocked(rng, 1, L, W, full_text=full_text,
                  uniform_plen=uniform_plen, mm_max=mm_max)
    ok, _, _ = check(ops, scoring, W, L, seq_f, full_text, uniform_plen)
    lim = K.k1_packed_limit(scoring, W)
    if uniform_plen and full_text and L * max(mm_max, match) <= lim \
            and mm_max <= 127:
        assert ok.all()


@pytest.mark.parametrize("case", ["penalty_past_int8", "sum_past_limit",
                                  "codes_65536_apart"])
def test_packed_can_differ_where_the_guard_refuses(case):
    """Penalties past int8 (1000); 600 rows of penalties of 127, whose sum
    passes the limit, so 16-bit values wrap; text codes 65536 above the
    pattern codes they copy (equal after a cut to 16 bits, different in
    int32): the guard refuses those pairs, and the 16-bit result is wrong
    on some of them -- so the kernel rescores them in int32."""
    rng = np.random.default_rng(len(case))
    sc = MapParams().scoring
    W = 31
    L = 600 if case == "sum_past_limit" else 40
    ops = list(blocked(rng, 1, L, W, full_text=True, uniform_plen=True,
                       mm_max=127))
    if case == "penalty_past_int8":
        ops[4][:, :, :, :64] = -1000
    elif case == "sum_past_limit":
        # random texts and gaps of 60: scores fall past -2^15
        ops[2] = rng.integers(0, 4, ops[2].shape).astype(np.int32)
        ops[4][:] = -127
        sc = GotohScoring(0, -6, -120, -60, -120, -60)
    else:
        ops[2][..., ::2] += 65536
    ok, got, want = check(ops, sc, W, L, True, True, True)
    no = ~ok
    assert no.sum() >= 64
    assert any((g[no] != w[no]).any() for g, w in zip(got, want))


def _one_pair(**over):
    """Operands of one block (G = 1, L = 8, W = 7) whose pair 0 is
    admitted, with `over` replacing entries of it."""
    L, W = 8, 7
    pats = np.zeros((1, 8, 8, 128), np.int32)
    txts = np.zeros((1, 8 + W, 8, 128), np.int32)
    mm = np.full((1, 8, 8, 128), -6, np.int32)
    plen = np.full((1, 1, 8, 128), L, np.int32)
    tlen = np.full((1, 1, 8, 128), L + W - 1, np.int32)
    ops = dict(pats=pats, plen=plen, txts=txts, tlen=tlen, mm=mm)
    for key, (index, value) in over.items():
        ops[key][index] = value
    return [torch.from_numpy(ops[k]) for k in ("pats", "plen", "txts",
                                               "tlen", "mm")]


def _admits(ops, scoring=None, **kw):
    kw = dict(scoring=scoring or MapParams().scoring, band=7, length=8,
              **kw)
    return bool(K.k5_packed_pairs(*ops, **kw)[0, 0, 0, 0])


def test_k5_packed_pairs_guard():
    assert _admits(_one_pair())
    # a half without a FIN row: plen 0 or past L (uniform_plen lifts it)
    assert not _admits(_one_pair(plen=((0, 0, 0, 1), 0)))
    assert not _admits(_one_pair(plen=((0, 0, 0, 0), 9)))
    assert _admits(_one_pair(plen=((0, 0, 0, 0), 9)), uniform_plen=True)
    # halves of different lengths run together
    assert _admits(_one_pair(plen=((0, 0, 0, 1), 3)))
    # a text short of its band; full_text asserts it spans
    assert not _admits(_one_pair(tlen=((0, 0, 0, 1), 13)))
    assert _admits(_one_pair(tlen=((0, 0, 0, 1), 13)), full_text=True)
    # the shorter half needs only its own rows' span
    assert _admits(_one_pair(plen=((0, 0, 0, 1), 3), tlen=((0, 0, 0, 1), 9)))
    # penalties: int8 and the sum over the rows run
    assert _admits(_one_pair(mm=((0, 2, 0, 1), -127)))
    assert not _admits(_one_pair(mm=((0, 2, 0, 1), -128)))
    assert not _admits(_one_pair(mm=((0, 2, 0, 0), -(2**31))))
    assert _admits(_one_pair(mm=((0, 7, 0, 0), -1000),
                             plen=((0, 0, 0, slice(0, 2)), 7)))
    tight = GotohScoring(0, -1, -7683, -1, -1, -1)
    assert K.k1_packed_limit(tight, 7) == 500
    assert _admits(_one_pair(), scoring=tight)               # 8 x 6
    assert not _admits(_one_pair(mm=((0, slice(None), 0, 0), -127)),
                       scoring=tight)                        # 8 x 127
    # text codes: [0, 4) at the positions the rows read
    assert not _admits(_one_pair(txts=((0, 3, 0, 1), 4)))
    assert not _admits(_one_pair(txts=((0, 3, 0, 0), -1)))
    assert not _admits(_one_pair(txts=((0, 3, 0, 0), 65536)))
    assert _admits(_one_pair(txts=((0, 14, 0, 0), 65536)))   # past L+W-1
    assert _admits(_one_pair(txts=((0, 10, 0, 0), 9),
                             plen=((0, 0, 0, slice(0, 2)), 4)))
    # any pattern code: one outside [0, 4) matches nothing
    assert _admits(_one_pair(pats=((0, 1, 0, 0), 65536)))
    assert _admits(_one_pair(pats=((0, 1, 0, 1), -7)))
    # scorings the packed loop cannot hold
    assert not _admits(_one_pair(),
                       scoring=GotohScoring(0, -6, -8, 3, -8, -3))
    assert not _admits(_one_pair(),
                       scoring=GotohScoring(128, -6, -8, -3, -8, -3))
    # the other pairs of the block are admitted, and pairs are lanes 2j/2j+1
    ok = K.k5_packed_pairs(*_one_pair(txts=((0, 3, 0, 1), 4)),
                           scoring=MapParams().scoring, band=7, length=8)
    assert ok.shape == (1, 1, 8, 64)
    assert int(ok.sum()) == 511


def test_packed_count_on_the_cpu_adds_the_admitted_pairs():
    rng = np.random.default_rng(3)
    ops = [torch.from_numpy(x) for x in blocked(
        rng, 2, 24, 7, full_text=False, uniform_plen=False)]
    kw = dict(scoring=MapParams().scoring, band=7, length=24)
    cnt = torch.full((1,), 5, dtype=torch.int32)
    got = K.regtile_score_blocked(*ops, packed_count=cnt, **kw)
    admitted = int(K.k5_packed_pairs(*ops, **kw).sum())
    assert 0 < admitted < 1024 and int(cnt) == 5 + admitted
    for g, w in zip(got, K.regtile_score_blocked_plain(*ops, **kw)):
        assert torch.equal(g, w)
    with pytest.raises(TypeError):
        K.regtile_score_blocked(*ops, packed_count=cnt.long(), **kw)
