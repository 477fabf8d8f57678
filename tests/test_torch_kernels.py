"""Port parity of the kernels of the paired-end and local paths: the plain
torch versions of K4 (Myers mate locate), K3 (flat banded scoring,
SEMI_GLOBAL and LOCAL) and K2-LOCAL (the LOCAL traceback) against the
Pallas kernels in interpret mode on the CPU. Integer outputs: exactly
equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvbio_tpu.align import myers as jmyers
from nvbio_tpu.align.pallas_kernels import (
    banded_score_semiglobal_pallas,
    banded_traceback_semiglobal_pallas,
    myers_semiglobal_pallas,
)
from nvbio_tpu.align.types import GotohScoring as JScoring
from nvbio_tpu_torch.align import kernels as K
from nvbio_tpu_torch.align.types import NEG_INF, GotohScoring

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

SCORINGS = {
    "sw": (0, -6, -8, -3, -8, -3),      # bowtie2 end-to-end
    "local": (2, -6, -8, -3, -8, -3),   # bowtie2 --local
    "lazy": (1, -2, -5, -1, -2, -4),    # te < to
}
TB_NAMES = ("score", "k_best", "ops", "n_ops", "k_final", "nm", "i_end",
            "i_start")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.int32)


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------


def _myers_inputs(rng, B, M, T):
    """Half the texts hold the pattern with a few edits; rows with
    plen = 0 (batch padding), tlen < T, read Ns (code 4)."""
    pats = rng.integers(0, 4, size=(B, M)).astype(np.int32)
    txts = rng.integers(0, 4, size=(B, T)).astype(np.int32)
    for b in range(0, B, 2):
        s = int(rng.integers(0, T - M))
        txts[b, s:s + M] = pats[b]
        for _ in range(int(rng.integers(0, 5))):
            j = int(rng.integers(s, s + M))
            txts[b, j] = (txts[b, j] + 1) % 4
    pats[rng.random((B, M)) < 0.02] = 4
    plens = rng.integers(M // 2, M + 1, size=B).astype(np.int32)
    plens[[3, 10, 17]] = 0
    plens[[4, 11]] = [1, M]
    tlens = rng.integers(M // 2, T + 1, size=B).astype(np.int32)
    tlens[[5, 12]] = [0, T]
    return pats, plens, txts, tlens


@pytest.mark.parametrize("M", [20, 40, 70, 100])
def test_myers_plain_matches_pallas_interpret(rng, M):
    B, T = 40, 150                                  # NW = 1, 2, 3, 4
    pats, plens, txts, tlens = _myers_inputs(rng, B, M, T)
    want_d, want_e = myers_semiglobal_pallas(
        jnp.asarray(pats), jnp.asarray(plens), jnp.asarray(txts),
        jnp.asarray(tlens), interpret=True)
    got_d, got_e = K.myers_semiglobal(_t(pats), _t(plens), _t(txts),
                                      _t(tlens))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    assert (got_d.numpy()[0::2] <= 6).mean() >= 0.5  # the planted copies


def test_myers_plain_matches_scan_and_golden(rng):
    """On codes 0..3 (where the two JAX versions agree) against the scan
    version and the numpy oracle."""
    B, M, T = 24, 45, 120
    pats, plens, txts, tlens = _myers_inputs(rng, B, M, T)
    pats = np.minimum(pats, 3)
    plens = np.maximum(plens, 1)
    want = jmyers.myers_semiglobal(jnp.asarray(pats), jnp.asarray(plens),
                                   jnp.asarray(txts), jnp.asarray(tlens))
    got_d, got_e = K.myers_semiglobal_plain(_t(pats), _t(plens), _t(txts),
                                            _t(tlens))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want.distance))
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want.text_end))
    for b in range(B):
        assert int(got_d[b]) == jmyers.myers_golden(
            pats[b, :plens[b]], txts[b, :tlens[b]]), b


def test_myers_wrapper_refuses_what_the_kernel_does_not_take(rng):
    """Patterns over 128 columns and alphabets other than DNA, once
    refused, are taken and equal the Pallas kernel; a device other than
    cpu or cuda is refused."""
    for M, n_symbols in ((129, 4), (50, 5)):
        pats, plens, txts, tlens = _myers_inputs(rng, 20, M, M + 60)
        want = myers_semiglobal_pallas(
            jnp.asarray(pats), jnp.asarray(plens), jnp.asarray(txts),
            jnp.asarray(tlens), n_symbols=n_symbols, interpret=True)
        got = K.myers_semiglobal(_t(pats), _t(plens), _t(txts), _t(tlens),
                                 n_symbols=n_symbols)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    meta = torch.zeros((4, 129), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        K.myers_semiglobal(meta, meta[:, 0], meta, meta[:, 0])


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------


def _k3_inputs(rng, B, M, W):
    """Half the texts hold the pattern (a local core in some); degenerate
    windows: tlen 0, 1 and 3, plen 0 and 1, a text shorter than M+W-1."""
    TW = M + W - 1
    pats = rng.integers(0, 5, size=(B, M)).astype(np.int32)
    txts = rng.integers(0, 4, size=(B, TW)).astype(np.int32)
    for b in range(0, B, 2):
        s = int(rng.integers(0, 5))
        ln = int(rng.integers(10, M - 5))
        txts[b, 5:5 + ln] = np.minimum(pats[b, s:s + ln], 3)
    plens = rng.integers(M // 2, M + 1, size=B).astype(np.int32)
    plens[[0, 1]] = [0, 1]
    tlens = rng.integers(M // 2, TW + 1, size=B).astype(np.int32)
    tlens[[2, 3, 4, 6]] = [0, 1, 3, 2]
    mm = -rng.integers(1, 7, size=(B, M)).astype(np.int32)
    return pats, plens, txts, tlens, mm


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("scoring", sorted(SCORINGS))
@pytest.mark.parametrize("with_mm", [True, False])
def test_banded_score_plain_matches_pallas_interpret(rng, local, scoring,
                                                     with_mm):
    B, M, W = 72, 40, 11
    pats, plens, txts, tlens, mm = _k3_inputs(rng, B, M, W)
    txts = txts[:, :M + W - 4]               # the wrapper zero-pads texts
    sc = SCORINGS[scoring]
    want_s, want_k = banded_score_semiglobal_pallas(
        jnp.asarray(pats), jnp.asarray(plens), jnp.asarray(txts),
        jnp.asarray(tlens), JScoring(*sc), W,
        jnp.asarray(mm) if with_mm else None, block=128, interpret=True,
        local=local)
    got_s, got_k = K.banded_score(_t(pats), _t(plens), _t(txts), _t(tlens),
                                  GotohScoring(*sc), W,
                                  _t(mm) if with_mm else None, local=local)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    real = (plens > 0) & (tlens > 0)
    assert (got_s.numpy()[real] >= (0 if local else NEG_INF // 2)).all()


@pytest.mark.parametrize("local", [False, True])
def test_banded_score_on_windows_past_the_genome_end(local):
    """Empty and 1-symbol texts (windows at or past the genome's end):
    K3 floors its prefix max at NEG_INF where the JAX scan scorer does
    not; the plain version follows K3, and here all three agree (the band
    stays finite through its E chain, so the floor never binds)."""
    from nvbio_tpu.align.batch import batch_score_banded as j_scan
    from nvbio_tpu.align.types import LOCAL, SEMI_GLOBAL, GotohAligner

    M, W = 6, 7
    pats = np.zeros((4, M), np.int32)
    txts = np.zeros((4, M + W - 1), np.int32)
    plens = np.array([6, 3, 1, 6], np.int32)
    tlens = np.array([0, 0, 0, 1], np.int32)
    sc = SCORINGS["local" if local else "sw"]
    want_s, want_k = banded_score_semiglobal_pallas(
        jnp.asarray(pats), jnp.asarray(plens), jnp.asarray(txts),
        jnp.asarray(tlens), JScoring(*sc), W, interpret=True, local=local)
    scan = j_scan(jnp.asarray(pats), jnp.asarray(plens), jnp.asarray(txts),
                  jnp.asarray(tlens),
                  GotohAligner(LOCAL if local else SEMI_GLOBAL,
                               JScoring(*sc)), W)
    got_s, got_k = K.banded_score(_t(pats), _t(plens), _t(txts), _t(tlens),
                                  GotohScoring(*sc), W, local=local)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(scan.score))


# ---------------------------------------------------------------------------
# K2-LOCAL
# ---------------------------------------------------------------------------


def _local_tb_inputs(rng, B, M, W):
    """Reads with a local core inside the text, random tails, 1 bp indels
    in some; reads whose best is 0 (all mismatches), plen 0, short
    texts."""
    TW = M + W - 1
    pats = rng.integers(0, 4, size=(B, M)).astype(np.int32)
    txts = rng.integers(0, 4, size=(B, TW)).astype(np.int32)
    for b in range(0, B - 4):
        t = txts[b, 4:4 + M].copy()
        if b % 3 == 0:
            t = np.concatenate([t[:12], t[13:], t[-1:]])
        elif b % 3 == 1:
            t = np.concatenate([t[:20], [1], t[20:-1]])
        core = slice(int(rng.integers(0, 8)), M - int(rng.integers(0, 15)))
        pats[b, core] = t[core]
    pats[-2:] = 4                                # no match: best 0
    pats[rng.random((B, M)) < 0.01] = 4
    plens = rng.integers(M // 2, M + 1, size=B).astype(np.int32)
    plens[0] = 0
    tlens = np.full(B, TW, np.int32)
    tlens[1:4] = [M // 2, M, 3]
    mm = -rng.integers(2, 7, size=(B, M)).astype(np.int32)
    return pats, plens, txts, tlens, mm


@pytest.mark.parametrize("scoring", ["local", "lazy"])
def test_local_traceback_plain_matches_pallas_interpret(rng, scoring):
    B, M, W = 56, 40, 11
    pats, plens, txts, tlens, mm = _local_tb_inputs(rng, B, M, W)
    sc = SCORINGS[scoring]
    want = banded_traceback_semiglobal_pallas(
        jnp.asarray(pats), jnp.asarray(plens), jnp.asarray(txts),
        jnp.asarray(tlens), JScoring(*sc), W, jnp.asarray(mm),
        interpret=True, local=True)
    got = K.banded_traceback(_t(pats), _t(plens), _t(txts), _t(tlens),
                             GotohScoring(*sc), W, _t(mm), local=True)
    for name, g, w in zip(TB_NAMES, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    score, n_ops, i_start = got[0].numpy(), got[3].numpy(), got[7].numpy()
    assert (score[-2:] == 0).all() and (n_ops[-2:] == 0).all()
    assert int(n_ops[0]) == 0                       # the empty pattern
    assert (i_start[:-4] > 0).any()                 # walks that stopped
    assert ((got[2].numpy() & 3) == 3).any()        # deletions were walked
    assert ((got[2].numpy() & 3) == 2).any()        # insertions too


@pytest.mark.parametrize("B,want", [(1001, 4), (8192, 4), (32768, 1),
                                    (786432, 1)])
def test_k2_group_by_batch(B, want):
    """Four lanes per read where the batch alone leaves an H100 (132 SMs)
    under 4 warps per SM; one at the main path's B = 32768 and at the --all
    shape. Every band keeps two cells per lane at four."""
    assert K.k2_group(B, 132) == want
    assert all(-(-W // 4) >= 2 for W in K.SUPPORTED_BANDS)


@pytest.mark.parametrize("band", [3, 4, 5, 13, 21, 31, 33, 41, 101])
def test_k2_rows_groups_and_libraries_at_any_band(band):
    """Any band: bands under 5 take one lane a read (a lane of four holds
    two cells); a read's direction row is whole 16-byte vectors of each
    lane's ceil(NC/8) words; a band outside the precompiled five builds
    its own library of each banded source."""
    assert K.k2_group(1001, 132, band) == (4 if band >= 5 else 1)
    for group in K.K2_GROUPS:
        nc = -(-band // group)
        words = K.k2_row_words(band, group)
        assert words % 4 == 0 and words >= group * -(-nc // 8)
        assert words - group * -(-nc // 8) < 4
    assert K.k2_row_words(band, 1) == (4 if band <= 32 else words)
    for name in ("banded_score_cands", "banded_traceback", "banded_score",
                 "regtile_score_blocked"):
        key, flags = K._target(name, band)
        if band in K.SUPPORTED_BANDS:
            continue
        assert key == f"{name}_w{band}"
        assert flags == (f"-DNVBT_EXTRA_BAND={band}",)
    assert K._target("myers_semiglobal", None) == ("myers_semiglobal", ())
