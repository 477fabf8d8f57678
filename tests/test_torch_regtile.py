"""Port parity of K5, the register-tiled scorer over pre-blocked operands:
the plain torch ``regtile_score_blocked`` against the Pallas kernel in
interpret mode for every combination of its static flags, and the flat
entry ``banded_score_semiglobal_regtile`` (relayout included) on a ragged
batch of two blocks. Integer outputs: exactly equal."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvbio_tpu.align.pallas_kernels import (
    banded_score_semiglobal_regtile as j_flat,
)
from nvbio_tpu.align.pallas_kernels import regtile_score_blocked as j_blocked
from nvbio_tpu.align.types import GotohScoring as JScoring
from nvbio_tpu_torch.align import kernels as K
from nvbio_tpu_torch.align.types import GotohScoring

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

SW = (0, -6, -8, -3, -8, -3)          # bowtie2 end-to-end
LAZY = (1, -2, -5, -1, -2, -4)        # te < to: seq_f switches itself off
FLAGS = list(itertools.product([False, True], repeat=3))


def _blocked(rng, G, L, W, full_text, uniform_plen):
    """Blocked operands (G, rows, 8, 128): half the texts hold the pattern
    at an offset; read-N codes; ragged lengths unless a flag asserts them
    (``full_text``: every text spans Lp + W; ``uniform_plen``: every
    pattern is L long)."""
    Lp = (L + 7) // 8 * 8
    TWp = Lp + W
    pats = rng.integers(0, 5, (G, Lp, 8, 128)).astype(np.int32)
    txts = rng.integers(0, 4, (G, TWp, 8, 128)).astype(np.int32)
    txts[..., ::2] = np.pad(np.minimum(pats[:, :L], 3),
                            ((0, 0), (3, TWp - L - 3), (0, 0), (0, 0)))[
        ..., ::2]
    mm = -rng.integers(1, 7, (G, Lp, 8, 128)).astype(np.int32)
    plen = (np.full((G, 1, 8, 128), L) if uniform_plen
            else rng.integers(0, L + 3, (G, 1, 8, 128))).astype(np.int32)
    tlen = (np.full((G, 1, 8, 128), TWp) if full_text
            else rng.integers(0, TWp + 1, (G, 1, 8, 128))).astype(np.int32)
    return pats, plen, txts, tlen, mm


@pytest.mark.parametrize("W", [7, 17])
@pytest.mark.parametrize("seq_f,full_text,uniform_plen", FLAGS)
def test_regtile_blocked_plain_matches_pallas_interpret(rng, W, seq_f,
                                                        full_text,
                                                        uniform_plen):
    L = 30
    ops = _blocked(rng, 1, L, W, full_text, uniform_plen)
    kw = dict(band=W, length=L, seq_f=seq_f, full_text=full_text,
              uniform_plen=uniform_plen)
    want = j_blocked(*(jnp.asarray(x) for x in ops), scoring=JScoring(*SW),
                     interpret=True, **kw)
    got = K.regtile_score_blocked(*(torch.from_numpy(x) for x in ops),
                                  scoring=GotohScoring(*SW), **kw)
    for g, w in zip(got, want):
        assert g.shape == (1, 1, 8, 128)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    score = got[0].numpy().reshape(-1)
    assert (score[::2] > -30).mean() > 0.1      # the planted copies score
    assert K.regtile_score_blocked.launches == 0


def test_regtile_seq_f_switches_off_when_te_below_to(rng):
    """te < to: the sequential F is not valid, and both packages drop it
    (the lazy F's F[0] = min(H0[0] + to, NEG_INF) decides the result)."""
    L, W = 24, 7
    ops = _blocked(rng, 1, L, W, False, False)
    kw = dict(band=W, length=L, seq_f=True)
    want = j_blocked(*(jnp.asarray(x) for x in ops), scoring=JScoring(*LAZY),
                     interpret=True, **kw)
    t_ops = [torch.from_numpy(x) for x in ops]
    got = K.regtile_score_blocked(*t_ops, scoring=GotohScoring(*LAZY), **kw)
    lazy = K.regtile_score_blocked_plain(*t_ops, scoring=GotohScoring(*LAZY),
                                         band=W, length=L, seq_f=False)
    for g, w, z in zip(got, want, lazy):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(g, z)


def test_regtile_wrapper_checks_its_schedule_arguments(rng):
    ops = [torch.from_numpy(x) for x in _blocked(rng, 1, 24, 7, False,
                                                  False)]
    sc = GotohScoring(*SW)
    base = K.regtile_score_blocked(*ops, scoring=sc, band=7, length=24)
    same = K.regtile_score_blocked(*ops, scoring=sc, band=7, length=24,
                                   unroll=4, t_regs=False)
    assert all(torch.equal(a, b) for a, b in zip(base, same))
    with pytest.raises(ValueError):                 # 5 does not divide 24
        K.regtile_score_blocked(*ops, scoring=sc, band=7, length=24,
                                unroll=5)
    with pytest.raises(ValueError):                 # text rows too few
        K.regtile_score_blocked(*ops, scoring=sc, band=9, length=24)


def test_banded_score_semiglobal_regtile_matches_jax(rng):
    """B = 1500 ragged pairs: two blocks of 1024 after the relayout (the
    second padded with empty alignments), a penalty plane, texts shorter
    than Lp + W (zero-padded) and lengths of 0 and 1."""
    B, M, W = 1500, 33, 7
    pats = rng.integers(0, 5, (B, M)).astype(np.int32)
    txts = rng.integers(0, 4, (B, M + W - 3)).astype(np.int32)
    txts[::2, 2:2 + M - 5] = np.minimum(pats[::2, :M - 5], 3)
    plens = rng.integers(M // 2, M + 1, B).astype(np.int32)
    tlens = rng.integers(0, M + W, B).astype(np.int32)
    plens[:2], tlens[2:4] = [0, 1], [0, 1]
    mm = -rng.integers(1, 7, (B, M)).astype(np.int32)
    for with_mm in (True, False):
        want = j_flat(jnp.asarray(pats), jnp.asarray(plens),
                      jnp.asarray(txts), jnp.asarray(tlens), JScoring(*SW),
                      W, jnp.asarray(mm) if with_mm else None,
                      interpret=True)
        got = K.banded_score_semiglobal_regtile(
            torch.from_numpy(pats), torch.from_numpy(plens),
            torch.from_numpy(txts), torch.from_numpy(tlens),
            GotohScoring(*SW), W, torch.from_numpy(mm) if with_mm else None)
        for g, w in zip(got, want):
            assert g.shape == (B,)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
