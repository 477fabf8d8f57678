"""The port's blockwise BWT (``nvbio_tpu_torch.index.blockwise``) against
the JAX package, on the CPU.

The texts and knobs of ``tests/test_blockwise.py``: a random text through
many chunks, superblocks and blocks, one block with the default knobs,
odd lengths, a repeat-rich text (deepening forced, then the host tiny-tie
path), homopolymer runs (full-plane deepening, then the host fallback at
the round cap) and the ``emit`` stream. Every BWT and primary row must
equal the JAX package's oracle, ``bwt_from_sa(codes,
suffix_array(codes))`` (the BWT is unique, so this is also the JAX
blockwise output). Where a case sets its knobs, the JAX ``blockwise_bwt``
runs too and the decomposition (``superblocks``, ``blocks``, ``sb_sizes``,
``primary``) and the tie work (``deepen_rounds``, ``host_tie_small``,
``host_tie_fallbacks``) must be equal; the JAX builder never runs with its
default knobs (169 M-row planes, minutes on a CPU).
"""

import numpy as np
import pytest
import torch

from nvbio_tpu.fmi.index import bwt_from_sa
from nvbio_tpu.index.sa import suffix_array
from nvbio_tpu_torch.index.blockwise import blockwise_bwt

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

DECOMPOSITION = ("superblocks", "blocks", "sb_sizes", "primary",
                 "deepen_rounds", "host_tie_small", "host_tie_fallbacks")


@pytest.fixture
def rng():
    return np.random.default_rng(99)


def _check(codes, jax_too=False, **kw):
    bwt, primary, stats = blockwise_bwt(codes, device="cpu", **kw)
    want, wprim = bwt_from_sa(codes, suffix_array(codes))
    assert primary == wprim == stats["primary"]
    np.testing.assert_array_equal(bwt, want)
    if jax_too:
        from nvbio_tpu.index.blockwise import blockwise_bwt as j_blockwise

        jbwt, jprim, jstats = j_blockwise(codes, **kw)
        np.testing.assert_array_equal(jbwt, bwt)
        for k in DECOMPOSITION:
            assert stats[k] == jstats.get(k, 0), k
    return stats


def _repeat_rich(rng):
    """30 kbp of random bases, then 40 copies of a 700 bp unit with ~1%
    divergence each."""
    unit = rng.integers(0, 4, size=700, dtype=np.uint8)
    copies = []
    for _ in range(40):
        c = unit.copy()
        mut = rng.random(700) < 0.01
        c[mut] = rng.integers(0, 4, size=int(mut.sum()), dtype=np.uint8)
        copies.append(c)
    return np.concatenate(
        [rng.integers(0, 4, size=30_000, dtype=np.uint8)] + copies)


def _homopolymer(rng):
    return np.concatenate([
        rng.integers(0, 4, size=2_000, dtype=np.uint8),
        np.zeros(3_000, np.uint8),           # A^3000
        rng.integers(0, 4, size=2_000, dtype=np.uint8),
        np.full(1_000, 3, np.uint8),         # T^1000
    ])


def test_blockwise_random_multi_everything(rng):
    codes = rng.integers(0, 4, size=100_000, dtype=np.uint8)
    stats = _check(codes, jax_too=True, chunk=1 << 14, sb_cap=1 << 15,
                   blk=1 << 13)
    assert stats["superblocks"] >= 3
    assert stats["blocks"] >= 8
    assert sum(stats["sb_sizes"]) == len(codes) + 1


def test_blockwise_single_block(rng):
    """Default knobs: the planes are sized from what the text needs."""
    codes = rng.integers(0, 4, size=5_000, dtype=np.uint8)
    stats = _check(codes)
    assert stats["blocks"] == stats["superblocks"]


@pytest.mark.parametrize("ln", [1, 15, 16, 17, 255, 4097])
def test_blockwise_odd_length(rng, ln):
    codes = rng.integers(0, 4, size=ln, dtype=np.uint8)
    _check(codes, chunk=1 << 10, sb_cap=1 << 11, blk=1 << 9)


def test_blockwise_repeat_rich(rng):
    codes = _repeat_rich(rng)
    stats = _check(codes, jax_too=True, chunk=1 << 14, sb_cap=1 << 15,
                   blk=1 << 13, host_tie_cap=0)   # force the deepening path
    assert stats["deepen_rounds"] > 0
    # default tie caps: the few tied rows take the host tiny-tie path
    stats2 = _check(codes, chunk=1 << 14, sb_cap=1 << 15, blk=1 << 13)
    assert stats2["host_tie_small"] > 0
    assert stats2["deepen_rounds"] == 0


def test_blockwise_homopolymer_runs(rng):
    codes = _homopolymer(rng)
    _check(codes, chunk=1 << 12, sb_cap=1 << 13, blk=1 << 13, tie_cap=64)
    # without the tiny-tie path, massive tie groups take full-plane
    # deepening rounds (more than tie_cap rows tied)
    stats = _check(codes, chunk=1 << 12, sb_cap=1 << 13, blk=1 << 13,
                   tie_cap=64, host_tie_cap=0)
    assert stats["deepen_rounds"] > 0
    assert stats["host_tie_fallbacks"] == 0
    # a 3-round budget leaves ties for the host fallback
    stats = _check(codes, jax_too=True, chunk=1 << 12, sb_cap=1 << 13,
                   blk=1 << 13, tie_cap=64, max_deepen=3, host_tie_cap=0)
    assert stats["host_tie_fallbacks"] > 0


def test_blockwise_emit_streaming(rng):
    """Concatenated emitted blocks (primary row included) equal the full
    n+1-row BWT plane."""
    codes = rng.integers(0, 4, size=20_000, dtype=np.uint8)
    pieces = []
    bwt, primary, stats = blockwise_bwt(
        codes, chunk=1 << 13, sb_cap=1 << 14, blk=1 << 12,
        emit=pieces.append, device="cpu")
    assert bwt is None and len(pieces) == stats["blocks"] > 1
    full = np.concatenate(pieces)
    assert len(full) == len(codes) + 1
    want, wprim = bwt_from_sa(codes, suffix_array(codes))
    assert primary == wprim
    np.testing.assert_array_equal(np.delete(full, primary), want)


def test_blockwise_rejects_texts_past_its_reach():
    with pytest.raises(ValueError, match="2\\^32"):
        blockwise_bwt(np.zeros(0, np.uint8), device="cpu")
