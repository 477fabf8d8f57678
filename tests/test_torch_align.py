"""Port parity: the CUDA kernels' plain versions and the host formatters of
nvbio_tpu_torch.align against nvbio_tpu.align (CPU; Pallas in interpret
mode). All outputs are integers and must be exactly equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvbio_tpu import packed as jpacked
from nvbio_tpu.align import traceback as jtb
from nvbio_tpu.align.batch import batch_score_banded as j_score_banded
from nvbio_tpu.align.pallas_kernels import (
    banded_score_cands_regtile,
    banded_traceback_semiglobal_pallas,
)
from nvbio_tpu.align.types import SEMI_GLOBAL, GotohAligner
from nvbio_tpu.align.types import GotohScoring as JScoring
from nvbio_tpu_torch.align import kernels as K
from nvbio_tpu_torch.align import traceback as ttb
from nvbio_tpu_torch.align.types import NEG_INF, GotohScoring
from nvbio_tpu_torch.packed import words_to_tensor

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

SCORINGS = {
    "sw": (0, -6, -8, -3, -8, -3),   # bowtie2 end-to-end (seq F, te >= to)
    "ed": (0, -1, -1, -1, -1, -1),   # --mode ed
    "lazy": (1, -2, -5, -1, -2, -4),  # te < to: the lazy-F branch
}


def _t(a, dt=torch.int32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dt)


def _cand_inputs(rng, B, C, L, W, n=40_000):
    """Reads sampled from a genome (substitutions + a 1 bp indel in some),
    candidate windows: slot 0 of the read's strand half at the truth, the
    others jittered or random, a few running past the genome's end."""
    genome = rng.integers(0, 4, size=n, dtype=np.uint8)
    TW = L + W - 1
    md = (W - 1) // 2
    starts = rng.integers(md, n - 2 * L, size=B)
    pats = genome[starts[:, None] + np.arange(L + 1)].astype(np.int32)
    dele = rng.random(B) < 0.3
    cut = rng.integers(3, L - 3, size=B)
    j = np.arange(L)[None, :]
    pats = np.where(dele[:, None] & (j >= cut[:, None]), pats[:, 1:],
                    pats[:, :L])
    sub = rng.random((B, L)) < 0.05
    pats = np.where(sub, (pats + rng.integers(1, 4, size=(B, L))) % 4, pats)
    pats[rng.random((B, L)) < 0.01] = 4                   # read Ns
    is_rc = rng.random(B) < 0.5
    reads = np.where(is_rc[:, None], np.where(pats > 3, 4, 3 - pats)[:, ::-1],
                     pats)
    lens = rng.integers(L // 2, L + 1, size=B).astype(np.int32)
    lens[:4] = [0, 1, L, L]
    rc = np.zeros_like(reads)
    for b in range(B):          # reverse complement of the first lens[b]
        r = reads[b, :lens[b]][::-1]
        rc[b, :lens[b]] = np.where(r > 3, 4, 3 - r)
    nch = C // 2
    w0 = rng.integers(0, n, size=(B, C))
    half = np.where(is_rc, nch, 0)
    w0[np.arange(B), half] = starts - md
    w0[:, 1] = np.clip(w0[:, 0] + rng.integers(-W, W + 1, size=B), 0, n - 1)
    w0[:16, C - 1] = n - rng.integers(1, TW + 3, size=16)
    w0 = np.clip(w0, 0, n - 1)
    wlens = np.minimum(n - w0, TW).astype(np.int32)
    mm = -rng.integers(2, 7, size=(B, L)).astype(np.int32)
    mm_rc = np.zeros_like(mm)
    for b in range(B):
        mm_rc[b, :lens[b]] = mm[b, :lens[b]][::-1]
    words = jpacked.pack(genome, 2)
    return dict(genome=genome, words=words, reads=reads, rc=rc, lens=lens,
                w0=w0, wlens=wlens, mm=mm, mm_rc=mm_rc, nch=nch)


@pytest.mark.parametrize("with_mm", [True, False])
def test_score_cands_plain_matches_regtile_interpret(rng, with_mm):
    B, C, L, W = 1024, 4, 24, 7
    d = _cand_inputs(rng, B, C, L, W)
    sc = GotohScoring(*SCORINGS["sw"])
    mm = (d["mm"], d["mm_rc"]) if with_mm else (None, None)
    js, jk = banded_score_cands_regtile(
        jnp.asarray(d["reads"]), jnp.asarray(d["rc"]), jnp.asarray(d["lens"]),
        jnp.asarray(d["w0"].T.reshape(C * B).astype(np.int32)),
        jnp.asarray(d["wlens"].T.reshape(C * B)), jnp.asarray(d["words"]),
        JScoring(*SCORINGS["sw"]), W, C, d["nch"],
        None if mm[0] is None else jnp.asarray(mm[0]),
        None if mm[1] is None else jnp.asarray(mm[1]), interpret=True)
    ts, tk = K.banded_score_cands(
        _t(d["reads"]), _t(d["rc"]), _t(d["lens"]), _t(d["w0"], torch.int64),
        _t(d["wlens"]), words_to_tensor(d["words"], "cpu"), sc, W, d["nch"],
        None if mm[0] is None else _t(mm[0]),
        None if mm[1] is None else _t(mm[1]))
    np.testing.assert_array_equal(ts.numpy(),
                                  np.asarray(js).reshape(C, B).T)
    np.testing.assert_array_equal(tk.numpy(),
                                  np.asarray(jk).reshape(C, B).T)
    assert (ts.numpy() > -20).mean() > 0.2   # true loci are among them


@pytest.mark.parametrize("scoring", sorted(SCORINGS))
def test_score_cands_plain_matches_batch_score_banded(rng, scoring):
    """Per (read, slot): the candidate scorer against the JAX scan scorer
    over the extracted windows (scores wherever an alignment exists)."""
    B, C, L, W = 256, 6, 30, 9
    d = _cand_inputs(rng, B, C, L, W)
    sc = GotohScoring(*SCORINGS[scoring])
    ts, _ = K.banded_score_cands_plain(
        _t(d["reads"]), _t(d["rc"]), _t(d["lens"]), _t(d["w0"], torch.int64),
        _t(d["wlens"]), words_to_tensor(d["words"], "cpu"), sc, W, d["nch"],
        _t(d["mm"]), _t(d["mm_rc"]))
    strand = np.arange(C)[None, :] >= d["nch"]
    pats = np.where(strand[..., None], d["rc"][:, None], d["reads"][:, None])
    mms = np.where(strand[..., None], d["mm_rc"][:, None], d["mm"][:, None])
    win = np.asarray(jpacked.extract_window_aligned(
        jnp.asarray(d["words"]), jnp.asarray(d["w0"].reshape(-1)),
        L + W - 1, 2))
    want = j_score_banded(
        jnp.asarray(pats.reshape(B * C, L)),
        jnp.asarray(np.repeat(d["lens"], C)), jnp.asarray(win),
        jnp.asarray(d["wlens"].reshape(-1)),
        GotohAligner(SEMI_GLOBAL, JScoring(*SCORINGS[scoring])), W,
        jnp.asarray(mms.reshape(B * C, L)))
    want = np.asarray(want.score).reshape(B, C)
    # where no alignment exists every cell of the final row sits near
    # NEG_INF, and the two keep their own edge arithmetic there
    real = want > NEG_INF // 2
    assert real.mean() > 0.9
    np.testing.assert_array_equal(ts.numpy()[real], want[real])
    assert (ts.numpy()[~real] < NEG_INF // 2).all()


@pytest.mark.parametrize("scoring", sorted(SCORINGS))
def test_batch_score_banded_matches_jax(rng, scoring):
    B, M, W = 96, 50, 11
    TW = M + W - 1
    pats = rng.integers(0, 5, size=(B, M)).astype(np.int32)
    txts = rng.integers(0, 4, size=(B, TW)).astype(np.int32)
    txts[: B // 2, 5:5 + M] = np.minimum(pats[: B // 2], 3)
    plens = rng.integers(0, M + 1, size=B).astype(np.int32)
    tlens = rng.integers(M // 2, TW + 1, size=B).astype(np.int32)
    mm = -rng.integers(1, 7, size=(B, M)).astype(np.int32)
    want = j_score_banded(
        jnp.asarray(pats), jnp.asarray(plens), jnp.asarray(txts),
        jnp.asarray(tlens),
        GotohAligner(SEMI_GLOBAL, JScoring(*SCORINGS[scoring])), W,
        jnp.asarray(mm))
    score, kbest = K.banded_score_plain(
        _t(pats), _t(plens), _t(txts), _t(tlens),
        GotohScoring(*SCORINGS[scoring]), W, _t(mm))
    np.testing.assert_array_equal(score.numpy(), np.asarray(want.score))
    np.testing.assert_array_equal(kbest.numpy() + plens,
                                  np.asarray(want.sink_text))


def _tb_inputs(rng, B=48, M=40, W=11):
    """test_pallas.test_fused_traceback_parity's inputs, plus read Ns,
    short texts and an empty pattern."""
    TW = M + W - 1
    pats = rng.integers(0, 4, size=(B, M)).astype(np.int32)
    txts = rng.integers(0, 4, size=(B, TW)).astype(np.int32)
    for b in range(0, B, 2):
        t = txts[b, 4:4 + M].copy()
        if b % 4 == 0:
            t = np.concatenate([t[:10], t[11:], t[-1:]])
        elif b % 6 == 1:
            t = np.concatenate([t[:15], [2], t[15:-1]])
        pats[b] = t[:M]
    pats[rng.random((B, M)) < 0.02] = 4
    plens = rng.integers(M // 2, M + 1, size=B).astype(np.int32)
    plens[0] = 0
    tlens = np.full(B, TW, np.int32)
    tlens[1:4] = [M // 2, M, 3]
    mm = -rng.integers(2, 7, size=(B, M)).astype(np.int32)
    return pats, plens, txts, tlens, mm


@pytest.mark.parametrize("scoring", ["sw", "ed"])
def test_traceback_plain_matches_pallas_interpret(rng, scoring):
    B, M, W = 48, 40, 11
    pats, plens, txts, tlens, mm = _tb_inputs(rng, B, M, W)
    want = banded_traceback_semiglobal_pallas(
        jnp.asarray(pats), jnp.asarray(plens), jnp.asarray(txts),
        jnp.asarray(tlens), JScoring(*SCORINGS[scoring]), W, jnp.asarray(mm),
        interpret=True)
    got = K.banded_traceback(_t(pats), _t(plens), _t(txts), _t(tlens),
                             GotohScoring(*SCORINGS[scoring]), W, _t(mm))
    names = ("score", "k_best", "ops", "n_ops", "k_final", "nm", "i_end",
             "i_start")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert int(got[3][0]) == 0                  # the empty pattern walks 0
    assert ((got[2].numpy() & 3) == 3).any()    # deletions were walked
    assert ((got[2].numpy() & 3) == 2).any()    # insertions too


def test_traceback_cigar_matches_scan_traceback(rng):
    B, M, W = 48, 40, 11
    pats, plens, txts, tlens, mm = _tb_inputs(rng, B, M, W)
    ref = jtb.batch_traceback_banded(
        jnp.asarray(pats), jnp.asarray(plens), jnp.asarray(txts),
        jnp.asarray(tlens), GotohAligner(SEMI_GLOBAL, JScoring(
            *SCORINGS["sw"])), W, jnp.asarray(mm))
    tb, nm = ttb.batch_traceback_banded_fast(
        _t(pats), _t(plens), _t(txts), _t(tlens),
        GotohScoring(*SCORINGS["sw"]), W, _t(mm))
    np.testing.assert_array_equal(tb.score.numpy(), np.asarray(ref.score))
    # the JAX scan walk stops after M+W steps (traceback.py:261); a 37-bp
    # pattern over a 3-symbol text zig-zags I/D through the band for more
    # steps than that, and only the kernel walk finishes it. The port
    # follows the kernel (test_traceback_plain_matches_pallas_interpret).
    real = (np.asarray(ref.score) > NEG_INF // 2) & (tlens >= plens)
    assert real.sum() == B - 3
    for f in ("n_ops", "pattern_start", "pattern_end", "text_start",
              "text_end"):
        np.testing.assert_array_equal(getattr(tb, f).numpy()[real],
                                      np.asarray(getattr(ref, f))[real],
                                      err_msg=f)
    ops = tb.ops.numpy()
    for b in np.flatnonzero(real):
        n = int(tb.n_ops[b])
        assert ttb.cigar_to_string(ops[b], n, reverse=True) == \
            jtb.cigar_to_string(np.asarray(ref.ops[b]), n)


def test_cigar_and_md_helpers_match(rng):
    for _ in range(200):
        n = int(rng.integers(0, 60))
        ops = rng.choice([1, 1, 1, 1, 2, 3], size=n)
        mism = (ops == 1) & (rng.random(n) < 0.2)
        sym = rng.integers(0, 16, size=n)
        ent = (ops | (mism.astype(int) << 2) | (sym << 3)).astype(np.uint8)
        ent = np.concatenate([ent, np.zeros(5, np.uint8)])
        for rev in (False, True):
            assert ttb.cigar_to_string(ent, n, reverse=rev) == \
                jtb.cigar_to_string(ent, n, reverse=rev)
            assert ttb.md_from_entries(ent, n, reverse=rev) == \
                jtb.md_from_entries(ent, n, reverse=rev)


def test_kernel_wrappers_reject_what_they_do_not_take(rng):
    """A device other than cpu or cuda is refused; Myers over 16 symbols,
    once refused, is taken and equals the Pallas kernel."""
    from nvbio_tpu.align.pallas_kernels import myers_semiglobal_pallas

    sc = GotohScoring(*SCORINGS["sw"])
    pats = rng.integers(0, 17, size=(4, 10)).astype(np.int32)
    txts = rng.integers(0, 18, size=(4, 30)).astype(np.int32)
    pats[0] = np.arange(3, 13)          # codes of the alphabet, planted
    txts[0, 5:15] = pats[0]
    lens = np.array([10, 7, 0, 10], np.int32)
    tl = np.array([30, 30, 30, 9], np.int32)
    want = myers_semiglobal_pallas(*(jnp.asarray(x) for x in
                                     (pats, lens, txts, tl)),
                                   n_symbols=16, interpret=True)
    got = K.myers_semiglobal(*(torch.from_numpy(x) for x in
                               (pats, lens, txts, tl)), n_symbols=16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[0][0]) == 0
    meta = torch.zeros((4, 10), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        K.banded_traceback(meta, meta[:, 0], meta, meta[:, 0], sc, 7)
    with pytest.raises(ValueError):
        K.banded_score(meta, meta[:, 0], meta, meta[:, 0], sc, 7, local=True)
