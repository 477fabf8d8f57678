"""Port parity of the FM index (CPU): nvbio_tpu_torch.fmi and index.sa
against nvbio_tpu's on the same seeded texts, with no tolerance (integer
outputs): suffix arrays, index arrays key for key, ranks at every position,
backward search with and without the k-mer table, locate of every row, the
all-symbol interval split, the 1-mismatch top-K search (ties included) and
the ``.fmi.npz`` artifact across packages. The texts' lengths put the end
of the text on and off the 64-symbol blocks and 16-symbol words."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvbio_tpu_torch import convert
from nvbio_tpu_torch.align import kernels as tkernels
from nvbio_tpu_torch.fmi import index as tidx
from nvbio_tpu_torch.fmi import search as tsearch
from nvbio_tpu_torch.index.sa import suffix_array as t_suffix_array

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

# both packages' ``fmi`` re-export functions named like their modules
jidx = importlib.import_module("nvbio_tpu.fmi.index")
jrank = importlib.import_module("nvbio_tpu.fmi.rank")
trank = importlib.import_module("nvbio_tpu_torch.fmi.rank")
jsearch = importlib.import_module("nvbio_tpu.fmi.search")
jsa = importlib.import_module("nvbio_tpu.index.sa")

SIZES = (1000, 1008, 4096, 4097, 10007)
Q, LQ = 256, 14


def _text(n, seed=None):
    return np.random.default_rng(n if seed is None else seed).integers(
        0, 4, n).astype(np.uint8)


@pytest.fixture(scope="module", params=SIZES)
def pair(request):
    """(text, JAX FMIndex on the device path, port FMIndex) of one size."""
    n = request.param
    text = _text(n)
    jf = jidx.build_fmindex(text)
    return text, jf, jf.device(), tidx.build_fmindex(text)


def _queries(text, rng, L=LQ):
    """Q queries of up to L symbols: half text substrings (the text's first
    and last L symbols among them, so intervals reach row ``primary`` and
    the last rows), half random; lengths 0..L."""
    n = len(text)
    qs = rng.integers(0, 4, (Q, L)).astype(np.int32)
    starts = rng.integers(0, n - L, Q // 2)
    starts[:2] = (0, n - L)
    for t, p in enumerate(starts):
        qs[t] = text[p:p + L]
    lens = rng.integers(0, L + 1, Q).astype(np.int32)
    lens[:2] = L
    return qs, lens


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=msg)


@pytest.mark.parametrize("method", ["native", "doubling"])
@pytest.mark.parametrize("n", [1, 97, 4096, 10007])
def test_suffix_array_matches_jax(method, n):
    text = _text(n)
    np.testing.assert_array_equal(t_suffix_array(text, method=method),
                                  jsa.suffix_array(text, method="doubling"))


def test_suffix_array_on_the_card_is_refused():
    # the sort on the card is ported (index/device_sa.py): it runs on the
    # card unless the caller asks for the CPU, so without a card it stops;
    # on the CPU it gives the JAX package's suffix array
    text = _text(10)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_suffix_array(text, method="device")
    np.testing.assert_array_equal(
        t_suffix_array(text, method="device", device="cpu"),
        jsa.suffix_array(text, method="doubling"))


def test_build_fmindex_arrays_match_jax(pair):
    text, jf, _, tf = pair
    assert (tf.primary, tf.n, tf.sa_interval) == (jf.primary, jf.n,
                                                   jf.sa_interval)
    for key in ("bwt_words", "occ", "count", "ssa_marks", "ssa_cum",
                "ssa_vals"):
        got = getattr(tf, key).numpy()
        want = np.asarray(getattr(jf, key))
        if want.dtype == np.uint32:
            got = got.view(np.uint32)
        assert got.shape == want.shape, key
        np.testing.assert_array_equal(got, want, err_msg=key)
    n = len(text)
    assert tf.rank_rows.shape == (n // trank.K + 2, trank.ROW)
    assert tf.ssa_rows.shape == (jf.ssa_marks.shape[0], 2)


def test_rank_and_rank_all_at_every_position(pair):
    text, jf, _, tf = pair
    n = len(text)
    i = np.arange(n + 1, dtype=np.int32)
    bw, occ = jnp.asarray(jf.bwt_words), jnp.asarray(jf.occ)
    for c in range(4):
        _eq(jrank.rank(bw, occ, jnp.full(n + 1, c), jnp.asarray(i)),
            trank.rank(tf.rank_rows, torch.full((n + 1,), c),
                       torch.from_numpy(i)), f"rank c={c}")
    _eq(jrank.rank_all(bw, occ, jnp.asarray(i)),
        trank.rank_all(tf.rank_rows, torch.from_numpy(i)), "rank_all")


def test_symbol_and_rank_matches_the_fused_rows(pair, monkeypatch):
    text, jf, _, tf = pair
    n = len(text)
    monkeypatch.setenv("NVBIO_TPU_RANKTAB", "1")
    ranktab = jf.device().ranktab
    monkeypatch.delenv("NVBIO_TPU_RANKTAB")
    i = np.arange(n + 1, dtype=np.int32)
    jc, jr = jrank.symbol_and_rank_fused(ranktab, jnp.asarray(i))
    tc, tr = trank.symbol_and_rank(tf.rank_rows, torch.from_numpy(i))
    _eq(jc, tc, "symbol")
    _eq(jr, tr, "rank")
    bwt, _ = tidx.bwt_from_sa(text, t_suffix_array(text))
    np.testing.assert_array_equal(tc.numpy()[:n], bwt)


@pytest.mark.parametrize("k", [0, 4, 6])
def test_backward_search_matches_jax(pair, k):
    text, _, jd, tf = pair
    qs, lens = _queries(text, np.random.default_rng(len(text) + k))
    if k:
        jd = jidx.attach_ftab(jd, k)
        tf = tidx.attach_ftab(tf, k)
        _eq(jd.ftab_lo, tf.ftab_lo, "ftab_lo")
        _eq(jd.ftab_hi, tf.ftab_hi, "ftab_hi")
    jlo, jhi = jsearch.backward_search(jd, jnp.asarray(qs),
                                       jnp.asarray(lens))
    tlo, thi = tsearch.backward_search_core(tf, torch.from_numpy(qs),
                                            torch.from_numpy(lens))
    _eq(jlo, tlo, "lo")
    _eq(jhi, thi, "hi")
    assert (thi > tlo)[: Q // 2].all()       # every substring is found
    if k:
        # with the table or without: the same nonempty intervals (empty
        # ones may stop at another row; no hit is read from them)
        nlo, nhi = tsearch.backward_search_core(
            tf.without_ftab(), torch.from_numpy(qs), torch.from_numpy(lens))
        ne = nhi > nlo
        assert torch.equal(thi > tlo, ne)
        assert torch.equal(tlo[ne], nlo[ne]) and torch.equal(thi[ne], nhi[ne])


def test_convert_carries_the_jax_ftab(pair):
    text, _, jd, tf = pair
    jd = jidx.attach_ftab(jd, 5)
    conv = convert.fmindex_from_arrays(
        *(np.asarray(getattr(jd, f)) for f in (
            "bwt_words", "occ", "count", "primary", "n", "sa_interval",
            "ssa_marks", "ssa_cum", "ssa_vals", "ftab_k", "ftab_lo",
            "ftab_hi")), device="cpu")
    assert conv.ftab_k == 5
    own = tidx.attach_ftab(tf, 5)
    for key in ("rank_rows", "ssa_rows", "ftab_lo", "ftab_hi", "ssa_vals"):
        assert torch.equal(getattr(conv, key), getattr(own, key)), key


def test_locate_every_row(pair):
    text, _, jd, tf = pair
    n = len(text)
    rows = np.arange(n + 1, dtype=np.int32)
    jpos, jdone = jsearch.locate_batch(jd, jnp.asarray(rows))
    tpos, tdone = tsearch.locate_core(tf, torch.from_numpy(rows))
    _eq(jpos, tpos, "positions")
    _eq(jdone, tdone, "resolved")
    assert tdone.all()
    np.testing.assert_array_equal(tpos.numpy(), t_suffix_array(text))


def test_extend_backward_all_matches_jax(pair):
    text, _, jd, tf = pair
    n = len(text)
    rng = np.random.default_rng(n + 1)
    lo = rng.integers(0, n + 2, (64, 5)).astype(np.int32)
    hi = np.clip(lo + rng.integers(0, 50, lo.shape), 0, n + 1).astype(
        np.int32)
    lo[0, :3] = (0, tf.primary, n)
    hi[0, :3] = (n + 1, tf.primary + 1, n + 1)
    jl, jh = jsearch.extend_backward_all(jd, jnp.asarray(lo), jnp.asarray(hi))
    tl, th = tsearch.extend_backward_all(tf, torch.from_numpy(lo),
                                         torch.from_numpy(hi))
    _eq(jl, tl, "lo4")
    _eq(jh, th, "hi4")


def _tandem_text(rng):
    """A 37-symbol unit tiled 120 times with 3% point edits, then 700
    random symbols: seeds with several nonempty 1-mismatch branches."""
    unit = rng.integers(0, 4, 37)
    text = np.tile(unit, 120)
    edit = rng.random(text.size) < 0.03
    text[edit] = rng.integers(0, 4, int(edit.sum()))
    return np.concatenate([text, rng.integers(0, 4, 700)]).astype(np.uint8)


@pytest.mark.parametrize("K", [8, 40])
def test_search_1mm_hybrid_topk_matches_jax(K):
    """A tandem-repeat text (a 37-symbol unit, copies with point edits):
    many seeds have several nonempty branches, so the top-K score ties (and
    K = 8 drops some); K = 40 >= 3 * n_approx keeps every branch."""
    rng = np.random.default_rng(9)
    text = _tandem_text(rng)
    jd = jidx.build_fmindex(text).device()
    tf = tidx.build_fmindex(text)
    L, A = 22, 11
    qs, lens = _queries(text, rng, L)
    lens[Q // 2:] = L                # random seeds: full length
    jout = jsearch.search_1mm_hybrid_topk(jd, jnp.asarray(qs),
                                          jnp.asarray(lens), A, K)
    tout = tsearch.search_1mm_hybrid_topk(tf, torch.from_numpy(qs),
                                          torch.from_numpy(lens), A, K)
    for name, a, b in zip(("exact_lo", "exact_hi", "mm_lo", "mm_hi"), jout,
                          tout):
        _eq(a, b, name)
    mm_lo, mm_hi = tout[2], tout[3]
    assert mm_lo.shape == (Q, min(K, 3 * A))
    n_branch = (mm_hi > mm_lo).sum(dim=1)
    assert (n_branch >= 2).sum() > 20
    if K == 8:
        assert (n_branch == K).any()     # the compaction cut some seeds


@pytest.mark.parametrize("K", [1, 8, 40])
def test_topk_survivors_are_the_first_K_nonempty_branches(K):
    """The rule of the 1-mismatch top-K search (the card's kernel walks it
    as written here), restated with plain backward searches: the exact
    interval is the query's; the survivors are the first K branches (j,
    delta), j < min(n_approx, qlen) ascending, delta 1..3, whose
    substituted suffix q'[j:qlen] (q'[j] = (q[j] + delta) % 4) occurs;
    each holds the whole substituted query's interval, (0, 0) where that
    is empty, and the slots past them hold (0, 0)."""
    rng = np.random.default_rng(11)
    text = _tandem_text(rng)
    tf = tidx.build_fmindex(text)
    L, A = 22, 11
    qs, lens = _queries(text, rng, L)
    lens[Q // 2:] = L
    q, ql = torch.from_numpy(qs), torch.from_numpy(lens)
    elo, ehi, mlo, mhi = tsearch.search_1mm_hybrid_topk(tf, q, ql, A, K)
    wlo, whi = tsearch.backward_search_core(tf, q, ql)
    assert torch.equal(elo, wlo) and torch.equal(ehi, whi)

    # every branch's substituted suffix (left-aligned) and whole query
    b, j, d = np.meshgrid(np.arange(Q), np.arange(A), np.arange(1, 4),
                          indexing="ij")
    b, j, d = b.ravel(), j.ravel(), d.ravel()
    whole = qs[b].copy()
    whole[np.arange(b.size), j] = (whole[np.arange(b.size), j] + d) % 4
    cols = np.minimum(j[:, None] + np.arange(L), L - 1)
    suffix = np.take_along_axis(whole, cols, axis=1)
    slen = np.maximum(lens[b] - j, 0)
    slo, shi = tsearch.backward_search_core(
        tf, torch.from_numpy(suffix), torch.from_numpy(slen))
    flo, fhi = tsearch.backward_search_core(
        tf, torch.from_numpy(whole), torch.from_numpy(lens[b]))
    occurs = ((j < lens[b]) & (shi > slo).numpy()).reshape(Q, A * 3)
    flo, fhi = flo.reshape(Q, A * 3), fhi.reshape(Q, A * 3)
    Kout = min(K, 3 * A)
    assert mlo.shape == (Q, Kout)
    n_cut = 0
    for r in range(Q):
        sel = np.nonzero(occurs[r])[0][:Kout]
        want = [(int(flo[r, i]), int(fhi[r, i])) if fhi[r, i] > flo[r, i]
                else (0, 0) for i in sel]
        want += [(0, 0)] * (Kout - len(want))
        assert [(int(a), int(c)) for a, c in zip(mlo[r], mhi[r])] == want
        n_cut += int(occurs[r].sum() > Kout)
    assert occurs.sum() > Q and (n_cut > 0) == (K < 40)


def test_walks_take_the_plain_versions_for_cpu_tensors(pair):
    """On CPU tensors backward search (with a k = 4 table), locate and the
    top-K search return their plain versions' results and launch no
    kernel; a tensor on neither the CPU nor a card is refused."""
    text, _, _, tf = pair
    tf4 = tidx.attach_ftab(tf, 4)
    qs, lens = _queries(text, np.random.default_rng(len(text) + 7))
    q, ql = torch.from_numpy(qs), torch.from_numpy(lens)
    rows = torch.arange(len(text) + 1)
    before = (tkernels.fm_backward_search.launches,
              tkernels.fm_locate.launches,
              tkernels.fm_search_1mm_topk.launches)
    for got, want in (
            (tsearch.backward_search_core(tf4, q, ql),
             tsearch.backward_search_core_plain(tf4, q, ql)),
            (tsearch.locate_core(tf, rows),
             tsearch.locate_core_plain(tf, rows)),
            (tsearch.search_1mm_hybrid_topk(tf, q, ql, 7, K=8),
             tsearch.search_1mm_hybrid_topk_plain(tf, q, ql, 7, K=8))):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert before == (tkernels.fm_backward_search.launches,
                      tkernels.fm_locate.launches,
                      tkernels.fm_search_1mm_topk.launches)
    with pytest.raises(ValueError, match="unsupported device"):
        tsearch.backward_search_core(tf4, q.to("meta"), ql.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        tsearch.locate_core(tf, rows.to("meta"))


def test_fmi_npz_across_packages(pair, tmp_path):
    text, jf, jd, tf = pair
    tf.save(str(tmp_path / "port.fmi.npz"))
    jf.save(str(tmp_path / "jax.fmi.npz"))
    back = jidx.FMIndex.load(str(tmp_path / "port.fmi.npz"))
    for key in ("bwt_words", "occ", "count", "ssa_marks", "ssa_cum",
                "ssa_vals"):
        a, b = np.asarray(getattr(back, key)), np.asarray(getattr(jf, key))
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    assert (back.primary, back.n, back.sa_interval) == (
        jf.primary, jf.n, jf.sa_interval)
    z_port = np.load(str(tmp_path / "port.fmi.npz"))
    z_jax = np.load(str(tmp_path / "jax.fmi.npz"))
    assert sorted(z_port.files) == sorted(z_jax.files)
    mine = tidx.FMIndex.load(str(tmp_path / "jax.fmi.npz"))
    for key in ("bwt_words", "occ", "count", "ssa_marks", "ssa_cum",
                "ssa_vals", "rank_rows", "ssa_rows"):
        assert torch.equal(getattr(mine, key), getattr(tf, key)), key
    assert mine.primary == tf.primary and mine.ftab_lo is None
