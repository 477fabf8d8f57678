"""Port parity of the tries, the string sets and the q-gram indexes' library
calls (CPU): ``SortedDictionary`` (numpy and tensor queries,
``prefix_range``), ``CsrTrie.walk`` (an N code walks as T, as the JAX
gather clamps it; padding past ``qlen``), ``SuffixTrie`` (arrays,
``nth_child``, ``is_leaf`` and ``walk`` under ``min_count`` and
``max_depth``), every string-set view, ``QGramSetIndex`` (arrays, range
and locate, with stride and N windows) and ``qgram_count``, each against
``nvbio_tpu`` on the same seeded inputs, exactly."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvbio_tpu import qgram as jq
from nvbio_tpu import stringset as jss
from nvbio_tpu import trie as jtrie
from nvbio_tpu_torch import convert
from nvbio_tpu_torch import qgram as tq
from nvbio_tpu_torch import stringset as tss
from nvbio_tpu_torch import trie as ttrie

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(_np(x), _np(y))


@pytest.fixture(scope="module")
def words():
    rng = np.random.default_rng(23)
    strs = [rng.integers(0, 4, int(rng.integers(1, 9))) for _ in range(60)]
    strs += [strs[3][:2], strs[7]]               # a prefix and a duplicate
    queries = strs[::3] + [rng.integers(0, 4, int(rng.integers(1, 9)))
                           for _ in range(12)]
    return strs, jtrie.pack_keys(queries)


@pytest.mark.parametrize("form", ["numpy", "tensor"])
def test_sorted_dictionary_equals_jax(words, form):
    strs, qk = words
    jd = jtrie.SortedDictionary.build(strs, payload=np.arange(len(strs)) * 3)
    td = ttrie.SortedDictionary.build(strs, payload=np.arange(len(strs)) * 3)
    np.testing.assert_array_equal(jtrie.pack_keys(strs),
                                  ttrie.pack_keys(strs))
    _eq((jd.keys, jd.payload), (td.keys, td.payload))
    if form == "tensor":
        td = td.to("cpu")
        assert isinstance(td.keys, torch.Tensor)
        got = td.find(torch.from_numpy(qk))
        want = jd.device().find(jnp.asarray(qk))
    else:
        got, want = td.find(qk), jd.find(qk)
        assert isinstance(got[1], np.ndarray)
    _eq(want, got)
    for p in ([], [0], [2, 1], [3, 3, 3], list(strs[5])):
        assert td.prefix_range(p) == jd.prefix_range(p), p
    carried = convert.sorted_dictionary_from_arrays(jd.keys, jd.payload)
    _eq(carried.find(qk), want)
    with pytest.raises(ValueError, match="31 bits"):
        ttrie.SortedDictionary.build(strs, max_len=11).to("cpu")


def test_csr_trie_walk_equals_jax(words):
    strs, _ = words
    jt = jtrie.CsrTrie.build(strs)
    tt = ttrie.CsrTrie.build(strs)
    _eq((jt.children, jt.terminal), (tt.children, tt.terminal))
    rng = np.random.default_rng(3)
    q = np.full((len(strs), 10), 4, np.int32)          # pad with N
    ql = np.array([len(s) for s in strs], np.int32)
    for i, s in enumerate(strs):
        q[i, :len(s)] = s
    q[::4, 1] = 4                                      # an N inside
    ql[::5] += 2                                       # walk into padding
    q[-5:] = rng.integers(0, 5, (5, 10))
    want = np.asarray(jt.walk(q, ql))
    np.testing.assert_array_equal(tt.walk(q, ql, device="cpu").numpy(), want)
    np.testing.assert_array_equal(
        tt.walk(torch.from_numpy(q), torch.from_numpy(ql)).numpy(), want)
    # ACG and ACT: "AC" + N walks as "ACT", as the JAX gather clamps it
    jt2 = jtrie.CsrTrie.build([np.array([0, 1, 2]), np.array([0, 1, 3])])
    tt2 = convert.csr_trie_from_arrays(jt2.children, jt2.terminal)
    qn, qnl = np.array([[0, 1, 4]]), np.array([3])
    assert int(np.asarray(jt2.walk(qn, qnl))[0]) == 1
    assert int(tt2.walk(qn, qnl, device="cpu")[0]) == 1


@pytest.fixture(scope="module")
def trie_text():
    return np.random.default_rng(29).integers(0, 4, 300, dtype=np.uint8)


@pytest.mark.parametrize("max_depth,min_count", [(None, 1), (6, 2), (4, 1)])
def test_suffix_trie_equals_jax(trie_text, max_depth, min_count):
    jt = jtrie.SuffixTrie.build(trie_text, max_depth=max_depth,
                                min_count=min_count)
    tt = ttrie.SuffixTrie.build(trie_text, max_depth=max_depth,
                                min_count=min_count, device="cpu")
    for f in dataclasses.fields(jt):
        a, b = getattr(jt, f.name), getattr(tt, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    for u in range(0, len(tt.count), max(1, len(tt.count) // 40)):
        assert tt.is_leaf(u) == jt.is_leaf(u)
        for i in range(5):
            assert tt.nth_child(u, i) == jt.nth_child(u, i)
    rng = np.random.default_rng(len(tt.count))
    q = np.stack([trie_text[p:p + 9] for p in rng.integers(0, 290, 30)])
    q[::3] = rng.integers(0, 4, (10, 9))
    ql = rng.integers(0, 10, 30)
    _eq(jt.walk(q, ql), tt.walk(q, ql, device="cpu"))
    c = convert.suffix_trie_from_arrays(jt.children, jt.mask, jt.first_child,
                                        jt.count, jt.depth, jt.sa_lo)
    _eq(jt.walk(q, ql), c.walk(torch.from_numpy(q), torch.from_numpy(ql)))


def test_string_sets_equal_jax():
    rng = np.random.default_rng(31)
    strs = ["".join(rng.choice(list("ACGTN"), int(rng.integers(0, 12))))
            for _ in range(9)]
    jc = jss.ConcatStringSet.from_strings(strs)
    tc = tss.ConcatStringSet.from_strings(strs)
    _eq((jc.codes, jc.offsets, jc.lengths), (tc.codes, tc.offsets,
                                               tc.lengths))
    assert len(tc) == len(jc) and (tc[4] == jc[4]).all()
    for ml, pad in ((None, 0), (14, 4)):
        jp, tp = jc.to_padded(ml, pad), tc.to_padded(ml, pad)
        _eq((jp.codes, jp.lengths, jp.mask()), (tp.codes, tp.lengths,
                                                 tp.mask()))
        dp = tp.to("cpu")
        _eq((dp.codes, dp.lengths, dp.mask()), (tp.codes, tp.lengths,
                                                 tp.mask()))
        assert dp.max_len == tp.max_len and len(dp) == len(tp)
    with pytest.raises(ValueError):
        tc.to_padded(3)
    base = rng.integers(0, 4, 50, dtype=np.uint8)
    starts = np.array([0, 10, 45, 48])
    np.testing.assert_array_equal(jss.make_infix_set(base, starts, 6),
                                  tss.make_infix_set(base, starts, 6))
    lens = np.array([5, 0, 5, 2])
    for L in (None, 7):
        a = jss.SparseStringSet(base, starts, lens).to_padded(L, 9)
        b = tss.SparseStringSet(base, starts, lens).to_padded(L, 9)
        _eq((a.codes, a.lengths), (b.codes, b.lengths))
    assert (tss.SparseStringSet(base, starts, lens)[2]
            == jss.SparseStringSet(base, starts, lens)[2]).all()
    jst = jss.StridedStringSet.from_padded(jc.to_padded())
    tst = tss.StridedStringSet.from_padded(tc.to_padded())
    _eq((jst.base, jst.lens), (tst.base, tst.lens))
    assert tst.stride == jst.stride and len(tst) == len(jst)
    assert (tst[3] == jst[3]).all()
    _eq((jst.to_padded().codes,), (tst.to_padded().codes,))
    for mk, arg in ((("make_prefix_set"), np.array([2, 30, 0, 5, 1, 9, 3, 4,
                                                    7])),
                    (("make_suffix_set"), np.array([1, 0, 40, 2, 3, 1, 0, 5,
                                                    6]))):
        a = getattr(jss, mk)(jc, arg).to_padded()
        b = getattr(tss, mk)(tc, arg).to_padded()
        _eq((a.codes, a.lengths), (b.codes, b.lengths))


@pytest.fixture(scope="module")
def read_set():
    rng = np.random.default_rng(37)
    seqs = rng.integers(0, 4, (60, 40)).astype(np.uint8)
    seqs[10:20] = seqs[0:10]                          # shared q-grams
    seqs[3, 7] = seqs[15, 20] = 4                     # N windows
    lens = rng.integers(12, 41, 60)
    return seqs, lens


@pytest.mark.parametrize("q,stride,qlut", [(6, 1, 8), (11, 3, 4), (15, 2, 8)])
def test_qgram_set_index_equals_jax(read_set, q, stride, qlut):
    seqs, lens = read_set
    ji = jq.build_qgram_set_index(seqs, lens, q, stride, qlut)
    ti = tq.build_qgram_set_index(seqs, lens, q, stride, qlut)
    for f in ("qgrams", "slots", "coord_str", "coord_pos", "lut"):
        a, b = getattr(ji, f), getattr(ti, f)
        np.testing.assert_array_equal(a, b.numpy(), err_msg=f)
        assert a.dtype == b.numpy().dtype
    assert (ji.q, ji.qlut, ji.max_probe) == (ti.q, ti.qlut, ti.max_probe)
    rng = np.random.default_rng(q)
    keys = np.concatenate([np.asarray(ji.qgrams)[::3],
                           rng.integers(0, 4 ** q, 40)]).astype(np.int32)
    jd = ji.device()
    want = jq.set_index_range(jd, jnp.asarray(keys))
    _eq(want, tq.set_index_range(ti, torch.from_numpy(keys)))
    slots = np.arange(len(ji.coord_pos) + 3, dtype=np.int32)
    _eq(jq.set_index_locate(jd, jnp.asarray(slots)),
        tq.set_index_locate(ti, slots))
    carried = convert.qgram_set_index_from_arrays(
        ji.q, ji.qgrams, ji.slots, ji.coord_str, ji.coord_pos, ji.qlut,
        ji.lut, ji.max_probe, device="cpu")
    _eq(want, tq.set_index_range(carried, keys))


def test_qgram_count_equals_jax():
    rng = np.random.default_rng(41)
    g = rng.integers(0, 4, 4000, dtype=np.uint8)
    g[1000:1200] = g[2000:2200]
    ji, ti = jq.build_qgram_index(g, 8), tq.build_qgram_index(g, 8)
    q = np.stack([g[p:p + 14] for p in rng.integers(0, 3980, 40)])
    q[::4] = rng.integers(0, 4, (10, 14))
    q = q.astype(np.int32)
    want = np.asarray(jq.qgram_count(ji.device(), jnp.asarray(q)))
    np.testing.assert_array_equal(tq.qgram_count(ti, q).numpy(), want)
    assert (want > 1).any() and (want == 0).any()


def test_walks_and_builds_need_a_card_or_cpu(words, trie_text):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    strs, _ = words
    q, ql = np.zeros((2, 3), np.int32), np.array([3, 1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrie.CsrTrie.build(strs).walk(q, ql)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrie.SuffixTrie.build(trie_text, max_depth=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.qgram_set_index_from_arrays(
            6, np.zeros(0), np.zeros(1), np.zeros(0), np.zeros(0), 6,
            np.zeros(4 ** 6 + 1), 1)
