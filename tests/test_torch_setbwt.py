"""The port's read-set BWTs (``nvbio_tpu_torch.index.setbwt``,
``paged_text``, ``bwte_device`` and the native BWTE engine) against the JAX
package, on the CPU: the 15 tests of ``tests/test_setbwt.py``, each holding
the port's result bit for bit against the JAX function on the same seeded
inputs (and the brute-force oracles there), plus every incremental method
and one case through the JAX ``BwteDevice``.
"""

import numpy as np
import pytest
import torch

from nvbio_tpu.index import setbwt as J
from nvbio_tpu_torch import native
from nvbio_tpu_torch.index import setbwt as T
from tests.test_setbwt import _mse_oracle, brute_set_bwt

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)


def _ragged(rng, m, lo, hi):
    return [rng.integers(0, 4, int(rng.integers(lo, hi))).astype(np.uint8)
            for _ in range(m)]


def test_set_bwt_tiny(rng):
    reads = [rng.integers(0, 4, size=rng.integers(3, 9), dtype=np.uint8)
             for _ in range(5)]
    bwt, primary = T.set_bwt(reads, method="doubling")
    want = brute_set_bwt(reads)
    assert len(bwt) == len(want)
    np.testing.assert_array_equal(
        np.bincount(bwt, minlength=5), np.bincount(want, minlength=5))
    assert bwt[primary] == 0
    jbwt, jprimary = J.set_bwt(reads, method="doubling")
    np.testing.assert_array_equal(bwt, jbwt)
    assert primary == jprimary


def test_set_bwt_native_matches_doubling(rng):
    reads = [rng.integers(0, 4, size=50, dtype=np.uint8) for _ in range(20)]
    b1, p1 = T.set_bwt(reads, method="native")
    b2, p2 = T.set_bwt(reads, method="doubling")
    np.testing.assert_array_equal(b1, b2)
    assert p1 == p2
    jb, jp = J.set_bwt(reads, method="native")
    np.testing.assert_array_equal(b1, jb)
    assert p1 == jp


def test_bwt_text_roundtrip(rng):
    reads = [rng.integers(0, 4, size=10, dtype=np.uint8)]
    bwt, _ = T.set_bwt(reads)
    txt = T.bwt_to_text(bwt)
    assert set(txt) <= set("$ACGT")
    assert txt.count("$") == 2  # one separator + the terminator row
    assert txt == J.bwt_to_text(J.set_bwt(reads)[0])
    np.testing.assert_array_equal(T.join_reads(reads), J.join_reads(reads))


def test_mse_bwt_matches_oracle(rng):
    for trial in range(5):
        reads = _ragged(rng, int(rng.integers(2, 8)), 3, 12)
        got, tags = T.mse_bwt(reads)
        np.testing.assert_array_equal(got, _mse_oracle(reads),
                                      err_msg=str(trial))
        assert sorted(tags[got == 0].tolist()) == list(range(len(reads)))
        jgot, jtags = J.mse_bwt(reads)
        np.testing.assert_array_equal(got, jgot)
        np.testing.assert_array_equal(tags, jtags)


def test_merge_mse_bwts_equals_whole(rng):
    for trial in range(5):
        A = _ragged(rng, int(rng.integers(1, 6)), 3, 10)
        B = _ragged(rng, int(rng.integers(1, 6)), 3, 10)
        b1, t1 = T.mse_bwt(A)
        b2, t2 = T.mse_bwt(B)
        merged, mtags = T.merge_mse_bwts(b1, t1, b2, t2)
        want, wtags = T.mse_bwt(A + B)
        np.testing.assert_array_equal(merged, want, err_msg=str(trial))
        np.testing.assert_array_equal(mtags, wtags, err_msg=str(trial))
        jm, jt = J.merge_mse_bwts(*J.mse_bwt(A), *J.mse_bwt(B))
        np.testing.assert_array_equal(merged, jm)
        np.testing.assert_array_equal(mtags, jt)


def test_mse_bwt_incremental_blocks(rng):
    reads = [rng.integers(0, 4, size=20).astype(np.uint8) for _ in range(23)]
    got = T.mse_bwt_incremental(reads, block_size=5)
    np.testing.assert_array_equal(got, T.mse_bwt(reads)[0])
    np.testing.assert_array_equal(got, J.mse_bwt_incremental(reads, 5))
    assert (got == 0).sum() == 23
    assert len(got) == 23 * 21


@pytest.mark.parametrize("method", ["native", "rank", "device", "paged",
                                    "merge"])
def test_mse_bwt_incremental_every_method(rng, method):
    """Every engine of the port, uniform reads over uneven blocks, against
    the JAX package's native engine and its own ``method``."""
    reads = rng.integers(0, 4, size=(37, 24), dtype=np.uint8)
    reads[3] = reads[30]
    kw = {"device": "cpu"} if method == "device" else {}
    got = T.mse_bwt_incremental(list(reads), 10, method=method, **kw)
    np.testing.assert_array_equal(
        got, J.mse_bwt_incremental(list(reads), 10, method="native"))
    if method != "device":    # the JAX device engine: one case below
        np.testing.assert_array_equal(
            got, J.mse_bwt_incremental(list(reads), 10, method=method))


def test_paged_bwte_insertion(rng):
    from nvbio_tpu.index.paged_text import PagedText as JPagedText
    from nvbio_tpu.index.paged_text import bwte_insert_block as j_insert
    from nvbio_tpu_torch.index.paged_text import PagedText, bwte_insert_block

    reads = _ragged(rng, 80, 3, 50)
    want, _tags = J.mse_bwt(reads)
    pt, jpt = PagedText(n_symbols=5, page=128), JPagedText(n_symbols=5,
                                                           page=128)
    ns = jns = 0
    for i in range(0, len(reads), 25):
        ns = bwte_insert_block(pt, reads[i:i + 25], ns)
        jns = j_insert(jpt, reads[i:i + 25], jns)
    got = pt.gather()
    np.testing.assert_array_equal(got, want)
    assert ns == jns == len(reads)
    assert [len(p) for p in pt.pages] == [len(p) for p in jpt.pages]
    np.testing.assert_array_equal(pt.counts, jpt.counts)
    assert len(pt.pages) > 3
    assert max(len(p) for p in pt.pages) <= 128
    probe_pos = np.asarray([0, 17, len(got) // 3, len(got)], np.int64)
    probe_sym = np.asarray([1, 0, 3, 2], np.int64)
    occ = pt.occ_many(probe_sym, probe_pos)
    np.testing.assert_array_equal(occ, jpt.occ_many(probe_sym, probe_pos))
    for s, p, o in zip(probe_sym, probe_pos, occ):
        assert o == int((got[:p] == s).sum())
    back = PagedText.from_array(got, n_symbols=5, page=128)
    np.testing.assert_array_equal(back.gather(), got)


def test_bwte_rank_merge_equals_whole(rng):
    for trial in range(3):
        m = int(rng.integers(6, 50))
        reads = _ragged(rng, m, 0, 40)
        if m > 2:
            reads[1] = reads[-1].copy()
        full, full_tags = T.mse_bwt(reads)
        inc = T.mse_bwt_incremental(reads, block_size=5, method="rank")
        np.testing.assert_array_equal(full, inc)
        acc, acc_t = np.zeros(0, np.uint8), np.zeros(0, np.int64)
        jacc, jacc_t = acc, acc_t
        ns = 0
        for i in range(0, len(reads), 5):
            acc, acc_t = T.bwte_merge_block_rank(acc, acc_t,
                                                 reads[i:i + 5], ns)
            jacc, jacc_t = J.bwte_merge_block_rank(jacc, jacc_t,
                                                   reads[i:i + 5], ns)
            ns += len(reads[i:i + 5])
        np.testing.assert_array_equal(acc_t, full_tags)
        np.testing.assert_array_equal(acc, jacc)
        np.testing.assert_array_equal(acc_t, jacc_t)


def test_mse_bwt_native_i32_matches_doubling(rng):
    reads = _ragged(rng, 35, 1, 60)
    a, at = T.mse_bwt(reads, method="native")
    b, bt = T.mse_bwt(reads, method="doubling")
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(at, bt)
    sa, text, starts = T._bcr_sa(reads, method="native")
    jsa, jtext, jstarts = J._bcr_sa(reads, method="native")
    for x, y in ((sa, jsa), (text, jtext), (starts, jstarts)):
        np.testing.assert_array_equal(x, y)


def _engine(reads, nb, capacity=None, **kw):
    from nvbio_tpu_torch.index.bwte_device import BwteDevice

    m = len(reads) // nb
    L = reads.shape[1]
    eng = BwteDevice(capacity=capacity or len(reads) * (L + 1),
                     n_strings=len(reads), device="cpu")
    for b in range(nb):
        eng.add_block(reads[b * m:(b + 1) * m], **kw)
    return eng.finalize()


def test_bwte_device_engine(rng):
    """Across blocks and capacity padding (capacity > total symbols)."""
    for m, L, nb in ((8, 12, 2), (16, 20, 3), (5, 7, 4)):
        reads = rng.integers(0, 4, size=(m * nb, L), dtype=np.uint8)
        bwt, tags = _engine(reads, nb, capacity=m * nb * (L + 1) + 100)
        want, wtags = J.mse_bwt(list(reads))
        np.testing.assert_array_equal(bwt, want, err_msg=f"m={m} L={L}")
        np.testing.assert_array_equal(tags, wtags, err_msg=f"m={m} L={L}")


def test_bwte_device_block_sa_paths_agree(rng):
    """Device-derived block order (packed upload, torch sort) against host
    SA-IS, the JAX whole-set BWT and the JAX ``BwteDevice``."""
    from nvbio_tpu.index.bwte_device import BwteDevice as JBwteDevice

    m, L, nb = 12, 18, 3
    reads = rng.integers(0, 4, size=(m * nb, L), dtype=np.uint8)
    bd, td = _engine(reads, nb, block_sa="device")
    bh, th = _engine(reads, nb, block_sa="host")
    want, wtags = J.mse_bwt(list(reads))
    for b, t in ((bd, td), (bh, th)):
        np.testing.assert_array_equal(b, want)
        np.testing.assert_array_equal(t, wtags)
    jeng = JBwteDevice(capacity=m * nb * (L + 1), n_strings=m * nb)
    for b in range(nb):
        jeng.add_block(reads[b * m:(b + 1) * m])
    jb, jt = jeng.finalize()
    np.testing.assert_array_equal(bd, jb)
    np.testing.assert_array_equal(td, jt)


def test_bwte_device_tie_paths(rng):
    """Identical reads (ties resolved by the owner key alone), duplicated
    reads among random ones (26-symbol ties resolved by doubling) and
    homopolymer reads (every suffix of a read tied with the others'). The
    JAX test forces its full-plane fallback for the homopolymers by
    patching ``device_sa._TIE_CAP``; the port's tie resolution has one
    path only (the compacted doubling of ``device_sa._resolve_ties``, its
    shapes dynamic), which every case here takes."""
    L = 40
    one = rng.integers(0, 4, size=L, dtype=np.uint8)
    cases = {
        "identical": np.tile(one, (24, 1)),
        "duplicated": np.concatenate([
            np.tile(one, (8, 1)),
            rng.integers(0, 4, size=(16, L), dtype=np.uint8)]),
        "homopolymer": np.zeros((24, L), np.uint8),
    }
    for name, reads in cases.items():
        for nb in (1, 3):
            bwt, tags = _engine(reads, nb)
            want, wtags = J.mse_bwt(list(reads))
            np.testing.assert_array_equal(bwt, want, err_msg=name)
            np.testing.assert_array_equal(tags, wtags, err_msg=name)


def test_bwte_device_takes_packed_blocks_and_checks_capacity(rng):
    from nvbio_tpu_torch import packed
    from nvbio_tpu_torch.index.bwte_device import BwteDevice

    reads = rng.integers(0, 4, size=(20, 33), dtype=np.uint8)
    eng = BwteDevice(capacity=20 * 34, n_strings=20, device="cpu")
    for b in range(2):
        blk = reads[b * 10:(b + 1) * 10]
        eng.add_block_packed(
            torch.from_numpy(packed.pack(blk, 2).view(np.int32)), 10, 33)
    eng.sync()
    bwt, tags = eng.finalize()
    want, wtags = J.mse_bwt(list(reads))
    np.testing.assert_array_equal(bwt, want)
    np.testing.assert_array_equal(tags, wtags)
    with pytest.raises(ValueError, match="exceeds capacity"):
        eng.add_block(reads[:1])
    with pytest.raises(ValueError, match="int32 capacity limit"):
        BwteDevice(capacity=2**31, n_strings=1, device="cpu")


def test_bwte_native_engine_matches_oracle(rng):
    for trial in range(4):
        m = int(rng.integers(2, 70))
        L = int(rng.integers(1, 45))
        reads = rng.integers(0, 4, size=(m, L), dtype=np.uint8)
        if m > 2:
            reads[1] = reads[-1]
        want, _tags = J.mse_bwt(reads)
        bs = int(rng.integers(1, m + 1))
        got = T.mse_bwt_incremental(reads, block_size=bs, method="native")
        np.testing.assert_array_equal(got, want, err_msg=str(trial))
    blk = rng.integers(0, 4, size=(9, 13), dtype=np.uint8)
    np.testing.assert_array_equal(native.bcr_block_bwt(blk),
                                  J.mse_bwt(blk)[0])
    from nvbio_tpu import native as jnative

    np.testing.assert_array_equal(native.bcr_block_bwt(blk),
                                  jnative.bcr_block_bwt(blk))
    acc = native.bcr_block_bwt(blk)
    more = rng.integers(0, 4, size=(5, 13), dtype=np.uint8)
    np.testing.assert_array_equal(
        native.bwte_merge(acc, 9, more, native.bcr_block_bwt(more)),
        J.mse_bwt(np.concatenate([blk, more]))[0])


def test_bwte_native_ragged_falls_back(rng):
    """method="native" on a ragged read set gives the rank path's result
    (the C++ engine is uniform-length only)."""
    reads = _ragged(rng, 21, 1, 30)
    want, _ = J.mse_bwt(reads)
    got = T.mse_bwt_incremental(reads, block_size=6, method="native")
    np.testing.assert_array_equal(got, want)


def test_bwte_native_zero_length_reads(monkeypatch):
    """Zero-length uniform reads take the rank path (sentinels only); a
    native engine that does not build raises instead of falling back."""
    got = T.mse_bwt_incremental(np.zeros((4, 0), np.uint8), 2,
                                method="native")
    np.testing.assert_array_equal(got, np.zeros(4, np.uint8))

    def missing():
        raise OSError("no g++")

    monkeypatch.setattr(native, "get_bwte", missing)
    assert not native.bwte_available()
    with pytest.raises(OSError, match="no g\\+\\+"):
        T.mse_bwt_incremental(np.zeros((4, 3), np.uint8), 2,
                              method="native")
