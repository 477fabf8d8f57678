"""The suffix sort and FM build of ``nvbio_tpu_torch.index.device_sa`` (run
here on the CPU device) against ``nvbio_tpu.index.device_sa``, against
SA-IS and against the port's host build, exactly: the SA, the BWT, every
FM table (rank and SSA rows included) and ``fmindex_from_bwt`` (the nvSSA
job) on short texts at the bootstrap's 26-symbol edge, random texts, an
all-A text, a period-2 text and a text with planted repeats (ties that
take several doubling rounds)."""

import importlib
import zlib

import numpy as np
import pytest
import torch

from nvbio_tpu.fmi.index import fmindex_from_bwt as j_fmindex_from_bwt
from nvbio_tpu.index import device_sa as jdsa
from nvbio_tpu_torch.fmi.index import build_fmindex, fmindex_from_bwt
from nvbio_tpu_torch.index import device_sa as tdsa
from nvbio_tpu_torch.index.sa import suffix_array

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

# ``nvbio_tpu_torch.fmi.rank`` is the function, as in ``nvbio_tpu.fmi``
trank = importlib.import_module("nvbio_tpu_torch.fmi.rank")

FIELDS = ("bwt_words", "occ", "count", "ssa_marks", "ssa_cum", "ssa_vals")


def _repeats(n=20000, seed=4):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n).astype(np.uint8)
    for _ in range(20):
        s, d = rng.integers(0, n - 600, 2)
        g[d:d + 600] = g[s:s + 600]
    return g


def _text(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name.startswith("random-"):
        return rng.integers(0, 4, int(name[7:])).astype(np.uint8)
    return {"all-A": np.zeros(300, np.uint8),
            "period-2": np.tile(np.array([1, 2], np.uint8), 250),
            "repeats": _repeats()}[name]


TEXTS = [f"random-{n}" for n in (1, 2, 25, 26, 27, 1000, 5000)] + \
    ["all-A", "period-2", "repeats"]


@pytest.mark.parametrize("name", TEXTS)
def test_suffix_array_device(name):
    t = _text(name)
    got = tdsa.suffix_array_device(t, "cpu")
    assert got.dtype == np.int64 and got[0] == len(t)
    np.testing.assert_array_equal(got, suffix_array(t, method="native"))
    np.testing.assert_array_equal(got, jdsa.suffix_array_device(t))
    np.testing.assert_array_equal(
        suffix_array(t, method="device", device="cpu"), got)


def _u32(t: torch.Tensor) -> np.ndarray:
    a = t.numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


@pytest.mark.parametrize("name", TEXTS)
def test_build_fmindex_device(name):
    t = _text(name)
    stats = {}
    got = tdsa.build_fmindex_device(t, sa_interval=4, device="cpu",
                                    stats=stats)
    host = build_fmindex(t, sa_interval=4)
    jax_idx = jdsa.build_fmindex_device(t, sa_interval=4)
    assert got.device == torch.device("cpu")
    assert (got.primary, got.n, got.sa_interval) == \
        (host.primary, host.n, 4) == (jax_idx.primary, jax_idx.n, 4)
    for f in FIELDS + ("rank_rows", "ssa_rows"):
        a, b = getattr(got, f), getattr(host, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    for f in FIELDS:
        want = np.asarray(getattr(jax_idx, f))
        a = _u32(getattr(got, f)) if want.dtype == np.uint32 else \
            getattr(got, f).numpy()
        np.testing.assert_array_equal(a, want, err_msg=f)
    assert set(stats) >= {"upload_s", "bootstrap_s", "tie_s", "planes_s",
                          "rows_s", "tied_rows", "rounds"}
    if name in ("all-A", "period-2", "repeats"):
        assert stats["tied_rows"] > 0 and stats["rounds"] >= 2
    via_method = build_fmindex(t, sa_interval=4, method="device",
                               device="cpu")
    assert torch.equal(via_method.rank_rows, got.rank_rows)


@pytest.mark.parametrize("name", TEXTS)
def test_bwt_device(name):
    t = _text(name)
    bwt, primary = tdsa.bwt_device(t, "cpu")
    jbwt, jprimary = jdsa.bwt_device(t)
    assert primary == jprimary and bwt.dtype == np.uint8
    np.testing.assert_array_equal(bwt, jbwt)


@pytest.mark.parametrize("name", ["random-27", "random-5000", "period-2",
                                  "repeats"])
def test_fmindex_from_bwt(name):
    t = _text(name)
    jbwt, primary = jdsa.bwt_device(t)
    got = fmindex_from_bwt(jbwt, primary, sa_interval=8, device="cpu")
    want = j_fmindex_from_bwt(jbwt, primary, sa_interval=8)
    assert got.primary == want.primary and got.n == want.n
    for f in FIELDS:
        w = np.asarray(getattr(want, f))
        a = _u32(getattr(got, f)) if w.dtype == np.uint32 else \
            getattr(got, f).numpy()
        np.testing.assert_array_equal(a, w, err_msg=f)
    host = build_fmindex(t, sa_interval=8)
    assert torch.equal(got.rank_rows, host.rank_rows)


def test_rank_and_ssa_rows_tensor_equal_the_numpy_builders():
    t = _text("random-5000")
    idx = build_fmindex(t, sa_interval=8)
    words = idx.bwt_words.numpy().view(np.uint32)
    rows = trank.rank_rows_tensor(idx.bwt_words, idx.n, idx.occ)
    np.testing.assert_array_equal(
        rows.numpy(), trank.build_rank_rows(words, idx.n, idx.occ.numpy()))
    np.testing.assert_array_equal(
        trank.ssa_rows_tensor(idx.ssa_marks, idx.ssa_cum).numpy(),
        trank.build_ssa_rows(idx.ssa_marks.numpy().view(np.uint32),
                             idx.ssa_cum.numpy()))


def test_prefer_device_sa():
    assert tdsa.prefer_device_sa(1 << 22, "cuda")
    assert not tdsa.prefer_device_sa((1 << 22) - 1, "cuda")
    assert not tdsa.prefer_device_sa(1 << 30, "cpu")
    assert not tdsa.prefer_device_sa(1 << 30, torch.device("cpu"))
