"""Port parity: nvbio_tpu_torch.packed against nvbio_tpu.packed (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvbio_tpu import packed as jpacked
from nvbio_tpu_torch import packed as tpacked

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)


def test_pack_unpack_identical(rng):
    for n in (1, 15, 16, 17, 1000):
        codes = rng.integers(0, 4, size=n, dtype=np.uint8)
        w = tpacked.pack(codes, 2)
        np.testing.assert_array_equal(w, jpacked.pack(codes, 2))
        np.testing.assert_array_equal(tpacked.unpack(w, n, 2), codes)


@pytest.mark.parametrize("win_len", [1, 37, 130])
def test_extract_window_matches_aligned(rng, win_len):
    n = 5003
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    words = jpacked.pack(codes, 2)
    # starts everywhere, including windows that run past the genome end and
    # past the end of the words (zeros there)
    starts = np.concatenate([rng.integers(0, n, size=200),
                             np.arange(n - 40, n)]).astype(np.int32)
    want = np.asarray(jpacked.extract_window_aligned(
        jnp.asarray(words), jnp.asarray(starts), win_len, 2))
    got = tpacked.extract_window(
        tpacked.words_to_tensor(words, "cpu"),
        torch.from_numpy(starts.astype(np.int64)), win_len, 2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits,hi", [(1, 2), (2, 4), (8, 7)])
def test_reverse_rows_matches_in_length(rng, bits, hi):
    B, L = 64, 100
    x = rng.integers(0, hi, size=(B, L)).astype(np.int32)
    lens = rng.integers(0, L + 1, size=B).astype(np.int32)
    lens[:3] = [0, 1, L]
    want = np.asarray(jpacked.reverse_rows(jnp.asarray(x), jnp.asarray(lens),
                                           bits))
    got = tpacked.reverse_rows(torch.from_numpy(x),
                               torch.from_numpy(lens)).numpy()
    # only j < len is defined (the JAX tail holds shifted-in junk)
    inside = np.arange(L)[None, :] < lens[:, None]
    np.testing.assert_array_equal(got[inside], want[inside])
    assert (got[~inside] == 0).all()
