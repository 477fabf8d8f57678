"""Port parity: MAPQ V2 (end-to-end) and the float32 read thresholds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvbio_tpu.bowtie import mapq as jmapq
from nvbio_tpu.bowtie import pipeline as jpipe
from nvbio_tpu.bowtie.params import MapParams as JMapParams
from nvbio_tpu_torch.bowtie import mapq as tmapq
from nvbio_tpu_torch.bowtie import pipeline as tpipe
from nvbio_tpu_torch.bowtie.params import MapParams as TMapParams

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)


@pytest.mark.parametrize("max_score", [0, 7])
def test_mapq_v2_grid(max_score):
    # every (best, second, has_second) over the score range of reads of 20
    # to 150 bp, plus NEG_INF seconds
    smin = -np.ceil(0.6 + 0.6 * np.arange(20, 151, 13)).astype(np.int32)
    best, second, s_min = np.meshgrid(np.arange(-100, 8), np.arange(-100, 8),
                                      smin, indexing="ij")
    best = best.ravel().astype(np.int32)
    second = second.ravel().astype(np.int32)
    s_min = s_min.ravel().astype(np.int32)
    second[::17] = -(1 << 24)
    for has2 in (second >= s_min, np.zeros_like(best, bool),
                 np.ones_like(best, bool)):
        want = jmapq.mapq_v2_end_to_end(
            jnp.asarray(best), jnp.asarray(second), jnp.asarray(has2),
            jnp.asarray(s_min), max_score)
        got = tmapq.mapq_v2_end_to_end(
            torch.from_numpy(best), torch.from_numpy(second),
            torch.from_numpy(has2), torch.from_numpy(s_min), max_score)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(np.asarray(want))) > 15


@pytest.mark.parametrize("kw", [{}, {"score_min_log": True,
                                     "score_min_const": 20.0,
                                     "score_min_coeff": 8.0},
                                {"score_min_const": -0.3,
                                 "score_min_coeff": -0.45,
                                 "n_ceil_coeff": 0.07}])
def test_score_min_and_n_ceil(rng, kw):
    L = 300
    lens = np.arange(0, L + 1, dtype=np.int32)
    reads = rng.integers(0, 5, size=(len(lens), L)).astype(np.int32)
    reads[rng.random(reads.shape) < 0.1] = 4
    jp, tp = JMapParams(**kw), TMapParams(**kw)
    np.testing.assert_array_equal(
        tpipe.score_min_of(torch.from_numpy(lens), tp).numpy(),
        np.asarray(jpipe.score_min_of(jnp.asarray(lens), jp)))
    np.testing.assert_array_equal(
        tpipe.n_ceil_of(torch.from_numpy(reads), torch.from_numpy(lens),
                        tp).numpy(),
        np.asarray(jpipe.n_ceil_of(jnp.asarray(reads), jnp.asarray(lens),
                                   jp)))


@pytest.mark.parametrize("read_len", [30, 100, 150])
def test_mapq_v2_local_grid(read_len):
    """Every (best, second, has_second) over a local read's score range
    (0 to the perfect 2*len) and score-min 20 + 8 ln(len), plus NEG_INF
    seconds: the float32 thresholds must give the JAX function's MAPQs."""
    top = 2 * read_len
    smin = int(np.ceil(20.0 + 8.0 * np.log(read_len)))
    best, second = np.meshgrid(np.arange(0, top + 1), np.arange(0, top + 1),
                               indexing="ij")
    best = best.ravel().astype(np.int32)
    second = second.ravel().astype(np.int32)
    second[::19] = -(1 << 24)
    s_min = np.full_like(best, smin)
    max_score = np.full_like(best, top)
    for has2 in (second >= s_min, np.zeros_like(best, bool)):
        want = jmapq.mapq_v2_local(
            jnp.asarray(best), jnp.asarray(second), jnp.asarray(has2),
            jnp.asarray(s_min), jnp.asarray(max_score))
        got = tmapq.mapq_v2_local(
            torch.from_numpy(best), torch.from_numpy(second),
            torch.from_numpy(has2), torch.from_numpy(s_min),
            torch.from_numpy(max_score))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(np.asarray(want))) >= 7


@pytest.mark.parametrize("paired", [False, True])
def test_mapq_v3_grid(paired):
    """BowtieMapq3 against the JAX function over a grid of best, second,
    min and max scores, has_second both ways, is_paired absent or given."""
    best, second, s_min, s_max = np.meshgrid(
        np.arange(-90, 12, 3), np.arange(-95, 12, 4),
        np.array([-80, -40, -12, -1, 0, 5]), np.array([-3, 0, 6, 150]),
        indexing="ij")
    best, second, s_min, s_max = (x.ravel().astype(np.int32) for x in
                                  (best, second, s_min, s_max))
    second[::13] = -(1 << 24)
    rng = np.random.default_rng(3)
    is_paired = rng.random(len(best)) < 0.3 if paired else None
    for has2 in (np.zeros_like(best, bool), np.ones_like(best, bool),
                 second >= s_min):
        want = jmapq.mapq_v3(
            jnp.asarray(best), jnp.asarray(second), jnp.asarray(has2),
            jnp.asarray(s_min), jnp.asarray(s_max),
            None if is_paired is None else jnp.asarray(is_paired))
        got = tmapq.mapq_v3(
            torch.from_numpy(best), torch.from_numpy(second),
            torch.from_numpy(has2), torch.from_numpy(s_min),
            torch.from_numpy(s_max),
            None if is_paired is None else torch.from_numpy(is_paired))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(np.asarray(want))) > 20
