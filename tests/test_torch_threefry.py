"""``nvbio_tpu_torch.threefry`` and ``nvbio_tpu_torch.sumtree`` against
``jax.random`` and ``nvbio_tpu.sumtree`` on the CPU, bit for bit: keys,
``fold_in`` chains, uniforms of every shape randomized selection draws
(``(2, B, draws)`` with odd B), and the SumTree's sample, sample_many and
add with zero-weight rows and targets on a CDF edge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvbio_tpu import sumtree as jsumtree
from nvbio_tpu_torch import sumtree, threefry

# the suite runs in 6 xdist workers on 8 cores: one intra-op thread a
# worker keeps torch's OpenMP pools from spinning against each other
torch.set_num_threads(1)

SEEDS = (0, 1, 0x5E1EC7, 2**32 - 1, 2**40 + 7)


def _key(k) -> tuple[int, int]:
    return tuple(int(x) for x in np.asarray(k))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in(seed):
    jk = jax.random.PRNGKey(seed)
    tk = threefry.prng_key(seed)
    assert tk == _key(jk)
    for phase in range(4):
        jp, tp = jax.random.fold_in(jk, phase), threefry.fold_in(tk, phase)
        assert tp == _key(jp)
        for h in (0, 1, 2**31 + 5):
            assert threefry.fold_in(tp, h) == _key(jax.random.fold_in(jp, h))


@pytest.mark.parametrize("shape", [(1,), (7,), (2, 37, 24), (2, 8, 24),
                                   (3, 5, 4, 2), (2, 1, 1)])
@pytest.mark.parametrize("phase", range(4))
def test_uniform_bits(shape, phase):
    jk = jax.random.fold_in(jax.random.PRNGKey(0x5E1EC7), phase)
    tk = threefry.fold_in(threefry.prng_key(0x5E1EC7), phase)
    want = np.asarray(jax.random.uniform(jk, shape))
    got = threefry.uniform(tk, shape, "cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert ((got >= 0) & (got < 1)).all()


def _weights(rng, B, S):
    w = rng.random((B, S)).astype(np.float32)
    w *= rng.random((B, S)) < 0.6
    w[:3] = 0                      # zero-weight rows
    w[3] = [1.0] + [0.0] * (S - 1)
    w[4] = 0.25                    # equal weights: CDF edges at k/S
    return w


def test_sample_and_sample_many():
    rng = np.random.default_rng(7)
    for t in range(20):
        B, S = 31 + t, 1 + t % 7
        w = _weights(rng, B, S)
        u = rng.random(B).astype(np.float32)
        u[4] = 0.5                 # exactly on a CDF edge of row 4
        u[5] = 0.0
        got = sumtree.sample(torch.from_numpy(w), torch.from_numpy(u))
        want = np.asarray(jsumtree.sample(jnp.asarray(w), jnp.asarray(u)))
        np.testing.assert_array_equal(got.numpy(), want)
        key = jax.random.PRNGKey(t)
        got = sumtree.sample_many(torch.from_numpy(w), _key(key), 9)
        want = np.asarray(jsumtree.sample_many(jnp.asarray(w), key, 9))
        np.testing.assert_array_equal(got.numpy(), want)
    # a zero-weight row draws the last index, as the JAX function does
    assert int(sumtree.sample(torch.zeros(1, 5), torch.zeros(1))[0]) == 4


def test_cdf_is_the_jax_cumsum():
    rng = np.random.default_rng(3)
    w = (rng.random((2000, 7)) * 10.0 ** rng.integers(-6, 6, (2000, 7))
         ).astype(np.float32)
    got = sumtree._cdf(torch.from_numpy(w)).numpy()
    want = np.asarray(jnp.cumsum(jnp.asarray(w), axis=1))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_add():
    rng = np.random.default_rng(11)
    w = rng.random((17, 6)).astype(np.float32)
    idx = rng.integers(0, 6, 17)
    got = sumtree.add(torch.from_numpy(w), torch.from_numpy(idx), -0.5)
    want = np.asarray(jsumtree.add(jnp.asarray(w), jnp.asarray(idx), -0.5))
    np.testing.assert_array_equal(got.numpy(), want)
