"""The port's Threefry PRNG (``utils/threefry.py``) against ``jax.random``
on the CPU.

Keys, splits, the 32-bit random bits and the uniforms are integers or
exact functions of them: bit-equal.  The Gumbel noise ``-log(-log u)``
goes through two float32 logs, and XLA's log and torch's differ by one
ulp on about one element in seven; near ``-log u = 1`` the outer log
turns that into an absolute error of one ulp of 1 on a result close to
0.  So the Gumbel values are held to one float32 ulp of ``max(1, |g|)``.
Lengths cover a single element, odd lengths and padded pool buckets.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from active_learning_tpu_torch.pool import bucket_size
from active_learning_tpu_torch.utils import threefry

SEEDS = [0, 1, 12345, 987654321, 2 ** 31 - 1]
LENGTHS = [1, 7, 1001, bucket_size(1001), bucket_size(3000)]
TINY = np.finfo(np.float32).tiny


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_are_jax_bits(seed):
    key = jax.random.PRNGKey(seed)
    assert threefry.prng_key(seed) == tuple(np.asarray(key).tolist())
    for n in (1, 3, 64, 1000):
        np.testing.assert_array_equal(
            threefry.split(threefry.prng_key(seed), n),
            np.asarray(jax.random.split(key, n)))


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_and_gumbel_match_jax(seed, n):
    key = jax.random.PRNGKey(seed)
    pkey = threefry.prng_key(seed)
    bits = np.asarray(jax.random.bits(key, (n,), np.uint32))
    np.testing.assert_array_equal(threefry.random_bits(pkey, n).numpy(),
                                  bits.astype(np.int64))
    u = np.asarray(jax.random.uniform(key, (n,), minval=TINY, maxval=1.0))
    np.testing.assert_array_equal(
        threefry.uniform(pkey, n, TINY, 1.0).numpy(), u)
    np.testing.assert_array_equal(threefry.uniform(pkey, n).numpy(),
                                  np.asarray(jax.random.uniform(key, (n,))))
    g = np.asarray(jax.random.gumbel(key, (n,)))
    got = threefry.gumbel(pkey, n).numpy()
    ulp = np.spacing(np.maximum(np.float32(1), np.abs(g)))
    assert (np.abs(got - g) <= ulp).all(), np.abs(got - g).max()


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_categorical_over_masked_logits_matches_jax(seed):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0, 1, 700).astype(np.float32)
    w[rng.choice(700, 300, replace=False)] = 0.0
    with np.errstate(divide="ignore"):
        logits = np.log(w)
    key = jax.random.PRNGKey(seed)
    want = [int(jax.random.categorical(k, logits))
            for k in jax.random.split(key, 20)]
    import torch
    got = [threefry.categorical((int(k[0]), int(k[1])), torch.from_numpy(
        logits)) for k in threefry.split(threefry.prng_key(seed), 20)]
    assert got == want
