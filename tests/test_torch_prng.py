"""utils/prng.py of the PyTorch port against jax.random, on the CPU.

Keys, split, fold_in, bits and uniform are integer work (and one exact
subtraction): equal bit for bit. gumbel takes two logarithms: within
2 ulp counted at the size of max(|g|, 1) (measured: 1 ulp; near g = 0 the
inner logarithm is near 1, so its last bit is an absolute error of that
size). categorical: the same indices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_segmenter_tpu_torch.utils import prng as P

SEEDS = [0, 42, 2**31 + 5, -3]
# odd sizes, a scalar, more than 2^16 elements, two axes
SHAPES = [(), (1,), (7,), (3, 5), (70001,), (4, 1025)]


def _key_tuple(jkey) -> tuple:
    return tuple(int(v) for v in np.asarray(jkey))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in(seed):
    jk, tk = jax.random.PRNGKey(seed), P.key(seed)
    assert _key_tuple(jk) == tk
    for num in (2, 5):
        assert [_key_tuple(k) for k in jax.random.split(jk, num)] \
            == P.split(tk, num)
    for data in (0, 7, 2**32 - 1):
        assert _key_tuple(jax.random.fold_in(jk, data)) == P.fold_in(tk, data)
    # a chain, as kmeans_fit walks it: fold_in, then split after split
    jc, tc = jax.random.fold_in(jk, 3), P.fold_in(tk, 3)
    for _ in range(4):
        jc, js = jax.random.split(jc)
        tc, ts = P.split(tc)
        assert (_key_tuple(jc), _key_tuple(js)) == (tc, ts)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS[:2])
def test_bits_and_uniform_equal(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), P.key(seed)
    jb = np.asarray(jax.random.bits(jk, shape)).astype(np.int64)
    np.testing.assert_array_equal(P.bits(tk, shape).numpy(), jb)
    ju = np.asarray(jax.random.uniform(jk, shape))
    tu = P.uniform(tk, shape).numpy()
    assert tu.dtype == np.float32
    np.testing.assert_array_equal(tu, ju)


@pytest.mark.parametrize("shape", SHAPES[2:])
def test_gumbel_within_2_ulp(shape):
    jk, tk = jax.random.PRNGKey(42), P.key(42)
    jg = np.asarray(jax.random.gumbel(jk, shape))
    tg = P.gumbel(tk, shape).numpy()
    ulp = np.spacing(np.maximum(np.abs(jg), 1.0).astype(np.float32))
    err = np.abs(jg.astype(np.float64) - tg) / ulp
    assert err.max() <= 2.0, err.max()


@pytest.mark.parametrize("shape", [None, (4,)])
def test_categorical_same_indices(shape):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=5000).astype(np.float32)
    logits[rng.random(5000) < 0.3] = -np.inf
    for seed in (3, 42):
        ji = np.asarray(jax.random.categorical(
            jax.random.PRNGKey(seed), jnp.asarray(logits), shape=shape))
        ti = P.categorical(P.key(seed), torch.from_numpy(logits),
                           shape=shape).numpy()
        np.testing.assert_array_equal(ti, ji)
        assert np.isfinite(logits[ti]).all()


def test_categorical_batched_equals_single():
    """A batch of keys draws what each key draws alone."""
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.normal(size=(3, 999)).astype(np.float32))
    keys = [P.fold_in(P.key(42), i) for i in range(3)]
    got = P.categorical_batched(keys, logits, 4)
    for i, k in enumerate(keys):
        np.testing.assert_array_equal(
            got[i].numpy(), P.categorical(k, logits[i], shape=(4,)).numpy())
