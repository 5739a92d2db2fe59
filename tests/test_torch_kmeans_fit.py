"""kmeans_fit of the PyTorch port (kmeans++ from jax.random's stream,
restarts, lock-step Lloyd) against the JAX package, on the CPU.

The seeding makes discrete choices from the same random numbers, so the
seeds must be the same points. After that the two packages add the Lloyd
sums in different orders (XLA's reduction against the port's fixed pairwise
order): centres within 1e-3 absolute on 0..255 data (measured 4.6e-5) and
inertia within 1e-4 relative (measured 9.4e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_segmenter_tpu.solvers import kmeans as JKM
from image_segmenter_tpu_torch.solvers import kmeans as TKM
from image_segmenter_tpu_torch.utils import prng as P

torch.set_num_threads(2)

N = 3000  # every case shares this size: JAX compiles once per (k, n_init)


def _clusters(seed=0):
    """Six separated colour clusters with integer weights, a tenth of the
    points weightless."""
    rng = np.random.default_rng(seed)
    cent = rng.uniform(0, 255, (6, 3))
    pts = (cent[rng.integers(0, 6, N)] + rng.normal(0, 8, (N, 3)))
    w = (rng.random(N) > 0.1) * rng.integers(1, 50, N)
    return pts.astype(np.float32), w.astype(np.float32)


def _photo_sample(seed=1):
    """Colours of a smooth photo-like gradient with noise, unit weights."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, N, dtype=np.float32)
    base = np.stack([127 + 100 * np.sin(9 * t) * np.cos(5 * t),
                     127 + 100 * np.cos(7 * t), 127 + 100 * np.sin(3 * t)], -1)
    pts = np.clip(base + rng.normal(0, 6, base.shape), 0, 255)
    return pts.astype(np.uint8).astype(np.float32), np.ones(N, np.float32)


DATA = {"clusters": _clusters, "photo": _photo_sample}


@pytest.mark.parametrize("data", ["clusters", "photo"])
@pytest.mark.parametrize("k", [4, 8])
def test_kmeanspp_init_picks_jax_seeds(data, k):
    """From the restart keys of seed 42, the same points become seeds."""
    pts, w = DATA[data]()
    jp, jw = JKM._pad_points(jnp.asarray(pts), jnp.asarray(w))
    tp, tw = TKM._pad_points(torch.from_numpy(pts)[None],
                             torch.from_numpy(w)[None])
    trials = 2 + int(np.log(k))
    tkeys = [P.fold_in(P.key(42), i) for i in range(3)]
    got = TKM._kmeanspp_init(tkeys, tp[0], tw[0], k, trials).numpy()
    for i in range(3):
        jk = jax.random.fold_in(jax.random.PRNGKey(42), i)
        ref = np.asarray(JKM._kmeanspp_init(jk, jp, jw, k, trials))
        np.testing.assert_array_equal(got[i], ref)


@pytest.mark.parametrize("n_init", [1, 3, 10])
@pytest.mark.parametrize("k", [4, 8])
def test_kmeans_fit_matches_jax(k, n_init):
    pts, w = _clusters()
    ref = JKM.kmeans_fit(jnp.asarray(pts), jnp.asarray(w), k, n_init=n_init)
    got = TKM.kmeans_fit(torch.from_numpy(pts), torch.from_numpy(w), k,
                         n_init=n_init)
    assert got.centers.shape == (k, 3) and got.inertia.shape == ()
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(ref.centers),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(float(got.inertia), float(ref.inertia),
                               rtol=1e-4)


@pytest.mark.parametrize("data", ["clusters", "photo"])
def test_batched_and_sequential_restarts_equal_bits(data):
    """The lock-step Lloyd and one restart after another: the same bits
    (the JAX package's promise, tests/test_kmeans.py)."""
    pts, w = DATA[data]()
    args = (torch.from_numpy(pts), torch.from_numpy(w), 8)
    a = TKM.kmeans_fit(*args, n_init=5, batch_restarts=True)
    b = TKM.kmeans_fit(*args, n_init=5, batch_restarts=False)
    auto = TKM.kmeans_fit(*args, n_init=5)  # n_init >= 4: the batched path
    assert torch.equal(a.centers, b.centers)
    assert torch.equal(a.inertia, b.inertia)
    assert torch.equal(a.centers, auto.centers)


def test_weighted_equals_repeated():
    """Integer weights against the same points repeated: the same fit up
    to the order of the sums."""
    rng = np.random.default_rng(5)
    cent = rng.uniform(0, 255, (4, 3))
    pts = (cent[rng.integers(0, 4, 600)] + rng.normal(0, 5, (600, 3))) \
        .astype(np.float32)
    w = rng.integers(1, 4, 600)
    rep = np.repeat(pts, w, axis=0)
    a = TKM.kmeans_fit(torch.from_numpy(pts),
                       torch.from_numpy(w.astype(np.float32)), 4, n_init=3)
    b = TKM.kmeans_fit(torch.from_numpy(rep), torch.ones(len(rep)), 4,
                       n_init=3)
    # different draws (another N), the same four clusters
    ca = a.centers.numpy()[np.lexsort(a.centers.numpy().T)]
    cb = b.centers.numpy()[np.lexsort(b.centers.numpy().T)]
    np.testing.assert_allclose(ca, cb, atol=1e-2)
    np.testing.assert_allclose(float(a.inertia), float(b.inertia), rtol=1e-4)


def test_d2_points_last_is_pairwise_d2():
    """The point-axis-last distance has `_pairwise_d2`'s bits."""
    rng = np.random.default_rng(2)
    p = torch.from_numpy(rng.uniform(0, 255, (500, 3)).astype(np.float32))
    c = torch.from_numpy(rng.uniform(0, 255, (2, 7, 3)).astype(np.float32))
    a = TKM._d2_points_last(p.t().contiguous(), c)             # (2, 7, 500)
    b = TKM._pairwise_d2(p[None], c.reshape(1, 14, 3))[0]      # (500, 14)
    assert torch.equal(a.reshape(14, 500).t(), b)


def test_empty_cluster_reseed_matches_jax():
    """Fewer distinct colours than k: empty clusters move onto the
    farthest points, as in JAX."""
    rng = np.random.default_rng(3)
    cols = np.array([[10, 10, 10], [200, 30, 30], [30, 200, 30]], np.float32)
    pts = cols[rng.integers(0, 3, N)]
    w = np.ones(N, np.float32)
    ref = JKM.kmeans_fit(jnp.asarray(pts), jnp.asarray(w), 4, n_init=3)
    got = TKM.kmeans_fit(torch.from_numpy(pts), torch.from_numpy(w), 4,
                         n_init=3)
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(ref.centers),
                               atol=1e-3)
