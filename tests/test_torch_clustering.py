"""Ward, DBSCAN and nearest-neighbour solvers of the PyTorch port against
the JAX package, on the CPU. Discrete outputs: equal (Ward as labels, which
number the clusters by least member index in both packages)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_segmenter_tpu.solvers import agglomerative as JAG
from image_segmenter_tpu.solvers import dbscan as JDB
from image_segmenter_tpu.solvers import knn as JNN
from image_segmenter_tpu_torch.solvers import agglomerative as TAG
from image_segmenter_tpu_torch.solvers import dbscan as TDB
from image_segmenter_tpu_torch.solvers import knn as TNN

torch.set_num_threads(2)
N = 512  # padded size shared by the cases (one JAX compile per k)


def _pad_pts(pts, n=N):
    out = np.zeros((n, 3), np.float32)
    out[: len(pts)] = pts
    return out


def _same_partition(a, b):
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


def _ward_points(kind, k):
    rng = np.random.default_rng(k)
    if kind == "separated":  # the JAX test's blobs, 300 points
        centers = rng.uniform(0, 100, (k, 3)) + np.arange(k)[:, None] * 60
        per = 300 // k
        pts = np.concatenate([c + rng.normal(0, 2.0, (per, 3))
                              for c in centers])
        return pts[rng.permutation(len(pts))].astype(np.float32)
    pts = rng.normal(0, 10, (300, 3))  # overlapping blobs
    pts[100:200] += 18.0
    pts[200:] += 36.0
    return pts.astype(np.float32)


@pytest.mark.parametrize("kind", ["separated", "overlapping"])
@pytest.mark.parametrize("k", [2, 4, 7])
def test_ward_labels_match_jax(kind, k):
    pts = _ward_points(kind, k)
    ref = np.asarray(JAG.ward_labels(jnp.asarray(_pad_pts(pts)),
                                     jnp.int32(len(pts)), k))
    got = TAG.ward_labels(torch.from_numpy(_pad_pts(pts)), len(pts), k).numpy()
    assert _same_partition(got[: len(pts)], ref[: len(pts)])
    np.testing.assert_array_equal(got, ref)  # and the same numbering
    assert len(np.unique(got[: len(pts)])) == k


def test_ward_duplicate_points():
    """Exact duplicates merge at height 0 in index order in both."""
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 100, (40, 3)).astype(np.float32)
    pts = np.concatenate([base, base[:20], base[:10]])
    ref = np.asarray(JAG.ward_labels(jnp.asarray(_pad_pts(pts)),
                                     jnp.int32(len(pts)), 4))
    got = TAG.ward_labels(torch.from_numpy(_pad_pts(pts)), len(pts), 4).numpy()
    np.testing.assert_array_equal(got, ref)


def _dbscan_case(seed):
    """Three dense blobs, sparse noise, and duplicated rows folded into
    multiplicities (the JAX test's scene)."""
    rng = np.random.default_rng(seed)
    blobs = [rng.normal(c, 0.3, (60, 3))
             for c in ([0, 0, 0], [5, 5, 5], [10, 0, 5])]
    noise = rng.uniform(-3, 13, (15, 3))
    pts = np.concatenate(blobs + [noise])
    full = np.concatenate([pts, pts[rng.integers(0, len(pts), 40)]])
    uniq, cnts = np.unique(full.round(9), axis=0, return_counts=True)
    return (_pad_pts(uniq.astype(np.float32)),
            np.pad(cnts.astype(np.float32), (0, N - len(uniq))),
            np.arange(N) < len(uniq))


def _both_dbscan(pts, cnt, valid, eps, ms):
    ref = np.asarray(JDB.dbscan_labels(
        jnp.asarray(pts), jnp.asarray(cnt), jnp.asarray(valid),
        jnp.float32(eps), jnp.float32(ms)))
    got = TDB.dbscan_labels(torch.from_numpy(pts), torch.from_numpy(cnt),
                            torch.from_numpy(valid), eps, ms).numpy()
    return got, ref


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("eps", [1.0, 0.45])
def test_dbscan_labels_match_jax(seed, eps):
    got, ref = _both_dbscan(*_dbscan_case(seed), eps, 3.0)
    np.testing.assert_array_equal(got, ref)
    assert (got == -2).sum() == (ref == -2).sum() > 0
    assert (got >= 0).any()


def test_dbscan_core_via_duplicates():
    """A point of multiplicity >= min_samples is a core point by itself."""
    pts = _pad_pts(np.array([[0, 0, 0], [10, 10, 10]], np.float32))
    cnt = np.pad(np.array([5.0, 1.0], np.float32), (0, N - 2))
    got, ref = _both_dbscan(pts, cnt, np.arange(N) < 2, 0.5, 3.0)
    np.testing.assert_array_equal(got, ref)
    assert got[0] == 0 and got[1] == -1


def test_dbscan_chain_needs_pointer_doubling():
    """A long chain of points one step apart: one component, labelled by
    its least index."""
    pts = np.zeros((N, 3), np.float32)
    pts[:200, 0] = np.arange(200) * 0.9
    cnt = np.pad(np.ones(200, np.float32), (0, N - 200))
    got, ref = _both_dbscan(pts, cnt, np.arange(N) < 200, 1.0, 2.0)
    np.testing.assert_array_equal(got, ref)
    assert (got[:200] == 0).all()


@pytest.mark.parametrize("nq", [1000, (1 << 14) + 5])
def test_nearest_index_matches_jax(nq):
    rng = np.random.default_rng(nq)
    q = rng.normal(0, 5, (nq, 3)).astype(np.float32)
    r = rng.normal(0, 5, (300, 3)).astype(np.float32)
    r[7] = r[3]  # an exact tie: the lowest index wins
    q[0] = r[3]
    valid = rng.random(300) > 0.3
    valid[[3, 7]] = True
    ref = np.asarray(JNN.nearest_index(jnp.asarray(q), jnp.asarray(r),
                                       jnp.asarray(valid)))
    got = TNN.nearest_index(torch.from_numpy(q), torch.from_numpy(r),
                            torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got[0] == 3 and valid[got].all()
