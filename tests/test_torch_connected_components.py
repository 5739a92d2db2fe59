"""Connected components, Canny, grey morphology and the blurs of the
PyTorch port against the JAX package, on the CPU.

The same seeded inputs go through image_segmenter_tpu.ops and the port's
ops. Everything here is integer work or float work in the same order, so
every comparison is for equal bits: labels, sizes and bboxes (also against
the port's native union-find), Canny (also against cv2.Canny), the grey
morphology, the Gaussian blur, the box filter and the binary shift
reduction at even sizes.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from image_segmenter_tpu.ops import connected_components as JCC
from image_segmenter_tpu.ops import edges as JE
from image_segmenter_tpu.ops import morphology as JM
from image_segmenter_tpu_torch.ops import connected_components as TCC
from image_segmenter_tpu_torch.ops import edges as TE
from image_segmenter_tpu_torch.ops import morphology as TM
from image_segmenter_tpu_torch.ops import native as TN

torch.set_num_threads(2)


def _spiral(n):
    """A one-pixel-wide spiral corridor: the worst case for propagation."""
    g = np.zeros((n, n), np.int32)
    y, x, dy, dx = 0, 0, 0, 1
    seen = np.zeros((n, n), bool)
    for _ in range(n * n):
        g[y, x] = 1
        seen[y, x] = True
        ny, nx = y + 2 * dy, x + 2 * dx
        if not (0 <= ny < n and 0 <= nx < n) or seen[ny, nx]:
            dy, dx = dx, -dy
            ny, nx = y + 2 * dy, x + 2 * dx
            if not (0 <= ny < n and 0 <= nx < n) or seen[ny, nx]:
                break
        for _ in range(2):
            y, x = y + dy, x + dx
            g[y, x] = 1
            seen[y, x] = True
    return g


def _case(kind):
    rng = np.random.default_rng(KINDS.index(kind))
    if kind == "random":
        cid = rng.integers(0, 3, (37, 53)).astype(np.int32)
        valid = rng.random((37, 53)) > 0.15
    elif kind == "blobs":
        yy, xx = np.mgrid[0:120, 0:160]
        cid = ((yy // 17 + xx // 23) % 4).astype(np.int32)
        cid = np.where(rng.random(cid.shape) < 0.05, 7, cid).astype(np.int32)
        valid = np.ones(cid.shape, bool)
        valid[40:60, 30:90] = False
    elif kind == "spiral":
        cid = _spiral(41)
        valid = np.ones(cid.shape, bool)
    elif kind == "row":
        cid = rng.integers(0, 2, (1, 60)).astype(np.int32)
        valid = rng.random((1, 60)) > 0.1
    elif kind == "column":
        cid = rng.integers(0, 2, (60, 1)).astype(np.int32)
        valid = rng.random((60, 1)) > 0.1
    else:
        raise ValueError(kind)
    return cid, valid


KINDS = ["random", "blobs", "spiral", "row", "column"]


@pytest.mark.parametrize("conn", [4, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_component_stats_equal_jax_and_native(kind, conn):
    cid, valid = _case(kind)
    want = [np.asarray(a) for a in JCC.component_stats(
        jnp.asarray(cid), jnp.asarray(valid), conn)]
    got = [a.numpy() for a in TCC.component_stats(
        torch.as_tensor(cid), torch.as_tensor(valid), conn)]
    for name, a, b in zip(("labels", "sizes", "bbox"), want, got):
        assert a.dtype == b.dtype == np.int32, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    host = TN.label_components_host(cid, valid, conn)
    for name, a, b in zip(("labels", "sizes", "bbox"), host, got):
        np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("kind", ["spiral", "blobs"])
def test_chunked_fixpoint_equals_a_read_every_sweep(monkeypatch, kind):
    """Reading the fixpoint flag once every SWEEPS_PER_READ sweeps gives
    the labels of reading it after every sweep, in fewer reads."""
    cid, valid = _case(kind)
    args = (torch.as_tensor(cid), torch.as_tensor(valid), 8)
    out = {}
    for n in (1, TCC.SWEEPS_PER_READ):
        monkeypatch.setattr(TCC, "SWEEPS_PER_READ", n)
        monkeypatch.setattr(TCC, "HOST_READS", 0)
        out[n] = (TCC.label_components(*args), TCC.HOST_READS)
    every, chunked = out[1], out[TCC.SWEEPS_PER_READ]
    assert torch.equal(every[0], chunked[0])
    assert chunked[1] == -(-every[1] // TCC.SWEEPS_PER_READ) < every[1]


def test_label_components_transparent_and_empty():
    cid = np.zeros((5, 7), np.int32)
    valid = np.zeros((5, 7), bool)
    got = TCC.label_components(torch.as_tensor(cid), torch.as_tensor(valid))
    assert (got.numpy() == -1).all()
    valid[2, 3] = True
    got = TCC.label_components(torch.as_tensor(cid), torch.as_tensor(valid))
    assert got[2, 3] == 2 * 7 + 3 and (got >= 0).sum() == 1


@pytest.mark.parametrize("seed", [(10, 20), (0, 0), (5, 52)])
def test_flood_fill_component_equal_jax(seed):
    rng = np.random.default_rng(3)
    rgba = np.zeros((37, 53, 4), np.uint8)
    pal = np.array([[10, 20, 30], [200, 100, 0], [5, 5, 5]], np.uint8)
    rgba[..., :3] = pal[rng.integers(0, 3, (37, 53))]
    rgba[..., 3] = np.where(rng.random((37, 53)) > 0.2, 255, 0)
    want = np.asarray(JCC.flood_fill_component(
        jnp.asarray(rgba), jnp.asarray(seed, jnp.int32),
        jnp.asarray([1, 2, 3], jnp.uint8)))
    got = TCC.flood_fill_component(torch.as_tensor(rgba), seed,
                                   np.array([1, 2, 3], np.uint8))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# Canny
# ---------------------------------------------------------------------------

def _gray(kind):
    rng = np.random.default_rng(11)
    if kind == "noise":
        return rng.integers(0, 256, (50, 70)).astype(np.uint8)
    yy, xx = np.mgrid[0:64, 0:96].astype(np.float64)
    g = 128 + 60 * np.sin(xx / 9) * np.cos(yy / 7) + rng.normal(0, 4, yy.shape)
    g[20:40, 30:60] = 30
    return np.clip(g, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("l2", [False, True])
@pytest.mark.parametrize("thr", [(5, 15), (60, 20), (100, 200)])
@pytest.mark.parametrize("kind", ["noise", "smooth"])
def test_canny_equal_jax(kind, thr, l2):
    g = _gray(kind)
    want = np.asarray(JE.canny(g, *thr, l2gradient=l2))
    got = TE.canny(g, *thr, l2gradient=l2, device="cpu")
    assert got.dtype == np.uint8 and got.shape == g.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["noise", "smooth"])
def test_canny_equal_cv2(kind):
    cv2 = pytest.importorskip("cv2")
    g = _gray(kind)
    for thr in [(5, 15), (50, 150)]:
        np.testing.assert_array_equal(TE.canny(g, *thr, device="cpu"),
                                      cv2.Canny(g, *thr))


def test_canny_flat_image_has_no_edges():
    g = np.full((30, 40), 77, np.uint8)
    assert not TE.canny(g, 5, 15, device="cpu").any()


# ---------------------------------------------------------------------------
# morphology and blurs
# ---------------------------------------------------------------------------

SHAPES = [TM.ELLIPSE, TM.RECT, TM.CROSS]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k", [2, 3, 4, 5, 6])
def test_grey_morphology_equal_jax(k, shape):
    rng = np.random.default_rng(k)
    x = (rng.random((30, 41)) * 255).astype(np.float32)
    se = TM.structuring_element(shape, (k, k))
    np.testing.assert_array_equal(se, JM.structuring_element(shape, (k, k)))
    for fn in ("dilate_gray", "erode_gray", "morphological_gradient"):
        want = np.asarray(getattr(JM, fn)(jnp.asarray(x), se))
        got = getattr(TM, fn)(torch.as_tensor(x), se).numpy()
        np.testing.assert_array_equal(got, want, err_msg=fn)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k", [(2, 2), (4, 4), (6, 6), (3, 5), (4, 7), (9, 9)])
def test_binary_shift_reduce_even_sizes_equal_jax(k, shape):
    """The port's batched _shift_reduce at even and asymmetric sizes
    against the JAX package (its shifts up to 26 taps, its convolution
    above)."""
    rng = np.random.default_rng(sum(k))
    m = rng.random((3, 29, 37)) > 0.45
    se = TM.structuring_element(shape, k)
    for fn in ("dilate_binary", "erode_binary", "open_binary", "close_binary"):
        got = getattr(TM, fn)(torch.as_tensor(m), se).numpy()
        for i in range(m.shape[0]):
            want = np.asarray(getattr(JM, fn)(jnp.asarray(m[i]), se))
            np.testing.assert_array_equal(got[i], want, err_msg=(fn, i))


@pytest.mark.parametrize("k", [(3, 3), (4, 4), (5, 2)])
def test_conv2d_same_equal_jax(k):
    rng = np.random.default_rng(7)
    x = (rng.random((20, 27)) > 0.5).astype(np.float32)
    kern = TM.structuring_element(TM.ELLIPSE, k).astype(np.float32)
    for pad in (0.0, 1.0):
        want = np.asarray(JM._conv2d_same(jnp.asarray(x), kern, pad))
        got = TM._conv2d_same(torch.as_tensor(x), kern, pad).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ks,sigma", [(3, 0.5), (5, 1.0), (7, 0.0), (9, 2.5)])
def test_gaussian_blur_equal_jax(ks, sigma):
    rng = np.random.default_rng(ks)
    x = (rng.random((23, 31, 3)) * 255).astype(np.float32)
    np.testing.assert_array_equal(TM.gaussian_kernel_1d(ks, sigma),
                                  JM.gaussian_kernel_1d(ks, sigma))
    want = np.asarray(JM.gaussian_blur(jnp.asarray(x), ks, sigma))
    got = TM.gaussian_blur(torch.as_tensor(x), ks, sigma).numpy()
    np.testing.assert_array_equal(got, want)
    want2 = np.asarray(JM.gaussian_blur(jnp.asarray(x[..., 0]), ks, sigma))
    np.testing.assert_array_equal(
        TM.gaussian_blur(torch.as_tensor(x[..., 0]), ks, sigma).numpy(), want2)


@pytest.mark.parametrize("r", [1, 2, 7])
def test_box_filter_equal_jax(r):
    rng = np.random.default_rng(r)
    x = rng.random((33, 45, 2)).astype(np.float32)
    want = np.asarray(JM.box_filter(jnp.asarray(x), r))
    got = TM.box_filter(torch.as_tensor(x), r).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        TM.box_filter(torch.as_tensor(x[..., 0]), r).numpy(),
        np.asarray(JM.box_filter(jnp.asarray(x[..., 0]), r)))


@pytest.mark.parametrize("d", [(0, 0), (1, -2), (-3, 4), (40, 0)])
def test_shift2d(d):
    x = torch.arange(35).reshape(5, 7)
    got = TM.shift2d(x, *d, -1).numpy()
    want = np.full((5, 7), -1)
    for y in range(5):
        for xx in range(7):
            sy, sx = y + d[0], xx + d[1]
            if 0 <= sy < 5 and 0 <= sx < 7:
                want[y, xx] = sy * 7 + sx
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the native library
# ---------------------------------------------------------------------------

def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A failed build raises: get_lib never returns None for a caller to
    fall back on."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(TN, "_lib", None)
    monkeypatch.setattr(TN, "_SRC", str(bad))
    monkeypatch.setattr(TN, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(TN, "_SO", str(tmp_path / "build" / "libgeometry.so"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        TN.get_lib()
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_native_builds_into_the_ports_directory():
    lib = TN.get_lib()
    assert lib is not None
    assert TN._SO.startswith(TN._PKG) and "image_segmenter_tpu_torch" in TN._SO
