"""The five boundary smoothers of the PyTorch port against the JAX package,
on the CPU, and the native contour engine against its numpy twins.

The same seeded RGBA images go through smooth_region_boundaries of both
packages at strengths 0.25, 0.5, 0.75 and 1.0, with and without
preserve_colors. Tolerances:
- morphological, contour, multiscale: equal bytes;
- gaussian: at most 1 per channel, and at least 99 % of the pixels
  equal (`exp` rounds differently in XLA and in numpy, where the port
  makes its Gaussian taps);
- bilateral: at most 1 per channel before the palette snap, at least
  99 % of the pixels equal after it (the snap can move a pixel that
  differs by one step to another palette colour).
The native contours and polygon simplification equal their `*_plain`
twins (the JAX module's Python bodies) bit for bit; the native fill equals
its twin except on outline samples that lie half-way between two pixels,
which the C++ engine rounds away from zero and numpy to even.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from image_segmenter_tpu.compat import _smoothing as JS
from image_segmenter_tpu.compat import region_cleanup as JR
from image_segmenter_tpu_torch.compat import _smoothing as TS
from image_segmenter_tpu_torch.compat import region_cleanup as TR
from image_segmenter_tpu_torch.ops import contours as TCONT

torch.set_num_threads(2)

STRENGTHS = [0.25, 0.5, 0.75, 1.0]
MIN_EQUAL_SHARE = 0.99


def smooth_image(h=96, w=128, seed=0, n_colors=6):
    """Blocky regions with ragged edges and speckles, a transparent hole."""
    rng = np.random.default_rng(seed)
    pal = rng.integers(0, 256, (n_colors, 3)).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    field = np.sin(xx / 11 + rng.random()) + np.cos(yy / 9) \
        + 0.4 * rng.normal(size=(h, w))
    idx = np.digitize(field, np.linspace(-2, 2, n_colors - 1))
    img = np.zeros((h, w, 4), np.uint8)
    img[..., :3] = pal[idx]
    img[..., 3] = 255
    img[h // 3:h // 2, w // 5:w // 3, 3] = 0
    return img


@pytest.fixture(scope="module")
def image():
    return smooth_image()


def _diff(a, b):
    return np.abs(a.astype(np.int32) - b.astype(np.int32))


@pytest.mark.parametrize("preserve", [True, False])
@pytest.mark.parametrize("strength", STRENGTHS)
@pytest.mark.parametrize("method", ["morphological", "contour", "multiscale"])
def test_exact_smoothers_equal_jax(image, method, strength, preserve):
    want = JR.smooth_region_boundaries(image, method, strength, preserve)
    got = TR.smooth_region_boundaries(image, method, strength, preserve,
                                      device="cpu")
    assert got.dtype == np.uint8 and got.shape == image.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("preserve", [True, False])
@pytest.mark.parametrize("strength", STRENGTHS)
def test_gaussian_within_one_step(image, strength, preserve):
    want = JR.smooth_region_boundaries(image, "gaussian", strength, preserve)
    got = TR.smooth_region_boundaries(image, "gaussian", strength, preserve,
                                      device="cpu")
    d = _diff(got, want)
    assert d.max() <= 1
    assert (d.max(-1) == 0).mean() >= MIN_EQUAL_SHARE
    np.testing.assert_array_equal(got[..., 3], want[..., 3])


@pytest.mark.parametrize("strength", STRENGTHS)
def test_bilateral_within_one_step(image, strength):
    d = max(1, int(strength * 9) + 1)
    sc = max(1, int(strength * 75) + 1)
    want = np.asarray(JS._bilateral_core(jnp.asarray(image[..., :3]),
                                         jnp.float32(sc), jnp.float32(sc), d))
    got = TS._bilateral_core(torch.as_tensor(image[..., :3]), sc, sc,
                             d).numpy()
    assert _diff(got, want).max() <= 1
    for preserve in (True, False):
        a = JR.smooth_region_boundaries(image, "bilateral", strength, preserve)
        b = TR.smooth_region_boundaries(image, "bilateral", strength,
                                        preserve, device="cpu")
        assert (_diff(a, b).max(-1) == 0).mean() >= MIN_EQUAL_SHARE
        if not preserve:
            assert _diff(a, b).max() <= 1


def test_palette_snap_equal_jax(image):
    """From the same filtered image the snap gives the JAX bytes."""
    filt = np.asarray(JS._bilateral_core(jnp.asarray(image[..., :3]),
                                         jnp.float32(38), jnp.float32(38), 5))
    x = jnp.asarray(image)
    vals, _, n = JS._color_table(x)
    want = np.asarray(JS._palette_snap(jnp.asarray(filt), x, vals, n))
    tx = torch.as_tensor(image)
    tvals, tn = TS.color_table(tx)
    got = TS._palette_snap(torch.as_tensor(filt.copy()), tx, tvals, tn).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", ["morphological", "gaussian", "bilateral",
                                    "multiscale", "contour"])
def test_all_transparent_returns_copy(method):
    img = smooth_image(20, 24, 3)
    img[..., 3] = 0
    out = TR.smooth_region_boundaries(img, method, 0.5, device="cpu")
    np.testing.assert_array_equal(out, img)
    assert out is not img


@pytest.mark.parametrize("chunk", [1, 3])
def test_colour_batches_give_the_sequential_bytes(image, monkeypatch, chunk):
    """Any chunk of colours per batch gives the bytes of one colour at a
    time: the last colour whose mask covers a pixel wins either way."""
    want = {m: TR.smooth_region_boundaries(image, m, 0.75, device="cpu")
            for m in ("morphological", "multiscale")}
    monkeypatch.setattr(TS, "CHUNK", chunk)
    for m, w in want.items():
        np.testing.assert_array_equal(
            TR.smooth_region_boundaries(image, m, 0.75, device="cpu"), w)


def test_many_colours_over_chunks_equal_jax():
    img = smooth_image(48, 64, seed=4, n_colors=21)
    for m in ("morphological", "multiscale"):
        np.testing.assert_array_equal(
            TR.smooth_region_boundaries(img, m, 1.0, device="cpu"),
            JR.smooth_region_boundaries(img, m, 1.0))


# ---------------------------------------------------------------------------
# native contours against their numpy twins
# ---------------------------------------------------------------------------

def _masks():
    rng = np.random.default_rng(9)
    img = smooth_image(60, 80, seed=2)
    rgb, nt = img[..., :3], img[..., 3] > 0
    out = [np.all(rgb == c, axis=2) & nt
           for c in np.unique(rgb[nt].reshape(-1, 3), axis=0)]
    out.append(rng.random((40, 50)) > 0.6)
    single = np.zeros((9, 9), bool)
    single[4, 4] = True
    out.append(single)
    return out


def _half_step_pixels(pts, shape):
    """Pixels of the outline samples that fall half-way between two pixels.

    Both fills draw each edge as max(|dx|, |dy|) + 1 samples and round
    them: the engine with lround (halves away from zero), the numpy twin
    with np.round (halves to even). The JAX package's two fills therefore
    differ on such samples alone; everywhere else they must agree.
    """
    out = np.zeros(shape, bool)
    q = np.roll(pts, -1, axis=0)
    for (ax, ay), (bx, by) in zip(pts.astype(int), q.astype(int)):
        n = max(abs(bx - ax), abs(by - ay)) + 1
        xs, ys = np.linspace(ax, bx, n), np.linspace(ay, by, n)
        half = (np.abs(xs % 1 - 0.5) < 1e-9) | (np.abs(ys % 1 - 0.5) < 1e-9)
        for x, y in zip(xs[half], ys[half]):
            for px in {int(np.floor(x)), int(np.ceil(x))}:
                for py in {int(np.floor(y)), int(np.ceil(y))}:
                    if 0 <= py < shape[0] and 0 <= px < shape[1]:
                        out[py, px] = True
    return out


def test_native_contours_equal_plain():
    for m in _masks():
        nat = TCONT.external_contours(m)
        plain = TCONT.external_contours_plain(m)
        assert len(nat) == len(plain)
        for a, b in zip(nat, plain):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("eps", [0.0, 0.7, 2.5, 10.0])
def test_native_approx_and_fill_equal_plain(eps):
    for m in _masks():
        for cont in TCONT.external_contours(m):
            a = TCONT.approx_poly_dp(cont, eps, closed=True)
            b = TCONT.approx_poly_dp_plain(cont, eps, closed=True)
            np.testing.assert_array_equal(a, b)
            f_nat = np.zeros(m.shape, np.uint8)
            f_plain = np.zeros(m.shape, np.uint8)
            TCONT.fill_polygon(f_nat, a)
            TCONT.fill_polygon_plain(f_plain, b)
            differ = f_nat != f_plain
            assert not (differ & ~_half_step_pixels(a, m.shape)).any()
            f_bool = np.zeros(m.shape, bool)
            TCONT.fill_polygon(f_bool, a)
            np.testing.assert_array_equal(f_bool, f_nat > 0)
    open_pts = np.array([[0, 0], [3, 1], [6, 0], [9, 4], [12, 0]], np.int32)
    np.testing.assert_array_equal(
        TCONT.approx_poly_dp(open_pts, 1.5, closed=False),
        TCONT.approx_poly_dp_plain(open_pts, 1.5, closed=False))
    assert TCONT.arc_length(open_pts, closed=False) > 0
