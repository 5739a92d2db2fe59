"""Parity of the PyTorch port's image ops with the JAX package, on the CPU.

Inputs are made from a seed with numpy and go through the JAX function
and its port counterpart. The port's ops take a leading batch axis; the
JAX ops take one image, so the JAX side runs per image.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from image_segmenter_tpu.ops import histogram as JHG
from image_segmenter_tpu.ops import morphology as JM
from image_segmenter_tpu.ops import resize as JRZ
from image_segmenter_tpu_torch.kernels import resample as RS
from image_segmenter_tpu_torch.ops import histogram as THG
from image_segmenter_tpu_torch.ops import morphology as TM
from image_segmenter_tpu_torch.ops import resize as TRZ
from image_segmenter_tpu_torch.ops.scan import cumsum, tree_sum
from image_segmenter_tpu_torch.utils.backend import true_div

# pytest runs several worker processes on the same cores: keep torch's
# CPU thread pool small so they do not oversubscribe them
torch.set_num_threads(2)

RESIZES = [
    (TRZ.AREA, (61, 97), (23, 37)),
    (TRZ.LINEAR, (23, 37), (61, 97)),
    (TRZ.LANCZOS_PIL, (61, 97), (32, 32)),
    (TRZ.LANCZOS_PIL, (32, 32), (61, 97)),
]


@pytest.mark.parametrize("method,src,dst", RESIZES)
def test_resize_f32_matches_jax(method, src, dst):
    """Float resize: both are two f32 contractions of the same weights,
    summed by different BLAS kernels -> rounding-level differences only
    (1e-4 absolute on a 0..255 scale)."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (2, *src, 3), dtype=np.uint8)
    got = TRZ.resize(torch.from_numpy(img), dst, method).numpy()
    for b in range(2):
        ref = np.asarray(JRZ.resize(jnp.asarray(img[b]), dst, method))
        np.testing.assert_allclose(got[b], ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("method,src,dst", RESIZES)
def test_resize_u8_matches_jax(method, src, dst):
    """u8 resize: floor(x + 0.5) of the float result. A rounding-level
    difference can move a value that sits on a .5 boundary by one step,
    so at most 0.1% of outputs may differ, and by at most 1."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (2, *src), dtype=np.uint8)
    got = TRZ.resize_u8(torch.from_numpy(img), dst, method).numpy()
    ref = np.stack([np.asarray(JRZ.resize_u8(jnp.asarray(i), dst, method))
                    for i in img])
    diff = np.abs(got.astype(int) - ref)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("method,src,dst", RESIZES)
def test_resize_rounds_once_from_float64(method, src, dst):
    """The contractions accumulate in float64 and round to float32 once,
    so the result does not depend on the BLAS library's summation order:
    equal to numpy's float64 product rounded to float32."""
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (2, *src, 3), dtype=np.uint8)
    got = TRZ.resize(torch.from_numpy(img), dst, method).numpy()
    wy = TRZ._weights(src[0], dst[0], method).astype(np.float64)
    wx = TRZ._weights(src[1], dst[1], method).astype(np.float64)
    ref = np.einsum("yh,bhwc,xw->byxc", wy, img.astype(np.float64), wx)
    np.testing.assert_array_equal(got, ref.astype(np.float32))


def test_weight_builders_copied_unchanged():
    """The port copies the JAX package's numpy weight builders: identical."""
    for method in (TRZ.AREA, TRZ.LINEAR, TRZ.LANCZOS_PIL, TRZ.BILINEAR_PIL,
                   TRZ.NEAREST_CV, TRZ.NEAREST_PIL):
        for src, dst in [(61, 23), (23, 61), (320, 2160)]:
            np.testing.assert_array_equal(TRZ._weights(src, dst, method),
                                          JRZ._weights(src, dst, method))
    assert TRZ.scale_to_max_dim(2160, 3840, 1024) == \
        JRZ.scale_to_max_dim(2160, 3840, 1024)


METHODS = (TRZ.AREA, TRZ.LINEAR, TRZ.LANCZOS_PIL, TRZ.BILINEAR_PIL,
           TRZ.NEAREST_CV, TRZ.NEAREST_PIL)
# (src, dst) of one axis: the 4K main path's (U2-Netp's 320, the matting's
# 576 x 1024, ISNet's 1024, SAM's 1024 long side), 1080p's, GrabCut's
# search shrink of 1024 x 768, odd and one-pixel sizes
BAND_PAIRS = [(2160, 320), (3840, 320), (320, 2160), (320, 3840),
              (2160, 576), (3840, 1024), (576, 2160), (1024, 3840),
              (2160, 1024), (1024, 2160), (1080, 320), (1920, 320),
              (320, 1080), (320, 1920), (1080, 576), (1920, 1024),
              (576, 1080), (1024, 1920), (1024, 256), (768, 192), (1, 1),
              (1, 7), (7, 1), (61, 23), (23, 61), (97, 1), (2, 3), (3, 2),
              (5, 5), (1000, 999)]


@pytest.mark.parametrize("src,dst", BAND_PAIRS)
@pytest.mark.parametrize("method", METHODS)
def test_band_reconstructs_the_weights(method, src, dst):
    """The kernel's band (kernels/resample.band) holds every nonzero of
    `_weights` and gives the matrix back exactly; its windows stay inside
    the source and never move left, and the band is no wider than the
    widest row's nonzeros."""
    w = TRZ._weights.__wrapped__(src, dst, method)  # uncached: large ones
    start, taps = RS.band(w)
    k = taps.shape[1]
    assert start.dtype == np.int32 and taps.dtype == np.float32
    assert taps.shape == (dst, k) and 1 <= k <= src
    assert (start >= 0).all() and (start + k <= src).all()
    assert (np.diff(start) >= 0).all()
    back = np.zeros_like(w)
    np.put_along_axis(back, start[:, None] + np.arange(k), taps, axis=1)
    np.testing.assert_array_equal(back, w)
    nz = [np.flatnonzero(r) for r in w]
    assert k == max([1] + [r[-1] - r[0] + 1 for r in nz if len(r)])


def _banded_u8(img: np.ndarray, dst_hw, method: str) -> np.ndarray:
    """csrc/resample.cu's arithmetic in numpy: float32 taps times u8
    values summed in float64 in ascending source index, rows (each
    product exact, so the kernel's fma rounds as this sum does) then
    columns (a product and a sum, each rounded), one rounding to float32,
    floor(x + 0.5) in float32, clamped to 0..255."""
    b, h, w = img.shape[:3]
    x = img.reshape(b, h, w, -1).astype(np.float64)
    ys, wy = TRZ._band(h, dst_hw[0], method)
    xs, wx = TRZ._band(w, dst_hw[1], method)
    rows = np.zeros((b, dst_hw[0], w, x.shape[3]))
    for k in range(wy.shape[1]):
        rows = rows + wy[None, :, k, None, None].astype(np.float64) \
            * x[:, ys + k]
    acc = np.zeros((b, dst_hw[0], dst_hw[1], x.shape[3]))
    for k in range(wx.shape[1]):
        acc = acc + wx[None, None, :, k, None].astype(np.float64) \
            * rows[:, :, xs + k]
    y = np.floor(acc.astype(np.float32) + np.float32(0.5))
    return np.clip(y, 0, 255).astype(np.uint8).reshape(
        b, *dst_hw, *img.shape[3:])


def _photo_pair():
    """(2, 256, 512, 3) u8: corpus photos two side by side."""
    from image_segmenter_tpu_torch.bench.corpus import load_corpus

    tiles = [rgb for _, rgb in load_corpus(256, 4)]
    return np.stack([np.concatenate(tiles[0:2], axis=1),
                     np.concatenate(tiles[2:4], axis=1)])


# (src, dst): a shrink by 4.2 and 5.3 (the CNN input's), one by 3.8 and
# 4.3 (the matting's), and an enlargement back
TWIN_CASES = [((256, 512), (61, 97)), ((256, 512), (68, 120)),
              ((61, 97), (256, 512))]


@pytest.mark.parametrize("src,dst", TWIN_CASES)
@pytest.mark.parametrize("kind", ["photo", "random"])
@pytest.mark.parametrize("method", METHODS)
def test_banded_sum_gives_the_dense_bytes(method, kind, src, dst):
    """The kernel's banded float64 sum, as `_banded_u8` writes it, gives
    `resize_u8`'s dense bytes on corpus photos and random u8, three
    channels and one."""
    rng = np.random.default_rng(11)
    if kind == "photo":
        img = _photo_pair()
        if img.shape[1:3] != src:
            img = TRZ.resize_u8(torch.from_numpy(img), src, method).numpy()
    else:
        img = rng.integers(0, 256, (2, *src, 3), dtype=np.uint8)
    for x in (img, np.ascontiguousarray(img[..., 1])):
        got = _banded_u8(x, dst, method)
        ref = TRZ.resize_u8(torch.from_numpy(x), dst, method).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("method", [TRZ.LANCZOS_PIL, TRZ.AREA, TRZ.LINEAR])
@pytest.mark.parametrize("w,dw,dh,c", [(3840, 320, 320, 3),
                                       (320, 3840, 2160, 1),
                                       (3840, 1024, 576, 3),
                                       (1024, 3840, 2160, 1),
                                       (3840, 1024, 1024, 3),
                                       (97, 1, 5, 3), (7, 61, 23, 1),
                                       (30000, 1, 3, 4)])
def test_resample_tile_fits_its_windows(method, w, dw, dh, c):
    """`tile`'s span is the most source columns any of its column tiles
    reads; the tile's float64 row sums (PAD bytes of alignment included)
    fit a block's shared memory, TILE_BYTES unless one column alone does
    not; at most MAX_ROWS rows, MAX_COLUMNS columns and, past a GROUP of
    rows, MAX_OUTPUTS."""
    start, taps = TRZ._band(w, dw, method)
    k = taps.shape[1]
    if (RS.span(start, k, 1) * c + RS.PAD) * 8 > RS.MAX_TILE_BYTES:
        with pytest.raises(ValueError):  # a column of 30,000 x 4 sums
            RS.tile(start, k, dh, c)
        return
    ty, tx, sp = RS.tile(start, k, dh, c)
    reads = [start[min(o + tx, dw) - 1] + k - start[o]
             for o in range(0, dw, tx)]
    assert sp == max(reads) <= w
    assert 1 <= ty <= min(dh, RS.MAX_ROWS) and 1 <= tx <= min(
        dw, RS.MAX_COLUMNS)
    limit = RS.TILE_BYTES if tx > 1 or ty > 1 else RS.MAX_TILE_BYTES
    assert ty * (sp * c + RS.PAD) * 8 <= limit
    assert ty <= RS.GROUP or ty * tx * c <= RS.MAX_OUTPUTS


def test_resample_constants_are_the_kernels():
    """GROUP is csrc/resample.cu's kRows, PAD covers the bytes its
    kVec-byte loads add at either end of a row of sums, and
    MAX_TILE_BYTES is the shared memory it allows a block."""
    import re
    from image_segmenter_tpu_torch.kernels import _build

    src = (_build.CSRC / "resample.cu").read_text()
    assert int(re.search(r"constexpr int kRows = (\d+);", src).group(1)) \
        == RS.GROUP
    vec = int(re.search(r"constexpr int kVec = (\d+);", src).group(1))
    assert RS.PAD == 2 * (vec - 1)
    assert int(re.search(r"constexpr size_t kMaxSmem = (\d+);", src)
               .group(1)) == RS.MAX_TILE_BYTES


@pytest.mark.parametrize("shape", [(3, 1000), (2, 37, 53), (1, 300000)])
def test_histogram_u8_exact(shape):
    """Exact integer counts: equal to np.bincount and to the JAX op."""
    rng = np.random.default_rng(2)
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    x[0, :50] = 255  # heavy bin
    got = THG.histogram_u8(torch.from_numpy(x)).numpy()
    for b in range(shape[0]):
        np.testing.assert_array_equal(
            got[b], np.bincount(x[b].ravel(), minlength=256))
        np.testing.assert_array_equal(
            got[b], np.asarray(JHG.histogram_u8(jnp.asarray(x[b]))))


@pytest.mark.parametrize("q", [0.2, 0.5, 0.8])
def test_u8_quantile_matches_jax(q):
    """Exact: integer histogram, fixed interpolation formula."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, (3, 41, 29), dtype=np.uint8)
    x[1] = np.clip(x[1], 100, 140)
    got = THG.u8_quantile(torch.from_numpy(x), q).numpy()
    for b in range(3):
        ref = float(JHG.u8_quantile(jnp.asarray(x[b]), q))
        assert got[b] == ref
        assert got[b] == np.percentile(x[b], q * 100)


def test_otsu_matches_jax():
    """Exact: the histogram prefix sums round in XLA's order (ops/scan)."""
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.normal(60, 15, (2, 2000)),
                        rng.normal(190, 20, (2, 3000))], axis=1)
    x = np.clip(x, 0, 255).astype(np.uint8).reshape(2, 50, 100)
    got_t = THG.otsu_threshold(torch.from_numpy(x)).numpy()
    got_b = THG.otsu_binarize(torch.from_numpy(x)).numpy()
    for b in range(2):
        assert got_t[b] == float(JHG.otsu_threshold(jnp.asarray(x[b])))
        np.testing.assert_array_equal(
            got_b[b], np.asarray(JHG.otsu_binarize(jnp.asarray(x[b]))))


@pytest.mark.parametrize("n", [7, 16, 37, 256, 16384, 100003])
def test_cumsum_rounds_like_xla(n):
    """Bit-identical to jnp.cumsum on the CPU (blocked scan order)."""
    rng = np.random.default_rng(n)
    x = (rng.random((2, n)) * rng.integers(1, 1000, (2, n))).astype(np.float32)
    got = cumsum(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=1))(x))
    np.testing.assert_array_equal(got, ref)


def test_tree_sum_fixed_order():
    """Pairwise sum: exact on integers, close to a float64 sum otherwise."""
    rng = np.random.default_rng(5)
    ints = rng.integers(0, 1000, (3, 12345)).astype(np.float32)
    np.testing.assert_array_equal(tree_sum(torch.from_numpy(ints)).numpy(),
                                  ints.sum(1))
    x = rng.random((3, 999)).astype(np.float32)
    np.testing.assert_allclose(tree_sum(torch.from_numpy(x)).numpy(),
                               x.astype(np.float64).sum(1), rtol=1e-6)


@pytest.mark.parametrize("s", [255.0, 3.0])
def test_true_div_is_float32_division(s):
    """true_div rounds as numpy's (and XLA's) float32 x / s, not as
    x * (1 / s): exact on every u8 level and every sum of three."""
    x = np.arange(766, dtype=np.float32)
    np.testing.assert_array_equal(true_div(torch.from_numpy(x), s).numpy(),
                                  x / np.float32(s))


@pytest.mark.parametrize("op", ["close", "open", "dilate", "erode"])
@pytest.mark.parametrize("shape,ksize", [("ellipse", (3, 3)),
                                          ("rect", (5, 3)),
                                          ("cross", (5, 5))])
def test_morphology_matches_jax(op, shape, ksize):
    """Binary morphology is exact: bit-identical masks, cv2 borders."""
    rng = np.random.default_rng(6)
    m = (rng.random((2, 23, 31)) > 0.55).astype(np.uint8) * 255
    se_t = TM.structuring_element(shape, ksize)
    se_j = JM.structuring_element(shape, ksize)
    np.testing.assert_array_equal(se_t, se_j)
    fn_t = {"close": TM.close_binary, "open": TM.open_binary,
            "dilate": TM.dilate_binary, "erode": TM.erode_binary}[op]
    fn_j = {"close": JM.close_binary, "open": JM.open_binary,
            "dilate": JM.dilate_binary, "erode": JM.erode_binary}[op]
    got = fn_t(torch.from_numpy(m), se_t).numpy()
    for b in range(2):
        np.testing.assert_array_equal(got[b],
                                      np.asarray(fn_j(jnp.asarray(m[b]), se_j)))
