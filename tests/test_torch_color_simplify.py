"""compat/color_simplify.py of the PyTorch port against the JAX package,
on the CPU: every public entry point on a seeded 96 x 128 RGBA with
transparent, semi-transparent and near-black regions, and on a crop of a
photograph.

The deterministic quantizers (threshold, median cut, octree), the
statistics, the alpha rule and the fall-backs are integer work: equal byte
for byte. The clustering quantizers draw the same random numbers and make
the same discrete choices, but add their float sums in another order than
XLA: palettes within 1 level per channel after matching rows, and at least
0.995 of the pixels equal. Measured on these inputs: every palette equal
(step 0) and every pixel equal, but for hsv_clustering on the synthetic
image (agreement 0.999756).
"""

import dataclasses
import functools
import inspect

import numpy as np
import pytest
import torch

import image_segmenter_tpu.compat._perceptual as JP
import image_segmenter_tpu.compat._quantize_extra as JQX
import image_segmenter_tpu.compat.color_simplify as JC
import image_segmenter_tpu_torch.compat._perceptual as TP
import image_segmenter_tpu_torch.compat.color_simplify as TC
from image_segmenter_tpu_torch import config as tconfig

torch.set_num_threads(2)
H, W = 96, 128
EXACT = ["threshold", "median_cut", "octree"]
CLUSTERING = ["kmeans", "hsv_clustering", "perceptual_fast", "perceptual",
              "adaptive_distance"]


def _synthetic():
    """Smooth gradients with noise, colours kept to 5 bits a channel so
    that the unique-colour solvers stay small; a transparent corner, a
    semi-transparent band and a near-black patch."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    base = np.stack([127 + 100 * np.sin(xx / 19) * np.cos(yy / 13),
                     127 + 100 * np.cos(xx / 23),
                     127 + 100 * np.sin((xx + yy) / 31)], -1)
    rgb = np.clip(base + rng.normal(0, 6, base.shape), 0, 255).astype(np.uint8)
    rgb &= 0xF8
    rgba = np.dstack([rgb, np.full((H, W), 255, np.uint8)])
    rgba[:20, :30, 3] = 0
    rgba[30:40, :, 3] = 100
    rgba[60:80, 60:100, :3] = rng.integers(0, 12, (20, 40, 3))
    return rgba


def _photo(y=200, x=300):
    """A crop of sklearn's china.jpg (tests/helpers/corpus.py lists the
    photographs that exist here), its top rows made transparent."""
    from sklearn.datasets import load_sample_image
    img = load_sample_image("china.jpg")[y:y + 2 * H:2, x:x + 2 * W:2]
    rgba = np.dstack([img & 0xFC, np.full((H, W), 255, np.uint8)])
    rgba[:12, :, 3] = 0
    return np.ascontiguousarray(rgba)


IMAGES = {"synthetic": _synthetic, "photo": _photo}


@functools.lru_cache(maxsize=None)
def _image(name):
    return IMAGES[name]()


_INFO = {}  # (image, algorithm) -> LAST_SOLVE_INFO of both packages


@functools.lru_cache(maxsize=None)
def _both(image, algorithm, k=8, preserve=True):
    rgba = _image(image)
    ref = JC.simplify_colors_adaptive(rgba, k, preserve, algorithm)
    jinfo = dict(JC.LAST_SOLVE_INFO), dict(JP.LAST_SOLVE_INFO)
    got = TC.simplify_colors_adaptive(rgba, k, preserve, algorithm,
                                      device="cpu")
    tinfo = dict(TC.LAST_SOLVE_INFO), dict(TP.LAST_SOLVE_INFO)
    _INFO[image, algorithm] = (tinfo, jinfo)
    return got, ref


def _assert_same_kind(got, ref):
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype, (g.dtype, r.dtype)


def _match_rows(pal, ref):
    """Rows of `pal` reordered to the nearest rows of `ref`."""
    d = np.abs(pal[None].astype(np.int32) - ref[:, None].astype(np.int32))
    return pal[d.sum(-1).argmin(axis=1)]


@pytest.mark.parametrize("image", sorted(IMAGES))
@pytest.mark.parametrize("algorithm", EXACT)
def test_exact_quantizers_equal_bytes(image, algorithm):
    (out, pal), (rout, rpal) = _both(image, algorithm)
    _assert_same_kind((out, pal), (rout, rpal))
    np.testing.assert_array_equal(out, rout)
    np.testing.assert_array_equal(pal, rpal)


@pytest.mark.parametrize("image", sorted(IMAGES))
@pytest.mark.parametrize("algorithm", CLUSTERING)
def test_clustering_quantizers_agree(image, algorithm):
    (out, pal), (rout, rpal) = _both(image, algorithm)
    _assert_same_kind((out, pal), (rout, rpal))
    assert len(pal) == 8
    matched = _match_rows(pal, rpal)
    step = np.abs(matched.astype(np.int32) - rpal.astype(np.int32)).max()
    agree = (out == rout).all(axis=-1).mean()
    print(f"{algorithm} on {image}: palette max step {step}, pixel "
          f"agreement {agree:.6f}")
    assert step <= 1
    assert agree >= 0.995
    np.testing.assert_array_equal(out[..., 3], rout[..., 3])


@pytest.mark.parametrize("algorithm", ["threshold", "hsv_clustering",
                                       "median_cut"])
def test_alpha_rule(algorithm):
    """preserve_alpha=False: alpha becomes (alpha > 128) * 255."""
    (out, _), (rout, _) = _both("synthetic", algorithm, preserve=False)
    np.testing.assert_array_equal(out[..., 3], rout[..., 3])
    rgba = _image("synthetic")
    np.testing.assert_array_equal(out[..., 3], (rgba[..., 3] > 128) * 255)


FALLBACK_ALGOS = ["kmeans", "hsv_clustering", "perceptual_fast", "perceptual",
                  "adaptive_distance"]


@pytest.mark.parametrize("algorithm", FALLBACK_ALGOS)
def test_all_transparent_falls_back(algorithm):
    rgba = _image("synthetic")[:24, :32].copy()
    rgba[..., 3] = 0
    out, pal = TC.simplify_colors_adaptive(rgba, 8, True, algorithm,
                                           device="cpu")
    rout, rpal = JC.simplify_colors_adaptive(rgba, 8, True, algorithm)
    np.testing.assert_array_equal(out, rout)
    np.testing.assert_array_equal(pal, rpal)
    np.testing.assert_array_equal(pal, [[0, 0, 0]])


@pytest.mark.parametrize("algorithm", FALLBACK_ALGOS)
def test_one_colour_falls_back(algorithm):
    rgba = np.zeros((24, 32, 4), np.uint8)
    rgba[...] = (90, 120, 200, 255)
    out, pal = TC.simplify_colors_adaptive(rgba, 8, True, algorithm,
                                           device="cpu")
    rout, rpal = JC.simplify_colors_adaptive(rgba, 8, True, algorithm)
    np.testing.assert_array_equal(out, rout)
    np.testing.assert_array_equal(pal, rpal)


@pytest.mark.parametrize("image", sorted(IMAGES))
def test_color_statistics(image):
    """Integer fields and the mean equal; the deviation adds squares in
    float32 in XLA's order in the JAX package and in float64 here: within
    float32 rounding (1e-6 relative)."""
    rgba = _image(image)
    got = TC.get_color_statistics(rgba, device="cpu")
    ref = JC.get_color_statistics(rgba)
    assert list(got) == list(ref)
    for key in ("total_unique_colors", "non_transparent_pixels", "image_size"):
        assert got[key] == ref[key]
    np.testing.assert_array_equal(got["rgb_mean"], ref["rgb_mean"])
    assert got["rgb_std"].dtype == ref["rgb_std"].dtype
    np.testing.assert_allclose(got["rgb_std"], ref["rgb_std"], rtol=1e-6)
    empty = rgba.copy()
    empty[..., 3] = 0
    got, ref = TC.get_color_statistics(empty, device="cpu"), \
        JC.get_color_statistics(empty)
    np.testing.assert_array_equal(got["rgb_mean"], ref["rgb_mean"])
    assert got["non_transparent_pixels"] == 0


@pytest.mark.parametrize("metric", ["rgb", "lab", "hsv"])
def test_custom_palette(metric):
    rgba = _image("photo")
    pal = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255], [20, 20, 20],
                    [200, 200, 200], [120, 90, 60]], np.uint8)
    out, p = TC.simplify_colors_custom_palette(rgba, pal, True, metric,
                                               device="cpu")
    rout, rp = JC.simplify_colors_custom_palette(rgba, pal, True, metric)
    np.testing.assert_array_equal(p, rp)
    agree = (out == rout).all(axis=-1).mean()
    print(f"custom_palette {metric}: pixel agreement {agree:.6f}")
    if metric == "rgb":
        np.testing.assert_array_equal(out, rout)
    assert agree >= 0.995
    with pytest.raises(ValueError):
        TC.simplify_colors_custom_palette(rgba, pal.astype(np.int32),
                                          device="cpu")


def test_bug_compat_kmeans_black_output(monkeypatch):
    """color_simplify.py:90: the output RGB stays black, the palette is
    still the fit's."""
    rgba = _image("synthetic")
    (_, pal_fixed), _ = _both("synthetic", "kmeans")
    buggy = dataclasses.replace(tconfig.DEFAULTS, bug_compat=True)
    monkeypatch.setattr(TC, "DEFAULTS", buggy)
    out, pal = TC.simplify_colors_kmeans(rgba, 8, device="cpu")
    assert (out[..., :3] == 0).all()
    np.testing.assert_array_equal(out[..., 3], rgba[..., 3])
    np.testing.assert_array_equal(pal, pal_fixed)


def test_bug_compat_perceptual_mapping(monkeypatch):
    """color_simplify.py:544: LAB pixels against RGB centres; the same
    bytes as the JAX package under its own flag."""
    from image_segmenter_tpu import config as jconfig
    rng = np.random.default_rng(0)
    rgba = np.zeros((24, 32, 4), np.uint8)
    rgba[..., 3] = 255
    rgba[..., :3] = rng.integers(0, 256, (24, 32, 3))
    out_fixed, pal_fixed = TP.simplify_colors_perceptual(rgba, 4, device="cpu")
    monkeypatch.setattr(TP, "DEFAULTS",
                        dataclasses.replace(tconfig.DEFAULTS, bug_compat=True))
    monkeypatch.setattr(JP, "DEFAULTS",
                        dataclasses.replace(jconfig.DEFAULTS, bug_compat=True))
    out_bug, pal_bug = TP.simplify_colors_perceptual(rgba, 4, device="cpu")
    np.testing.assert_array_equal(pal_fixed, pal_bug)  # same clustering
    assert (out_fixed != out_bug).any()                 # different mapping
    rout, rpal = JP.simplify_colors_perceptual(rgba, 4)
    np.testing.assert_array_equal(pal_bug, rpal)
    assert (out_bug == rout).all(axis=-1).mean() >= 0.995


def test_ward_on_a_photo_is_the_jax_ward_from_the_same_lab():
    """Ward is discontinuous in its input: on this crop two merges are so
    nearly tied that the last bit of the LAB coordinates (the port takes
    the cube root in float64, XLA in float32; 46 % of the values differ by
    an ulp) decides them, and the palettes of the two packages part
    (measured: 27 levels, 0.815 of the pixels equal). Held here: from the
    same LAB values the two solvers give the same labels, and the port's
    own LAB gives a clustering of the same quality (within 10 % in the
    mean squared LAB error of the quantized image; measured ratio 0.950)."""
    from image_segmenter_tpu.ops import color as JCOL
    from image_segmenter_tpu.solvers import agglomerative as JAG
    from image_segmenter_tpu_torch.ops import color as TCOL
    from image_segmenter_tpu_torch.solvers import agglomerative as TAG
    import jax.numpy as jnp

    rgba = _photo(150, 200)
    vals, _, n_unique, _ = TP._unique_nt(torch.from_numpy(rgba), 1 << 14, 10000)
    uniq = TCOL.unpack_rgb_u32(vals).numpy()[: int(n_unique)]
    filt = uniq[uniq.astype(np.float64).mean(axis=1) > 30]
    lab = np.zeros((TP._bucket(len(filt)), 3), np.float32)
    lab[: len(filt)] = np.asarray(JCOL.rgb_u8_to_lab(jnp.asarray(filt)))
    ref = np.asarray(JAG.ward_labels(jnp.asarray(lab), jnp.int32(len(filt)), 8))
    got = TAG.ward_labels(torch.from_numpy(lab), len(filt), 8).numpy()
    np.testing.assert_array_equal(got, ref)

    def lab_error(out):
        nt = rgba[..., 3] > 0
        a = TCOL.rgb_u8_to_lab(torch.from_numpy(out[..., :3][nt]))
        b = TCOL.rgb_u8_to_lab(torch.from_numpy(rgba[..., :3][nt]))
        return float(((a - b) ** 2).sum(dim=1).mean())

    out, _ = TP.simplify_colors_perceptual(rgba, 8, device="cpu")
    rout, _ = JP.simplify_colors_perceptual(rgba, 8)
    ratio = lab_error(out) / lab_error(rout)
    print(f"perceptual on the near-tied crop: LAB error ratio {ratio:.4f}")
    assert 0.9 <= ratio <= 1.1


ALGORITHMS = ["kmeans", "median_cut", "octree", "threshold", "perceptual",
              "perceptual_fast", "adaptive_distance", "hsv_clustering",
              "no_such_name"]


def _stub_all(monkeypatch, mod, extra=()):
    for m in (mod, *extra):
        for name in dir(m):
            if name.startswith("simplify_colors_") \
                    and name != "simplify_colors_adaptive":
                monkeypatch.setattr(
                    m, name, lambda *a, _n=name, **kw: _n, raising=True)


@pytest.mark.parametrize("unique", [3, 500, 5000])
def test_adaptive_dispatches_as_jax(monkeypatch, unique):
    """Every algorithm name, and "adaptive" at three unique-colour counts,
    reaches the entry point it reaches in the JAX package."""
    rgba = _image("synthetic")[:8, :8]
    _stub_all(monkeypatch, TC)
    _stub_all(monkeypatch, JC, extra=(JQX,))
    stats = {"total_unique_colors": unique}
    monkeypatch.setattr(TC, "get_color_statistics", lambda *a, **kw: stats)
    monkeypatch.setattr(JC, "get_color_statistics", lambda *a, **kw: stats)
    for name in ALGORITHMS + ["adaptive"]:
        assert TC.simplify_colors_adaptive(rgba, 8, True, name, device="cpu") \
            == JC.simplify_colors_adaptive(rgba, 8, True, name), name
    with pytest.raises(ValueError):
        TC.simplify_colors_adaptive(rgba, 8, True, "custom_palette")


def test_public_names_and_signatures():
    """Every public function of the JAX module exists here with the same
    parameters and defaults; those that compute take `device` as well."""
    no_device = {"create_palette_from_colors", "check_gpu_availability",
                 "get_recommended_algorithm"}
    names = [n for n, f in vars(JC).items()
             if inspect.isfunction(f) and not n.startswith("_")
             and f.__module__ == JC.__name__]
    assert len(names) == 14
    for name in names:
        jsig = inspect.signature(getattr(JC, name)).parameters
        tsig = inspect.signature(getattr(TC, name)).parameters
        extra = [] if name in no_device else ["device"]
        assert list(tsig) == list(jsig) + extra, name
        for p in jsig:
            assert tsig[p].default == jsig[p].default, (name, p)
        if extra:
            assert tsig["device"].default == "cuda"
    assert isinstance(TC.LAST_SOLVE_INFO, dict)
    assert isinstance(TP.LAST_SOLVE_INFO, dict)


def test_small_helpers_equal():
    assert set(TC.check_gpu_availability()) == set(JC.check_gpu_availability())
    assert TC.check_gpu_availability()["tpu_available"] is False
    for size in [(2000, 1000), (700, 800), (400, 400), (100, 100)]:
        for gpu in (False, True):
            assert TC.get_recommended_algorithm(size, gpu) \
                == JC.get_recommended_algorithm(size, gpu)
    cols = [(1, 2, 3), (250, 0, 9)]
    np.testing.assert_array_equal(TC.create_palette_from_colors(cols),
                                  JC.create_palette_from_colors(cols))
    with pytest.raises(ValueError):
        TC.simplify_colors_kmeans(np.zeros((4, 4, 3), np.uint8), device="cpu")
    with pytest.raises(RuntimeError):
        TC.simplify_colors_threshold(_image("synthetic"))  # no card here


def test_last_solve_info_keys():
    """The stage stamps of the JAX package, under the same names."""
    _both("synthetic", "hsv_clustering")
    (tinfo, _), (jinfo, _) = _INFO["synthetic", "hsv_clustering"]
    assert set(tinfo) == set(jinfo) \
        == {"t_ingest_masks", "t_fit", "t_map_d2h", "n_fit_points"}
    assert tinfo["n_fit_points"] == jinfo["n_fit_points"]
    _both("synthetic", "adaptive_distance")
    (_, tinfo), (_, jinfo) = _INFO["synthetic", "adaptive_distance"]
    assert set(tinfo) == set(jinfo) and len(tinfo) == 7
    for key in ("n_unique", "n_filtered"):
        assert tinfo[key] == jinfo[key]
