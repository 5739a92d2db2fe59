"""Region cleanup of the PyTorch port against the JAX package, on the CPU.

The same seeded RGBA images go through image_segmenter_tpu.compat.
region_cleanup and the port's compat/region_cleanup with device="cpu".
Every comparison is for equal bytes: analyze_regions (every key, the
per-region arrays included), merge_small_regions (connectivity 4 and 8,
negative weights, the progress-callback sequence and the printed lines,
the interactive callback), flood_fill_region and get_region_boundaries on
each rung of its ladder. The public names keep the JAX module's
parameters and defaults, with `device` last.
"""

import inspect

import numpy as np
import pytest
import torch

from image_segmenter_tpu.compat import _smoothing as JS
from image_segmenter_tpu.compat import harness as JH
from image_segmenter_tpu.compat import region_cleanup as JR
from image_segmenter_tpu.compat import tendril_trimming as JT
from image_segmenter_tpu.ops import edges as JE
from image_segmenter_tpu_torch.compat import _smoothing as TS
from image_segmenter_tpu_torch.compat import harness as TH
from image_segmenter_tpu_torch.compat import region_cleanup as TR
from image_segmenter_tpu_torch.compat import tendril_trimming as TT
from image_segmenter_tpu_torch.config import DEFAULTS
from image_segmenter_tpu_torch.ops import edges as TE

torch.set_num_threads(2)


def quantized(h, w, seed, n_colors=6, noise=0.06, hole=True):
    """Blocks of a seeded palette with speckle noise and a transparent hole:
    many small regions, as after colour quantisation."""
    rng = np.random.default_rng(seed)
    pal = rng.integers(0, 256, (n_colors, 3)).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    idx = (yy // max(1, h // 5) + xx // max(1, w // 6)) % n_colors
    idx = np.where(rng.random((h, w)) < noise,
                   rng.integers(0, n_colors, (h, w)), idx)
    img = np.zeros((h, w, 4), np.uint8)
    img[..., :3] = pal[idx]
    img[..., 3] = 255
    if hole:
        img[h // 8:h // 4, w // 8:w // 3, 3] = 0
    return img


IMAGES = {
    "120x160": lambda: quantized(120, 160, 0),
    "37x53": lambda: quantized(37, 53, 1, n_colors=4, noise=0.15),
    "64x48": lambda: quantized(64, 48, 2, n_colors=8, noise=0.1, hole=False),
}


def _assert_stats_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        if k != "all_regions":
            assert a[k] == b[k], k
    assert len(a["all_regions"]) == len(b["all_regions"])
    for ra, rb in zip(a["all_regions"], b["all_regions"]):
        assert list(ra) == list(rb)
        for k in ra:
            if isinstance(ra[k], np.ndarray):
                assert ra[k].dtype == rb[k].dtype, k
                np.testing.assert_array_equal(rb[k], ra[k], err_msg=k)
            else:
                assert ra[k] == rb[k], k


@pytest.mark.parametrize("conn", [4, 8])
@pytest.mark.parametrize("name", list(IMAGES))
def test_analyze_regions_equal_jax(name, conn):
    img = IMAGES[name]()
    for thr in (10, 100):
        _assert_stats_equal(JR.analyze_regions(img, thr, conn),
                            TR.analyze_regions(img, thr, conn, device="cpu"))


def test_analyze_regions_transparent_and_validation():
    img = quantized(20, 30, 3)
    img[..., 3] = 0
    assert TR.analyze_regions(img, device="cpu") == JR.analyze_regions(img)
    with pytest.raises(ValueError):
        TR.analyze_regions(img[..., :3].copy(), device="cpu")


def _merge_both(img, capsys, **kw):
    runs = {}
    for pkg, fn in (("jax", JR.merge_small_regions),
                    ("torch", TR.merge_small_regions)):
        calls = []
        extra = {"device": "cpu"} if pkg == "torch" else {}
        out = fn(img, progress_callback=lambda *a: calls.append(a), **kw,
                 **extra)
        runs[pkg] = (out, calls, capsys.readouterr().out)
    return runs


@pytest.mark.parametrize("conn", [4, 8])
@pytest.mark.parametrize("name", list(IMAGES))
def test_merge_small_regions_equal_jax(name, conn, capsys):
    img = IMAGES[name]()
    runs = _merge_both(img, capsys, min_size=40, connectivity=conn)
    (ja, jcalls, jout), (tb, tcalls, tout) = runs["jax"], runs["torch"]
    assert tb.dtype == np.uint8 and tb.flags.c_contiguous
    np.testing.assert_array_equal(tb, ja)
    assert tcalls == jcalls
    assert tout == jout and "Region cleanup complete" in tout


@pytest.mark.parametrize("weights", [
    {"color": -0.4, "spatial": 0.3, "frequency": -0.2, "size": 0.1},
    {"color": 1.0, "spatial": 0.0, "frequency": 0.0, "size": 0.0},
])
def test_merge_small_regions_weights_equal_jax(weights, capsys):
    img = IMAGES["120x160"]()
    for thr in (0.3, 0.95):
        runs = _merge_both(img, capsys, min_size=60, merge_weights=weights,
                           auto_merge_threshold=thr)
        np.testing.assert_array_equal(runs["torch"][0], runs["jax"][0])
        assert runs["torch"][1] == runs["jax"][1]


def test_merge_small_regions_pass_cap_and_no_regions(capsys):
    assert DEFAULTS.merge_max_passes == 20
    img = quantized(30, 40, 5, n_colors=3, noise=0.0)
    runs = _merge_both(img, capsys, min_size=1)
    out = runs["torch"][0]
    np.testing.assert_array_equal(out, img)
    assert runs["torch"][1] == runs["jax"][1]
    assert not np.shares_memory(out, img)


def test_merge_small_regions_interactive_equal_jax(capsys):
    """The merge_callback path: the same questions (target, neighbours,
    bbox) in the same order, the same answers applied; then a cancel."""
    img = IMAGES["37x53"]()
    out = {}
    for pkg, fn in (("jax", JR.merge_small_regions),
                    ("torch", TR.merge_small_regions)):
        asked = []

        def cb(target, neighbors, image, bbox):
            asked.append((tuple(target), [tuple(n) for n in neighbors],
                          bbox, image.shape))
            return neighbors[-1]

        extra = {"device": "cpu"} if pkg == "torch" else {}
        res = fn(img, 30, merge_callback=cb, auto_merge_threshold=0.99,
                 **extra)
        out[pkg] = (res, asked, capsys.readouterr().out)
    np.testing.assert_array_equal(out["torch"][0], out["jax"][0])
    assert out["torch"][1] == out["jax"][1] and out["jax"][1]
    assert out["torch"][2] == out["jax"][2]
    assert TR.merge_small_regions(img, 30, merge_callback=lambda *a: None,
                                  auto_merge_threshold=0.99,
                                  device="cpu") is None


@pytest.mark.parametrize("seed_point,fill", [
    ((30, 60), (1, 2, 3)), ((0, 0), (255, 0, 0)), ((159, 119), (9, 9, 9)),
    ((-1, 5), (1, 1, 1)), ((160, 5), (1, 1, 1)), ((30, 20), (4, 5, 6)),
])
def test_flood_fill_region_equal_jax(seed_point, fill):
    img = IMAGES["120x160"]()
    want = JR.flood_fill_region(img, seed_point, fill)
    got = TR.flood_fill_region(img, seed_point, fill, device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        TR._manual_flood_fill(img, seed_point, fill, device="cpu"), want)


def _boundary_cases():
    img = IMAGES["120x160"]()
    # rung 2: regions whose grey levels differ by at most 10, so the
    # gradient finds nothing and the per-region boundaries answer
    low = np.zeros((40, 50, 4), np.uint8)
    low[..., :3] = 100
    low[10:30, 15:35, :3] = 106
    low[..., 3] = 255
    # rung 3: one colour, opaque only inside a transparent frame of the
    # same colour: no gradient, no boundary, Canny on a flat image
    flat = np.zeros((40, 50, 4), np.uint8)
    flat[..., :3] = 77
    flat[2:-2, 2:-2, 3] = 255
    return {"gradient": img, "regions": low, "canny": flat}


@pytest.mark.parametrize("conn", [4, 8])
@pytest.mark.parametrize("rung", ["gradient", "regions", "canny"])
def test_get_region_boundaries_equal_jax(rung, conn):
    img = _boundary_cases()[rung]
    want = JR.get_region_boundaries(img, conn)
    got = TR.get_region_boundaries(img, conn, device="cpu")
    np.testing.assert_array_equal(got, want)
    if rung == "regions":
        assert got[..., 3].any()
    if rung == "canny":
        assert not got[..., 3].any()
    empty = img.copy()
    empty[..., 3] = 0
    np.testing.assert_array_equal(
        TR.get_region_boundaries(empty, conn, device="cpu"),
        JR.get_region_boundaries(empty, conn))


def test_neighbours_distance_score_and_bbox_equal_jax():
    img = IMAGES["37x53"]()
    mask = np.zeros(img.shape[:2], bool)
    mask[10:15, 20:26] = True
    for conn in (4, 8):
        assert TR.find_neighboring_colors_for_component(
            img, mask, conn, device="cpu") == \
            JR.find_neighboring_colors_for_component(img, mask, conn)
        c = tuple(int(v) for v in img[12, 22, :3])
        assert TR.find_neighboring_colors(img, c, conn, device="cpu") == \
            JR.find_neighboring_colors(img, c, conn)
    cols = [(0, 0, 0), (255, 255, 255), (200, 40, 40), (40, 180, 60),
            (12, 200, 250)]
    for a in cols:
        for b in cols:
            assert TR.color_distance(a, b, device="cpu") == \
                JR.color_distance(a, b)
    region = {"color": (200, 40, 40)}
    ctx = {"total_pixels": 1000, "max_region_size": 400,
           "color_counts": {(40, 180, 60): 300}}
    for w in (None, {"color": 1.0, "spatial": 0.0, "frequency": 0.5,
                     "size": -0.2}):
        assert TR.calculate_merge_score(region, (40, 180, 60), 120, ctx, w,
                                        device="cpu") == \
            JR.calculate_merge_score(region, (40, 180, 60), 120, ctx, w)
    for buf in (0, 10):
        assert TR.get_component_bounding_box(mask, buf) == \
            JR.get_component_bounding_box(mask, buf)
    assert TR.get_component_bounding_box(np.zeros((4, 4), bool)) is None


def test_smooth_region_boundaries_rejects_unknown_method():
    with pytest.raises(ValueError):
        TR.smooth_region_boundaries(IMAGES["37x53"](), "median", device="cpu")


# ---------------------------------------------------------------------------
# signatures
# ---------------------------------------------------------------------------

def _public_functions(mod):
    return {n: f for n, f in vars(mod).items()
            if inspect.isfunction(f) and f.__module__ == mod.__name__
            and (not n.startswith("_") or n in PRIVATE_API)}


# private names the reference's callers reach (the harness, the merge)
PRIVATE_API = {"_merge_pass_interactive", "_manual_flood_fill"}
# host-only, numpy in and out: no device
HOST_ONLY = {"get_component_bounding_box", "contour_smoothing"}


@pytest.mark.parametrize("pair", [(JR, TR), (JS, TS), (JH, TH), (JT, TT),
                                  (JE, TE)],
                         ids=["region_cleanup", "_smoothing", "harness",
                              "tendril_trimming", "edges"])
def test_signatures_match_jax_with_device_last(pair):
    jmod, tmod = pair
    jfuns = _public_functions(jmod)
    if jmod is JS:  # the smoothers; the JAX module's private cores differ
        jfuns = {n: f for n, f in jfuns.items() if n.endswith("_smoothing")}
    if jmod is JE:
        jfuns = {"canny": JE.canny}
    assert jfuns
    for name, jf in jfuns.items():
        tf = getattr(tmod, name)
        jsig = inspect.signature(jf).parameters
        tsig = inspect.signature(tf).parameters
        extra = [] if name in HOST_ONLY else ["device"]
        assert list(tsig) == list(jsig) + extra, name
        for p in jsig:
            assert tsig[p].default == jsig[p].default, (name, p)
        if extra:
            assert tsig["device"].default == "cuda", name


def test_trimmer_signatures_match_jax():
    for name in ("trim_tendrils", "_mark_tendrils", "_process_tendrils",
                 "_trim_tendrils_in_iteration",
                 "_apply_color_selection_to_magenta"):
        jsig = inspect.signature(getattr(JT.TendrilTrimmer, name)).parameters
        tsig = inspect.signature(getattr(TT.TendrilTrimmer, name)).parameters
        assert list(tsig) == list(jsig), name
        for p in jsig:
            assert tsig[p].default == jsig[p].default, (name, p)
    assert list(inspect.signature(TT.TendrilTrimmer).parameters) == ["device"]
    assert inspect.signature(TT.TendrilTrimmer).parameters["device"].default \
        == "cuda"


def test_entry_points_default_to_the_card():
    """Without device="cpu" an entry asks for CUDA, and raises where there
    is none rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    img = IMAGES["37x53"]()
    for call in (lambda: TR.analyze_regions(img),
                 lambda: TR.merge_small_regions(img, 10),
                 lambda: TR.get_region_boundaries(img),
                 lambda: TR.flood_fill_region(img, (3, 3), (0, 0, 0)),
                 lambda: TT.trim_tendrils(img, 2),
                 lambda: TH.apply_boundary_smoothing_global(img, 2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
