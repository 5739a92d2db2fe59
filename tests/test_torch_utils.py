"""The PyTorch port's utilities, config and `processing` surface against the
JAX package's, on the same inputs (numpy seeds), on the CPU.

workflow, brush, progress, palette metrics and the SVG export are host
code in both packages and are held to equal results (the SVG text equal);
profiling is torch.profiler in the port, so `capture_device_trace` is held
to its contract instead: device events only, [] without a card.
tests/test_api_surface.py holds the JAX package's `processing` against
the reference's sources, which are absent here; this file holds the
port's `processing` to the JAX package's.
"""

import ast
import dataclasses
import importlib
import inspect
import io
import json
import os
import pathlib
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

import image_segmenter_tpu as JPKG
import image_segmenter_tpu_torch as TPKG
from image_segmenter_tpu import config as JCFG
from image_segmenter_tpu.utils import brush as JB
from image_segmenter_tpu.utils import palette as JP
from image_segmenter_tpu.utils import profiling as JPROF
from image_segmenter_tpu.utils import progress as JPR
from image_segmenter_tpu.utils import svg_export as JS
from image_segmenter_tpu.utils import workflow as JW
from image_segmenter_tpu_torch import config as TCFG
from image_segmenter_tpu_torch.utils import brush as TB
from image_segmenter_tpu_torch.utils import palette as TP
from image_segmenter_tpu_torch.utils import profiling as TPROF
from image_segmenter_tpu_torch.utils import progress as TPR
from image_segmenter_tpu_torch.utils import qt_image as TQ
from image_segmenter_tpu_torch.utils import svg_export as TS
from image_segmenter_tpu_torch.utils import workflow as TW

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# workflow
# ---------------------------------------------------------------------------

def _workflow_script(mod, rng_seed):
    """Drive a WorkflowState through every transition and the undo/redo
    stacks past their depth; return what each call and slot gave."""
    rng = np.random.default_rng(rng_seed)
    img = lambda: rng.integers(0, 256, (5, 6, 4), dtype=np.uint8)  # noqa: E731
    st = mod.WorkflowState(img())
    log = []

    def snap():
        log.append([None if s is None else s.copy() for s in (
            st.original, st.original_ai_output, st.simplified_output,
            st.cleaned_output, st.working_image)])
        log.append(st.color_processing_applied)

    snap()
    for call in ("apply_color_processing", "apply_cleanup"):
        with pytest.raises(ValueError):
            getattr(st, call)()
    st.set_ai_output(img())
    snap()
    st.set_simplified_preview(img())
    snap()
    log.append(st.apply_color_processing().copy())
    snap()
    st.set_cleaned_preview(img())
    snap()
    log.append(st.apply_cleanup().copy())
    snap()
    st.set_ai_output(img())  # a new cutout clears the later slots
    snap()
    masks = [rng.integers(0, 3, (4, 4), dtype=np.uint8) for _ in range(70)]
    for m in masks[:60]:
        st.push_undo(m)
    cur = masks[60]
    for _ in range(55):
        got = st.undo(cur)
        log.append(None if got is None else got.copy())
        if got is not None:
            cur = got
    for _ in range(53):
        got = st.redo(cur)
        log.append(None if got is None else got.copy())
        if got is not None:
            cur = got
    st.push_undo(masks[61])  # a new edit drops the redo stack
    log.append(st.redo(cur))
    return log


def _equal(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return isinstance(a, np.ndarray) and isinstance(b, np.ndarray) \
            and a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, list):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("seed", [0, 1])
def test_workflow_matches_jax(seed):
    """The slot promotions and the 50-deep undo/redo give the JAX
    package's results call for call."""
    assert TW.UNDO_DEPTH == JW.UNDO_DEPTH == 50
    got, ref = _workflow_script(TW, seed), _workflow_script(JW, seed)
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert _equal(a, b), i


# ---------------------------------------------------------------------------
# brush
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("brush_size", [1, 3, 24, 41])
def test_brush_strokes_match_jax(brush_size):
    """Stamps and interpolated strokes of every mode, in and off the
    canvas, and an unknown mode (ignored): the same mask."""
    rng = np.random.default_rng(brush_size)
    masks = [np.zeros((37, 53), np.uint8) for _ in range(2)]
    last = None
    for i in range(25):
        pos = (int(rng.integers(-20, 75)), int(rng.integers(-20, 60)))
        mode = ["include", "exclude", "erase", "lasso"][i % 4]
        for mask, mod in zip(masks, (TB, JB)):
            mod.apply_brush(mask, pos, mode, brush_size, last)
        last = pos if i % 3 else None
    np.testing.assert_array_equal(masks[0], masks[1])
    assert masks[0].any()


@pytest.mark.parametrize("cx,cy,r", [(0, 0, 5), (52, 36, 7), (-9, 4, 3),
                                     (26, 18, 0), (100, 100, 4)])
def test_paint_disk_matches_jax(cx, cy, r):
    a, b = np.zeros((37, 53), np.uint8), np.zeros((37, 53), np.uint8)
    TB.paint_disk(a, cx, cy, r, 2)
    JB.paint_disk(b, cx, cy, r, 2)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("threshold", [0, 128, 254, 255])
def test_preview_alpha_matches_jax(threshold):
    rgba = np.random.default_rng(threshold).integers(
        0, 256, (9, 11, 4), dtype=np.uint8)
    got = TB.process_alpha_for_preview(rgba, threshold)
    np.testing.assert_array_equal(
        got, JB.process_alpha_for_preview(rgba, threshold))
    assert got is not rgba


# ---------------------------------------------------------------------------
# progress
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("interval", [0.0, 3600.0])
def test_progress_matches_jax(interval):
    """The history, the text written (every call, or throttled to the
    first and the last), and cancel."""
    out = {}
    for name, mod in (("port", TPR), ("jax", JPR)):
        stream = io.StringIO()
        p = mod.ConsoleProgress("merge", stream=stream, min_interval_s=interval)
        for i in range(6):
            p(i, 5, f"pass {i}")
        p.update_progress(0, 0, "empty total")
        assert not p.is_cancelled
        p.cancel()
        assert p.is_cancelled
        out[name] = (p.history, stream.getvalue())
    assert out["port"] == out["jax"]


# ---------------------------------------------------------------------------
# palette metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ka,kb", [(8, 8), (5, 9), (12, 4), (1, 1)])
def test_palette_distances_match_jax(ka, kb):
    rng = np.random.default_rng(ka * 31 + kb)
    a = rng.uniform(0, 255, (ka, 3))
    b = a[rng.permutation(ka)][:kb] + rng.normal(0, 4, (min(ka, kb), 3)) \
        if kb <= ka else rng.uniform(0, 255, (kb, 3))
    mass = rng.integers(1, 1000, len(b))
    assert TP.matched_palette_distances(a, b) \
        == JP.matched_palette_distances(a, b)
    assert TP.matched_palette_distances(a, b, mass) \
        == JP.matched_palette_distances(a, b, mass)


@pytest.mark.parametrize("spread", [1.0, 40.0])
def test_palette_quality_matches_jax(spread):
    """Near-monochrome pixels (the RMS floor decides) and spread ones (the
    SSE ratio decides)."""
    rng = np.random.default_rng(int(spread))
    pix = 128 + rng.normal(0, spread, (500, 3))
    ref = pix[rng.choice(500, 6, replace=False)]
    ours = ref + rng.normal(0, 2, ref.shape)
    for args in ((pix, ours, ref), (pix, ours, ref, 1.0, 0.0)):
        got, want = TP.palette_quality_ok(*args), JP.palette_quality_ok(*args)
        assert got[0] == want[0] and got[1:] == want[1:]


# ---------------------------------------------------------------------------
# SVG export
# ---------------------------------------------------------------------------

def _quantized(seed, h=40, w=60, specks=0.02):
    rng = np.random.default_rng(seed)
    pal = rng.integers(0, 256, (5, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    idx = ((xx // 13 + yy // 9) % 3).astype(np.int64)
    ring = (((yy - h // 2) ** 2 + (xx - w // 4) ** 2) < 100) \
        & (((yy - h // 2) ** 2 + (xx - w // 4) ** 2) > 25)
    idx[ring] = 3
    idx[rng.random((h, w)) < specks] = 4  # specks: holes in the others
    rgba = np.empty((h, w, 4), np.uint8)
    rgba[..., :3] = pal[idx]
    rgba[..., 3] = 255
    rgba[:5, :7, 3] = 0  # a transparent corner
    return rgba


@pytest.mark.parametrize("eps,min_px", [(0.0, 1), (1.5, 1), (0.0, 50)])
@pytest.mark.parametrize("seed", [0, 1])
def test_export_svg_matches_jax(tmp_path, seed, eps, min_px):
    """The same SVG text as the JAX package (layers by coverage, holes by
    even-odd, Douglas-Peucker), written to the path when one is given."""
    rgba = _quantized(seed)
    got = TS.export_svg(rgba, str(tmp_path / "a.svg"), eps, min_px)
    assert got == JS.export_svg(rgba, None, eps, min_px)
    assert (tmp_path / "a.svg").read_text() == got
    root = ET.fromstring(got)
    assert root.get("width") == "60" and root.get("height") == "40"


def test_export_svg_many_holes_matches_jax():
    """A noisy frame (hundreds of holes, many touching each other's
    bounding boxes): the same text as the JAX package, which traces every
    hole over the whole frame."""
    rgba = _quantized(7, 120, 160, specks=0.15)
    assert TS.export_svg(rgba) == JS.export_svg(rgba)
    assert TS.export_svg(rgba, simplify_eps=1.0) \
        == JS.export_svg(rgba, simplify_eps=1.0)


def test_export_svg_edge_cases():
    empty = np.zeros((8, 8, 4), np.uint8)
    assert TS.export_svg(empty) == JS.export_svg(empty)
    with pytest.raises(ValueError):
        TS.export_svg(np.zeros((8, 8, 3), np.uint8))


# ---------------------------------------------------------------------------
# Qt bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad", [
    np.zeros((4, 4, 4), np.float32), np.zeros((4, 4, 3), np.uint8),
    np.zeros((4, 4), np.uint8), [[0, 0, 0, 0]]])
def test_numpy_rgba_to_qimage_validates_before_qt(bad):
    """The input check runs before PySide6 is imported, so it holds
    without Qt (absent here)."""
    with pytest.raises(ValueError, match="HxWx4 uint8"):
        TQ.numpy_rgba_to_qimage(bad)


def test_qt_round_trip():
    pytest.importorskip("PySide6")
    rgba = np.random.default_rng(0).integers(0, 256, (7, 9, 4),
                                             dtype=np.uint8)
    q = TQ.numpy_rgba_to_qimage(rgba)
    np.testing.assert_array_equal(TQ.qimage_to_numpy_bgr(q),
                                  rgba[..., 2::-1])


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,p", [((9, 11), 0.5), ((4, 4), 0.0),
                                     ((30, 2), 0.9)])
def test_mask_iou_and_rate_match_jax(shape, p):
    rng = np.random.default_rng(len(shape) + int(10 * p))
    a = rng.random(shape) < p
    b = rng.random(shape) < p
    assert TPROF.mask_iou(a, b) == JPROF.mask_iou(a, b)
    assert TPROF.mask_iou(a, a) == 1.0
    assert TPROF.mp_per_sec(a.size * 1000, p) == JPROF.mp_per_sec(
        a.size * 1000, p)


def test_log_metric_matches_jax():
    got, want = io.StringIO(), io.StringIO()
    rec = TPROF.log_metric("mp_per_sec", 123.456789, "MP/s", {"b": 4}, got)
    assert rec == JPROF.log_metric("mp_per_sec", 123.456789, "MP/s",
                                   {"b": 4}, want)
    assert got.getvalue() == want.getvalue()
    assert json.loads(got.getvalue())["value"] == 123.4568


def test_capture_device_trace_without_a_card(tmp_path):
    """On the CPU nothing runs on a card: [] (host operations are not
    device time), and the Chrome trace is written."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    ran = []

    def work():
        ran.append((torch.randn(64, 64) @ torch.randn(64, 64)).sum())

    assert TPROF.capture_device_trace(work, str(tmp_path / "t")) == []
    assert ran and os.path.getsize(tmp_path / "t" / "trace.json") > 0


# ---------------------------------------------------------------------------
# config, package top level, processing surface
# ---------------------------------------------------------------------------

JAX_FIELDS = [f.name for f in dataclasses.fields(JCFG.Defaults)
              if f.name != "matting_dd"]


@pytest.mark.parametrize("name", JAX_FIELDS)
def test_defaults_field_matches_jax(name):
    assert getattr(TCFG.DEFAULTS, name) == getattr(JCFG.DEFAULTS, name)


def test_defaults_and_top_level():
    """No field beyond the JAX package's (matting_dd has no counterpart:
    float64 is native on the card), the rembg ids, the version and the
    Defaults class at the package's top level."""
    assert {f.name for f in dataclasses.fields(TCFG.Defaults)} \
        == set(JAX_FIELDS)
    assert TCFG.REMBG_MODELS == JCFG.REMBG_MODELS
    assert TPKG.__version__ == JPKG.__version__
    assert TPKG.Defaults is TCFG.Defaults


HOST_ONLY = ("create_palette_from_colors", "check_gpu_availability",
             "get_recommended_algorithm", "build_trimap_from_alpha_and_strokes",
             "get_component_bounding_box", "_ensure_rgba")
PROCESSING = ["color_simplify", "grabcut", "matting_refine",
              "region_cleanup", "rembg_infer", "tendril_trimming"]


def _shim_names(module):
    """The names the repository's root processing/<module>.py re-exports."""
    tree = ast.parse((REPO / "processing" / f"{module}.py").read_text())
    return [a.name for n in tree.body if isinstance(n, ast.ImportFrom)
            for a in n.names]


def _params(fn):
    if inspect.isclass(fn):
        fn = fn.__init__
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("module", PROCESSING)
def test_processing_surface_matches_jax(module):
    """Each port `processing` module exposes the root shim's names, each
    the JAX function's parameters (names, kinds, defaults, order) with
    `device` last, defaulting to the card."""
    names = _shim_names(module)
    assert names
    ours = importlib.import_module(f"image_segmenter_tpu_torch.processing.{module}")
    jax_mod = importlib.import_module(f"image_segmenter_tpu.compat.{module}")
    tree = ast.parse(inspect.getsource(ours))
    assert [a.name for n in tree.body if isinstance(n, ast.ImportFrom)
            for a in n.names] == names
    for name in names:
        t, j = _params(getattr(ours, name)), _params(getattr(jax_mod, name))
        if name in HOST_ONLY:  # numpy helpers: no device in either
            assert t == j, name
            continue
        assert t[:-1] == j, name
        assert t[-1][0] == "device" and t[-1][2] == "cuda", name
