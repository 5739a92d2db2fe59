"""compat/matting_refine of the PyTorch port against the JAX package.

numpy in, numpy out on both sides; the port runs with device="cpu". The
trimap ladders and the morphological refine are integer work and are held
to equality; the refine entry points run the float32 solve and the float64
polish of both packages and are held to the uint8 alpha.
"""

import dataclasses

import numpy as np
import pytest
import torch

from helpers import corpus
from image_segmenter_tpu.compat import matting_refine as JREF
from image_segmenter_tpu_torch.compat import matting_refine as TREF
from image_segmenter_tpu_torch.solvers import matting as TMAT

# pytest runs several worker processes on the same cores: keep torch's
# CPU thread pool small so they do not oversubscribe them
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def photo():
    """A real photo crop (sklearn's flower), a CNN-like soft alpha for it
    and two strokes."""
    rgb = dict(corpus.load_corpus(size=160, limit=2))["flower"]
    rgb = np.ascontiguousarray(rgb[16:112, 16:144])        # 96 x 128
    alpha = corpus.synthetic_alpha_init(rgb)
    user = np.zeros(rgb.shape[:2], np.uint8)
    user[44:52, 60:68] = 1
    user[2:6, 2:30] = 2
    return rgb, alpha, user


def _agree(t, j, floor):
    assert t.dtype == np.uint8 and t.shape == j.shape
    d = np.abs(t.astype(np.int32) - j.astype(np.int32))
    assert d.max() <= 1 and (d == 0).mean() >= floor


def test_trimap_ladders_equal(photo):
    """The three ladders (220/20 thresholds, the 80/20 percentiles of a
    low-contrast alpha, the 128 fallback) and the stroke overrides."""
    rgb, alpha, user = photo
    rng = np.random.default_rng(0)
    low = (100 + rng.integers(0, 40, alpha.shape)).astype(np.uint8)
    flat = np.full(alpha.shape, 130, np.uint8)
    flat[:4] = 120
    for a in (alpha, low, flat):
        for u in (None, user):
            t = TREF.build_trimap_from_alpha_and_strokes(rgb, a, u)
            j = JREF.build_trimap_from_alpha_and_strokes(rgb, a, u)
            assert t.dtype == np.float64
            np.testing.assert_array_equal(t, j)
    t = TREF.build_trimap_from_alpha_and_strokes(rgb, alpha, user)
    assert (t[user == 1] == 1.0).all() and (t[user == 2] == 0.0).all()
    assert set(np.unique(t)) == {0.0, 0.5, 1.0}


def test_simple_alpha_refine_equal(photo):
    rgb, alpha, user = photo
    for u in (None, user):
        t = TREF.simple_alpha_refine(rgb, alpha, u, device="cpu")
        np.testing.assert_array_equal(
            t, JREF.simple_alpha_refine(rgb, alpha, u))
    assert set(np.unique(t)) <= {0, 255}


def test_input_validation_raises(photo):
    rgb, alpha, _ = photo
    for fn in (TREF.refine_alpha_portrait, TREF.refine_alpha_portrait_full_res):
        with pytest.raises(ValueError, match="rgb must be"):
            fn(rgb.astype(np.float32), alpha, None, device="cpu")
        with pytest.raises(ValueError, match="alpha_init must be"):
            fn(rgb, alpha[:-1], None, device="cpu")
    # a mesh splits the solve's rows over its slots (tests/test_torch_
    # sharded.py); anything else is refused
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        TREF.refine_alpha_portrait_full_res(rgb, alpha, None, mesh=object(),
                                            device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TREF.refine_alpha_portrait(rgb, alpha, None)


def test_refine_alpha_portrait_matches_jax(photo):
    """Rung 1 (float32 solve + float64 polish) on a photo with a CNN-like
    alpha and strokes: uint8 alpha at most one step from JAX's, equal on
    >= 0.995 of pixels; the strokes are enforced."""
    rgb, alpha, user = photo
    t = TREF.refine_alpha_portrait(rgb, alpha, user, device="cpu")
    info = dict(TMAT.LAST_SOLVE_INFO)
    assert info["polish_converged"] and info["polish_backend"] == "f64"
    _agree(t, JREF.refine_alpha_portrait(rgb, alpha, user), 0.995)
    assert (t[user == 1] == 255).all() and (t[user == 2] == 0).all()


def test_refine_alpha_portrait_shrink_path(photo, monkeypatch):
    """Over `matting_max_dim` (set to 96 in both packages for this test)
    the AREA / NEAREST_CV shrink, the solve at 72 x 96 and the LINEAR
    resize back: the same bound."""
    rgb, alpha, user = photo
    for mod in (TREF, JREF):
        monkeypatch.setattr(mod, "DEFAULTS", dataclasses.replace(
            mod.DEFAULTS, matting_max_dim=96))
    t = TREF.refine_alpha_portrait(rgb, alpha, user, device="cpu")
    _agree(t, JREF.refine_alpha_portrait(rgb, alpha, user), 0.995)
    assert t.shape == alpha.shape


def test_refine_alpha_portrait_full_res_matches_jax(photo):
    """The unsharded float32 solve at the image's own size (mesh=None)."""
    rgb, alpha, user = photo
    t = TREF.refine_alpha_portrait_full_res(rgb, alpha, user, device="cpu")
    _agree(t, JREF.refine_alpha_portrait_full_res(rgb, alpha, user), 0.995)
    assert (t[user == 1] == 255).all() and (t[user == 2] == 0).all()


def test_ladder_moves_on_value_error_only(photo, monkeypatch):
    """Non-convergence (ValueError) moves down the ladder to the
    morphological refine; a build or launch failure (RuntimeError) reaches
    the caller."""
    rgb, alpha, user = photo
    calls = []

    def never_converges(*a, **kw):
        calls.append(kw)
        raise ValueError("closed-form matting CG did not converge")

    monkeypatch.setattr(TREF, "estimate_alpha_cf", never_converges)
    t = TREF.refine_alpha_portrait_small(rgb, alpha, user, device="cpu")
    assert len(calls) == 3 and calls[2].get("x64") is True
    assert calls[1]["laplacian_kwargs"] == {"epsilon": 1e-6, "radius": 1}
    np.testing.assert_array_equal(
        t, TREF.simple_alpha_refine(rgb, alpha, user, device="cpu"))

    def build_fails(*a, **kw):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(TREF, "estimate_alpha_cf", build_fails)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        TREF.refine_alpha_portrait_small(rgb, alpha, user, device="cpu")
