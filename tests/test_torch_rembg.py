"""Sessions and compat/rembg_infer of the PyTorch port against the JAX
package.

Both packages run the same network from the same weights: the JAX
package's seeded Flax variables, carried over by models/convert.py, at
half=False (bf16 convolutions round differently between libraries). After
the CNN everything is integer work or a float64-accumulated resize and is
held to equal bytes, from one mask given to both.
"""

import types

import numpy as np
import jax
import pytest
import torch

from image_segmenter_tpu.compat import rembg_infer as JRI
from image_segmenter_tpu.models import registry as JREG
from image_segmenter_tpu_torch.compat import rembg_infer as TRI
from image_segmenter_tpu_torch.models import registry as TREG
from image_segmenter_tpu_torch.models.convert import state_from_flax

# pytest runs several worker processes on the same cores: keep torch's
# CPU thread pool small so they do not oversubscribe them
torch.set_num_threads(2)

_MEAN, _STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def _photo(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([127 + 100 * np.sin(xx / 19.0) * np.cos(yy / 13.0),
                    127 + 100 * np.cos(xx / 23.0),
                    127 + 100 * np.sin((xx + yy) / 31.0)], -1)
    return np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)


def _session_pair(model, monkeypatch, spec=None):
    """The JAX session and the port's, with the JAX session's weights."""
    if spec is not None:
        monkeypatch.setitem(JREG.SPECS, model, JREG.ModelSpec(*spec))
        monkeypatch.setitem(TREG.SPECS, model, TREG.ModelSpec(*spec))
    js = JREG.Session(model, half=False)
    ts = TREG.Session(model, half=False, device="cpu")
    ts.load_state_dict(state_from_flax(
        jax.tree_util.tree_map(np.asarray, dict(js.variables))))
    return js, ts


def test_predict_mask_u2netp_matches_jax(monkeypatch):
    """`Session.predict_mask` for u2netp at its published widths (the
    network input cut from 320 to 96 to keep the test cheap): Lanczos down,
    normalise, forward, min-max, Lanczos up. uint8 mask at most one step
    from JAX's on >= 0.999 of pixels (float32 convolutions sum in another
    order), never more than 2."""
    js, ts = _session_pair("u2netp", monkeypatch,
                           ("u2netp", (96, 96), _MEAN, _STD))
    rgb = _photo(120, 150)
    j = js.predict_mask(rgb)
    t = ts.predict_mask(rgb)
    assert t.dtype == np.uint8 and t.shape == j.shape == (120, 150)
    d = np.abs(t.astype(np.int32) - j.astype(np.int32))
    assert (d <= 1).mean() >= 0.999 and d.max() <= 2
    assert t.max() > 200 and t.min() < 50  # min-max normalised


def test_predict_class_masks_matches_jax(monkeypatch):
    """A narrow 4-class head (the cloth-seg contract on U2NETP widths at
    64 x 64): per-class masks and their union agree on >= 0.995 of pixels
    (an argmax between two near-equal classes can flip on float32
    rounding, and the Lanczos resize spreads a flipped pixel)."""
    js, ts = _session_pair("tiny_cloth", monkeypatch,
                           ("u2netp", (64, 64), _MEAN, _STD, 4))
    rgb = _photo(80, 100, seed=1)
    j = js.predict_class_masks(rgb)
    t = ts.predict_class_masks(rgb)
    assert t.dtype == np.uint8 and t.shape == j.shape == (3, 80, 100)
    assert (t == j).mean() >= 0.995
    assert (ts.predict_mask(rgb) == js.predict_mask(rgb)).mean() >= 0.995


def test_normalize_matches_jax(monkeypatch):
    js, ts = _session_pair("u2netp", monkeypatch,
                           ("u2netp", (32, 32), _MEAN, _STD))
    img = _photo(32, 32, seed=2)
    j = np.asarray(js._normalize(jax.numpy.asarray(img)))        # (1, H, W, 3)
    t = ts._normalize(torch.from_numpy(img)).numpy()             # (1, 3, H, W)
    np.testing.assert_allclose(np.moveaxis(t, 1, -1), j, rtol=0, atol=1e-6)


class _FakeSession:
    """A session that answers with a given mask, for both packages."""

    def __init__(self, mask, out_ch=1):
        self.spec = types.SimpleNamespace(out_ch=out_ch)
        self._mask = mask

    def predict_mask(self, rgb):
        return self._mask

    def predict_class_masks(self, rgb):
        return np.stack([self._mask, 255 - self._mask, self._mask // 2])


def _soft_mask(h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r = np.hypot((yy - h / 2) / (0.35 * h), (xx - w / 2) / (0.3 * w))
    return np.clip((1.2 - r) * 400, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("target_hw", [None, (45, 70)])
@pytest.mark.parametrize("sharp_edges", [True, False])
@pytest.mark.parametrize("out_ch", [1, 4])
def test_rembg_remove_equal_bytes_from_one_mask(monkeypatch, target_hw,
                                                sharp_edges, out_ch):
    """`rembg_remove_bgr_to_rgba` from the same mask: BGR flip, the 3H x W
    cloth-seg panel, PIL-NEAREST size normalisation, Otsu + close/open.
    Equal bytes."""
    bgr = _photo(60, 90, seed=3)
    sess = _FakeSession(_soft_mask(60, 90), out_ch)
    monkeypatch.setitem(JRI._sessions, "fake", sess)
    monkeypatch.setitem(TRI._sessions, ("fake", "cpu"), sess)
    j = JRI.rembg_remove_bgr_to_rgba(bgr, "fake", target_hw, sharp_edges)
    t = TRI.rembg_remove_bgr_to_rgba(bgr, "fake", target_hw, sharp_edges,
                                     device="cpu")
    assert t.dtype == np.uint8 and t.shape == (*(target_hw or (60, 90)), 4)
    np.testing.assert_array_equal(t, j)
    if sharp_edges:
        assert set(np.unique(t[..., 3])) <= {0, 255}


def test_rgba_helpers_equal_jax():
    """`_ensure_rgba`, `_resize_rgba`, `_make_alpha_sharp` one by one."""
    rng = np.random.default_rng(4)
    rgb = _photo(40, 56, seed=5)
    rgb[:5] = 0
    rgba = np.dstack([rgb, _soft_mask(40, 56)])
    np.testing.assert_array_equal(TRI._ensure_rgba(rgb), JRI._ensure_rgba(rgb))
    assert TRI._ensure_rgba(rgba) is rgba
    for bad in (rgb[..., 0], rgb[..., :2]):
        with pytest.raises(ValueError):
            TRI._ensure_rgba(bad)
    assert TRI._resize_rgba(rgba, (40, 56), device="cpu") is rgba
    for hw in [(80, 112), (33, 17)]:
        np.testing.assert_array_equal(
            TRI._resize_rgba(rgba, hw, device="cpu"),
            JRI._resize_rgba(rgba, hw))
    noisy = rgba.copy()
    noisy[..., 3] = np.clip(noisy[..., 3].astype(np.int32)
                            + rng.integers(-40, 40, (40, 56)), 0, 255)
    np.testing.assert_array_equal(TRI._make_alpha_sharp(noisy, device="cpu"),
                                  JRI._make_alpha_sharp(noisy))
    with pytest.raises(ValueError, match="bgr must be"):
        TRI.rembg_remove_bgr_to_rgba(rgba, device="cpu")


def test_sessions_are_cached_per_model_and_device(monkeypatch):
    """`_get_session` builds one session per (model, device); the card is
    never silently replaced by the CPU."""
    monkeypatch.setattr(TRI, "_sessions", {})
    a = TRI._get_session("u2netp", "cpu")
    assert TRI._get_session("u2netp", "cpu") is a
    assert a.device.type == "cpu" and a.spec.size == (320, 320)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TRI.rembg_remove_bgr_to_rgba(_photo(8, 8))
