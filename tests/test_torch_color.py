"""ops/color.py and ops/unique.py of the PyTorch port against the JAX
package, on the CPU: all 256 grey levels and a seeded (4096, 3) u8 sample.

pack / unpack / gray / unique are integer work: equal. HSV is float32
arithmetic in the same order: within 1e-4 absolute (measured 0). LAB goes
through a power of 2.4 and a cube root, which the port takes in float64
and XLA in float32: within 1e-3 absolute with L in [0, 100] (measured
4.6e-5). lab_to_rgb_u8 rounds at the u8 step: equal but for at most one
level on under 0.1 % of the inputs (measured 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_segmenter_tpu.ops import color as JC
from image_segmenter_tpu.ops import unique as JU
from image_segmenter_tpu_torch.ops import color as TC
from image_segmenter_tpu_torch.ops import unique as TU

torch.set_num_threads(2)


def _samples():
    grey = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    rng = np.random.default_rng(0)
    return {"grey": grey,
            "random": rng.integers(0, 256, (4096, 3), dtype=np.uint8)}


@pytest.fixture(scope="module", params=["grey", "random"])
def rgb(request):
    return _samples()[request.param]


def _pair(name, x, **kw):
    j = np.asarray(getattr(JC, name)(jnp.asarray(x), **kw))
    t = getattr(TC, name)(torch.from_numpy(x), **kw).numpy()
    assert j.shape == t.shape and j.dtype == t.dtype, (j.dtype, t.dtype)
    return j, t


def test_pack_unpack_gray_equal(rgb):
    j, t = (np.asarray(JC.pack_rgb_u32(jnp.asarray(rgb))).astype(np.int64),
            TC.pack_rgb_u32(torch.from_numpy(rgb)).numpy())
    np.testing.assert_array_equal(t, j)
    back = TC.unpack_rgb_u32(torch.from_numpy(t)).numpy()
    np.testing.assert_array_equal(back, rgb)
    np.testing.assert_array_equal(*_pair("rgb_u8_to_gray_cv", rgb))
    rgba = np.concatenate([rgb, rgb[:, :1]], axis=1)
    np.testing.assert_array_equal(
        TU.pack_rgba_u32(torch.from_numpy(rgba)).numpy(),
        np.asarray(JU.pack_rgba_u32(jnp.asarray(rgba))).astype(np.int64))


def test_hsv_within_1e4(rgb):
    j, t = _pair("rgb_u8_to_hsv_cv", rgb)
    assert np.abs(j - t).max() <= 1e-4
    # and back: the u8 round trip is integer-valued
    np.testing.assert_array_equal(*_pair("hsv_cv_to_rgb_u8", j))


@pytest.mark.parametrize("fn", ["rgb_u8_to_lab", "rgb_u8_to_lab_cv"])
def test_lab_within_1e3(rgb, fn):
    j, t = _pair(fn, rgb)
    assert np.abs(j - t).max() <= 1e-3
    assert 0.0 <= t[..., 0].min()


def test_srgb_transfer_and_xyz(rgb):
    s = (rgb.astype(np.float32) / np.float32(255.0))
    for fn in ("srgb_linearize", "srgb_delinearize", "srgb_to_xyz",
               "xyz_to_srgb", "srgb_to_lab"):
        j, t = _pair(fn, s)
        assert np.abs(j - t).max() <= (1e-3 if fn == "srgb_to_lab" else 1e-6)


def test_lab_to_rgb_u8_round_trip(rgb):
    lab = np.asarray(JC.rgb_u8_to_lab(jnp.asarray(rgb)))
    j, t = _pair("lab_to_rgb_u8", lab)
    d = np.abs(j.astype(np.int32) - t.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3
    j, t = _pair("lab_to_srgb", lab)
    assert np.abs(j - t).max() <= 1e-5


# -- ops/unique ------------------------------------------------------------

def _packed(n, levels, seed):
    rng = np.random.default_rng(seed)
    rgb = (rng.integers(0, levels, (n, 3)) * (256 // levels)).astype(np.uint8)
    valid = rng.random(n) > 0.25
    packed = np.asarray(JC.pack_rgb_u32(jnp.asarray(rgb)))
    return packed, valid


@pytest.mark.parametrize("levels,cap", [(4, 256), (16, 256), (16, 8192)])
def test_packed_unique_equal(levels, cap):
    """Under the cap, and over it (16^3 colours into 256 slots: the
    smallest `cap` keys come back, n_unique stays the true count)."""
    packed, valid = _packed(5000, levels, levels)
    jv, jc, jn = JU.packed_unique(jnp.asarray(packed), jnp.asarray(valid), cap)
    tv, tc, tn = TU.packed_unique(torch.from_numpy(packed.astype(np.int64)),
                                  torch.from_numpy(valid), cap)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv).astype(np.int64))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int(tn) == int(jn)
    if levels == 16 and cap == 256:
        assert int(tn) > cap
    assert int(TU.count_unique(torch.from_numpy(packed.astype(np.int64)),
                               torch.from_numpy(valid))) \
        == int(JU.count_unique(jnp.asarray(packed), jnp.asarray(valid)))


def test_unique_none_valid_and_sentinel_order():
    packed, _ = _packed(300, 4, 0)
    none = np.zeros(300, bool)
    tv, tc, tn = TU.packed_unique(torch.from_numpy(packed.astype(np.int64)),
                                  torch.from_numpy(none), 16)
    assert int(tn) == 0 and (tv == TU.SENTINEL).all() and (tc == 0).all()
    # an RGBA key that fills all 32 bits still sorts below the sentinel
    rgba = np.array([[255, 255, 255, 254], [0, 0, 0, 1]], np.uint8)
    keys = TU.pack_rgba_u32(torch.from_numpy(rgba))
    assert (keys < TU.SENTINEL).all() and (keys >= 0).all()


@pytest.mark.parametrize("n,cap", [(5000, 512), (300, 512)])
def test_sorted_weighted_sample_equal(n, cap):
    packed, valid = _packed(n, 16, 7)
    js, jw = JU.sorted_weighted_sample(jnp.asarray(packed), jnp.asarray(valid),
                                       cap)
    ts, tw = TU.sorted_weighted_sample(
        torch.from_numpy(packed.astype(np.int64)), torch.from_numpy(valid),
        cap)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
