"""Tendril trimming, the majority step and the harness of the PyTorch port
against the JAX package and the reference oracles, on the CPU.

Equal bytes and the same iteration counts throughout: trim_tendrils and
the TendrilTrimmer methods against the JAX package and against the
pure-Python oracle of tests/test_tendrils.py; majority_step against the
JAX package and the oracle of tests/test_property_kernels.py (hypothesis,
derandomized: a fixed seed); the three harness functions against the JAX
package. The chunked host reads of the trim and magenta loops give the
bytes and counts of a read every iteration.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from image_segmenter_tpu.compat import harness as JH
from image_segmenter_tpu.compat import tendril_trimming as JT
from image_segmenter_tpu.kernels import majority as JMAJ
from image_segmenter_tpu.kernels import tendrils as JK
from image_segmenter_tpu.ops.color import pack_rgb_u32 as jpack
from image_segmenter_tpu_torch.compat import harness as TH
from image_segmenter_tpu_torch.compat import region_cleanup as TR
from image_segmenter_tpu_torch.compat import tendril_trimming as TT
from image_segmenter_tpu_torch.kernels import majority as TMAJ
from image_segmenter_tpu_torch.kernels import tendrils as TK

from test_property_kernels import _image_from, _majority_oracle, image_strategy
from test_tendrils import _oracle_trim

torch.set_num_threads(2)


def tendril_image(h=48, w=64, seed=0):
    """Blocks joined by 1-2 px tendrils, specks and a transparent strip."""
    rng = np.random.default_rng(seed)
    pal = np.array([[200, 40, 40], [40, 180, 60], [10, 10, 200],
                    [250, 250, 20], [90, 90, 90]], np.uint8)
    img = np.zeros((h, w, 4), np.uint8)
    img[..., :3] = pal[0]
    img[..., 3] = 255
    img[: h // 2, : w // 2, :3] = pal[1]
    img[h // 2:, w // 2:, :3] = pal[2]
    for _ in range(6):
        y, x = rng.integers(2, h - 2), rng.integers(2, w - 12)
        img[y:y + rng.integers(1, 3), x:x + 10, :3] = pal[rng.integers(3, 5)]
    for _ in range(6):
        y, x = rng.integers(2, h - 12), rng.integers(2, w - 2)
        img[y:y + 10, x:x + rng.integers(1, 3), :3] = pal[rng.integers(3, 5)]
    specks = rng.random((h, w)) < 0.03
    img[specks, :3] = pal[rng.integers(0, 5, specks.sum())]
    img[:, w - 5:w - 3, 3] = 0
    return img


@pytest.mark.parametrize("max_it", [0, 1, 2, 5, 30])
@pytest.mark.parametrize("thr", [1, 2, 3])
def test_trim_tendrils_equal_jax_and_oracle(thr, max_it):
    img = tendril_image()
    want, jit, jmsg = JT.trim_tendrils(img, thr, max_it)
    got, tit, tmsg = TT.trim_tendrils(img, thr, max_it, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert (tit, tmsg) == (jit, jmsg)
    assert tit <= max_it
    ref, rit = _oracle_trim(img, thr, max_it)
    np.testing.assert_array_equal(got, ref)
    assert tit == rit


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_trim_tendrils_120x160_equal_jax(seed):
    img = tendril_image(120, 160, seed)
    for thr in (1, 2):
        want, jit, _ = JT.trim_tendrils(img, thr)
        got, tit, _ = TT.trim_tendrils(img, thr, device="cpu")
        np.testing.assert_array_equal(got, want)
        assert tit == jit


@pytest.mark.parametrize("per_read", [1, 3])
def test_chunked_reads_give_the_same_trim(monkeypatch, per_read):
    img = tendril_image(seed=4)
    want = {m: TT.trim_tendrils(img, 2, m, device="cpu")
            for m in (1, 3, 7, 30)}
    monkeypatch.setattr(TK, "ITERS_PER_READ", per_read)
    for m, (w, it, _) in want.items():
        got, git, _ = TT.trim_tendrils(img, 2, m, device="cpu")
        np.testing.assert_array_equal(got, w)
        assert git == it


def test_trim_all_transparent():
    img = tendril_image()
    img[..., 3] = 0
    out, it, msg = TT.trim_tendrils(img, 2, device="cpu")
    np.testing.assert_array_equal(out, img)
    assert (it, msg) == (0, "No non-transparent pixels found")


@settings(max_examples=30, deadline=None, derandomize=True)
@given(data=image_strategy, thr=st.integers(1, 3))
def test_trim_matches_oracle_property(data, thr):
    img = _image_from(*data)
    got, it, _ = TT.trim_tendrils(img, thr, device="cpu")
    ref, rit = _oracle_trim(img, thr)
    np.testing.assert_array_equal(got, ref)
    assert it == rit


@settings(max_examples=30, deadline=None, derandomize=True)
@given(data=image_strategy)
def test_majority_step_matches_oracle_and_jax(data):
    img = _image_from(*data)
    cid = np.asarray(jpack(jnp.asarray(img[..., :3]))).astype(np.int64)
    opaque = img[..., 3] > 0
    new, applied, differs = TMAJ.majority_step(torch.as_tensor(cid),
                                               torch.as_tensor(opaque))
    ref, ra, rd = _majority_oracle(cid, opaque)
    np.testing.assert_array_equal(new.numpy(), ref)
    assert (int(applied), int(differs)) == (ra, rd)
    jn, ja, jd = JMAJ.majority_step(jnp.asarray(cid.astype(np.uint32)),
                                    jnp.asarray(opaque))
    np.testing.assert_array_equal(new.numpy(), np.asarray(jn))
    assert (int(applied), int(differs)) == (int(ja), int(jd))


def _trimmer_pair():
    return JT.TendrilTrimmer(), TT.TendrilTrimmer(device="cpu")


@pytest.mark.parametrize("thr", [1, 2, 3])
def test_trimmer_in_place_methods_equal_jax(thr):
    jt, tt = _trimmer_pair()
    base = tendril_image(seed=5)
    a, b = base.copy(), base.copy()
    assert tt._mark_tendrils(b, thr) == jt._mark_tendrils(a, thr)
    np.testing.assert_array_equal(b, a)
    jt._process_tendrils(a, thr)
    tt._process_tendrils(b, thr)
    np.testing.assert_array_equal(b, a)
    a, b = base.copy(), base.copy()
    for _ in range(3):
        assert tt._trim_tendrils_in_iteration(b, thr) == \
            jt._trim_tendrils_in_iteration(a, thr)
        np.testing.assert_array_equal(b, a)
    # leftover sentinels: mark, then resolve them without processing
    a, b = base.copy(), base.copy()
    jt._mark_tendrils(a, thr)
    tt._mark_tendrils(b, thr)
    assert tt._apply_color_selection_to_magenta(b) == \
        jt._apply_color_selection_to_magenta(a)
    np.testing.assert_array_equal(b, a)
    assert tt.NORMAL_PIXEL == 10 and tt.BOTH_THIN == 13


@pytest.mark.parametrize("per_read", [1, 2])
def test_magenta_cleanup_chunks_and_gray_fallback(monkeypatch, per_read):
    """A marked pixel with no NORMAL pixel in reach turns gray 128; the
    rounds resolve the same however often the card is read."""
    alpha = np.full((6, 9), TK.NORMAL, np.uint8)
    alpha[:, 4:] = TK.H_THIN
    alpha[0, 8] = 0
    cid = np.arange(54, dtype=np.int64).reshape(6, 9) * 1000
    want = [np.asarray(a) for a in JK.magenta_cleanup_core(
        jnp.asarray(cid.astype(np.uint32)), jnp.asarray(alpha))]
    monkeypatch.setattr(TK, "ITERS_PER_READ", per_read)
    got = [a.numpy() for a in TK.magenta_cleanup_core(
        torch.as_tensor(cid), torch.as_tensor(alpha))]
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    alpha2 = np.full((3, 3), TK.V_THIN, np.uint8)
    c2, a2, n2 = TK.magenta_cleanup_core(torch.zeros((3, 3), dtype=torch.int64),
                                         torch.as_tensor(alpha2))
    assert int(n2) == 9 and (a2 == TK.NORMAL).all()
    assert (c2 == (128 << 16 | 128 << 8 | 128)).all()


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------

def harness_image():
    img = tendril_image(60, 80, seed=6)
    rng = np.random.default_rng(6)
    noise = rng.random(img.shape[:2]) < 0.1
    img[noise, :3] = img[np.roll(noise, 3, axis=1), :3][: noise.sum()]
    return img


@pytest.mark.parametrize("shape,op,k", [
    ("Ellipse", "Open then Close", 5), ("Rectangle", "Close then Open", 4),
    ("Cross", "Open only", 3), ("Ellipse", "Close only", 6),
    ("Rectangle", "Open then Close", 7),
])
@pytest.mark.parametrize("strength", [1.0, 0.5])
def test_custom_morphological_smoothing_equal_jax(shape, op, k, strength):
    img = harness_image()
    want = JH.apply_custom_morphological_smoothing(img, k, shape, op, strength)
    got = TH.apply_custom_morphological_smoothing(img, k, shape, op, strength,
                                                  device="cpu")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("trim", [False, True])
@pytest.mark.parametrize("max_it", [None, 3, 40])
def test_boundary_smoothing_global_equal_jax(trim, max_it):
    img = harness_image()
    msgs = {"jax": [], "torch": []}
    want = JH.apply_boundary_smoothing_global(
        img, max_it, trim, 2, lambda *a: msgs["jax"].append(a))
    got = TH.apply_boundary_smoothing_global(
        img, max_it, trim, 2, lambda *a: msgs["torch"].append(a),
        device="cpu")
    np.testing.assert_array_equal(got, want)
    assert msgs["torch"] == msgs["jax"] and msgs["torch"]


def test_compare_smoothing_algorithms_entries():
    """Each entry is the direct call's bytes (no entry fell back to the
    input copy) and the JAX entry's, gaussian and bilateral within one
    step."""
    img = harness_image()
    got = TH.compare_smoothing_algorithms(img, 0.5, device="cpu")
    want = JH.compare_smoothing_algorithms(img, 0.5)
    assert list(got) == list(want)
    for m, (out, secs) in got.items():
        direct = TR.smooth_region_boundaries(img, m, 0.5, device="cpu")
        np.testing.assert_array_equal(out, direct, err_msg=m)
        assert secs >= 0.0
        d = np.abs(out.astype(int) - want[m][0].astype(int))
        if m in ("gaussian", "bilateral"):
            assert (d.max(-1) == 0).mean() >= 0.99, m
        else:
            assert d.max() == 0, m
    assert not np.array_equal(got["multiscale"][0], img)


def test_compare_smoothing_algorithms_keeps_the_reference_fallback(monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("smoother failed")

    monkeypatch.setattr(TR, "smooth_region_boundaries", boom)
    img = harness_image()
    got = TH.compare_smoothing_algorithms(img, device="cpu")
    for out, _ in got.values():
        np.testing.assert_array_equal(out, img)
