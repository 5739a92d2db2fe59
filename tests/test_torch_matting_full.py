"""The compat matting solver of the PyTorch port against the JAX package.

The full (3, 3) window inverse (`half_stats=False`), float64, the
rank-deficiency statistic, the solve pyramid and `estimate_alpha_cf` with
its polish and x64 rungs. No Pallas kernel is on this path in the JAX
package; both sides run their plain formulations on the CPU. The port's
float64 rungs are the same solver on torch.float64 tensors (the JAX
package solves those on the host in float64 when no TPU is there).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from helpers import corpus
from image_segmenter_tpu.solvers import matting as JMAT
from image_segmenter_tpu_torch.kernels.matvec import laplacian_matvec_plain
from image_segmenter_tpu_torch.solvers import matting as TMAT

# pytest runs several worker processes on the same cores: keep torch's
# CPU thread pool small so they do not oversubscribe them
torch.set_num_threads(2)


def _chw(x):
    return torch.from_numpy(np.array(x)).permute(2, 0, 1).contiguous()


def _close(got, ref):
    """Largest per-entry min(|diff|, |diff| / |ref|): the inverse spans
    ~9 decades; near-zero entries carry only rounding-level absolute
    error."""
    err = np.abs(got - ref)
    return float(np.minimum(err, err / np.maximum(np.abs(ref), 1e-30)).max())


def _photo(name="china", hw=(64, 96)):
    rgb = dict(corpus.load_corpus(size=128, limit=2))[name]
    return np.ascontiguousarray(rgb[16:16 + hw[0], 8:8 + hw[1]])


def _ellipse_case(rng, h, w):
    """A photo-like image with an elliptic subject and its soft alpha."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r = np.hypot((yy - h / 2) / (0.30 * h), (xx - w / 2) / (0.30 * w))
    a = np.clip((1.15 - r) / 0.3, 0, 1)
    fg = np.stack([0.8 + 0.1 * np.sin(xx / 7), 0.4 + 0.1 * np.cos(yy / 5),
                   0.3 + 0.0 * xx], -1)
    bg = np.stack([0.2 + 0.1 * np.cos(xx / 9), 0.5 + 0.2 * np.sin(yy / 11),
                   0.7 + 0.1 * np.sin((xx + yy) / 13)], -1)
    img = a[..., None] * fg + (1 - a[..., None]) * bg
    img = np.clip(img + rng.normal(0, 0.01, img.shape), 0, 1)
    rgb = np.clip(np.rint(img * 255), 0, 255).astype(np.uint8)
    tri = np.full((h, w), 0.5)
    tri[a > 0.98] = 1.0
    tri[a < 0.02] = 0.0
    return rgb, tri


def _u8(a):
    return np.clip((np.asarray(a) * 255.0 + 0.5).astype(np.uint8), 0, 255) \
        .astype(np.int32)


def _jax_inv6(pre):
    d = np.asarray(pre.dinv)
    return np.stack([d[..., 0, 0], d[..., 0, 1], d[..., 0, 2], d[..., 1, 1],
                     d[..., 1, 2], d[..., 2, 2]])


@pytest.mark.parametrize("radius", [1, 2])
def test_full_precompute_and_matvec_match_jax_f32(radius):
    """Full-inverse `_precompute` in float32: every entry within 1e-4
    (abs or rel), the bound the JAX tests use between two orders of
    evaluation; counts and rank-deficiency flags exact. `_matvec` on the
    port's own factors within 1e-5 of max|ref| of JAX's `_matvec` fed the
    same factors."""
    rng = np.random.default_rng(3)
    img = rng.random((33, 50, 3)).astype(np.float32)
    p = rng.standard_normal((33, 50)).astype(np.float32)
    jpre = JMAT._precompute(jnp.asarray(img), 1e-7, radius)
    tpre = TMAT._precompute(_chw(img)[None], 1e-7, radius)
    assert not tpre.packed and tpre.planes is None
    assert _close(tpre.dinv[0].numpy(), _jax_inv6(jpre)) < 1e-4
    assert _close(tpre.diag[0].numpy(), np.asarray(jpre.diag)) < 1e-4
    assert _close(tpre.mu[0].numpy(),
                  np.moveaxis(np.asarray(jpre.mu), -1, 0)) < 1e-4
    np.testing.assert_array_equal(tpre.n[0].numpy(), np.asarray(jpre.valid_n))
    np.testing.assert_array_equal(tpre.rankdef[0].numpy(),
                                  np.asarray(jpre.rankdef))
    ref = np.asarray(JMAT._matvec(jpre, jnp.asarray(p), radius))
    got = TMAT._matvec(tpre, torch.from_numpy(p)[None], radius)[0].numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5


def test_full_precompute_and_matvec_match_jax_f64():
    """The same in float64 (exact-eps ridge, DELTA = 0): 1e-10."""
    rng = np.random.default_rng(4)
    img = rng.random((24, 40, 3))
    p = rng.standard_normal((24, 40))
    with jax.enable_x64():
        jpre = JMAT._precompute(jnp.asarray(img, jnp.float64), 1e-7, 1)
        ref = np.asarray(JMAT._matvec(jpre, jnp.asarray(p, jnp.float64), 1))
        inv6, diag = _jax_inv6(jpre), np.asarray(jpre.diag)
    tpre = TMAT._precompute(_chw(img)[None], 1e-7, 1)
    assert tpre.dinv.dtype == torch.float64
    assert _close(tpre.dinv[0].numpy(), inv6) < 1e-10
    assert _close(tpre.diag[0].numpy(), diag) < 1e-10
    got = TMAT._matvec(tpre, torch.from_numpy(p)[None], 1)[0].numpy()
    assert got.dtype == np.float64
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-10


def test_packed_plain_matvec_any_radius():
    """Packed factors outside the K2/K3 case (radius 2) take the plain
    formulation and agree with the full inverse to rounding."""
    rng = np.random.default_rng(5)
    img = _chw(rng.random((20, 30, 3)).astype(np.float32))[None]
    p = torch.from_numpy(rng.standard_normal((1, 20, 30)).astype(np.float32))
    full = TMAT._precompute(img, 1e-7, 2)
    half = TMAT._precompute(img, 1e-7, 2, half_stats=True)
    assert half.packed and half.planes is None
    a = TMAT._matvec(full, p, 2)
    b = laplacian_matvec_plain(img, half.n, half.mu, half.dinv, p, 2, True)
    assert float((a - b).abs().max() / a.abs().max()) < 1e-5


def test_solve_full_inverse_matches_jax_f32_and_f64():
    """`solve_alpha_cf(half_stats=False)`, the compat path's solve. In
    float32: the same iteration count and flag as JAX, alpha within 1e-3
    and its u8 value equal on >= 0.999 of pixels, at most one step apart
    (XLA contracts products into FMAs and torch does not, so two float32
    CG trajectories on these near-singular windows part at rounding; the
    tighter 1e-4 holds only on well-conditioned random images). In
    float64: the same count, alpha within 1e-7."""
    rng = np.random.default_rng(6)
    rgb, tri = _ellipse_case(rng, 48, 64)
    img = rgb.astype(np.float64) / 255.0
    ja, jok, jit, _ = JMAT.solve_alpha_cf(
        jnp.asarray(img, jnp.float32), jnp.asarray(tri, jnp.float32))
    ta, tok, tit, _ = TMAT.solve_alpha_cf(
        torch.from_numpy(img.astype(np.float32))[None],
        torch.from_numpy(tri.astype(np.float32))[None])
    assert ta.dtype == torch.float32
    assert int(tit[0]) == int(jit) and bool(tok[0]) == bool(jok) is True
    assert np.abs(ta[0].numpy() - np.asarray(ja)).max() < 1e-3
    d = np.abs(_u8(ta[0].numpy()) - _u8(ja))
    assert d.max() <= 1 and (d == 0).mean() >= 0.999

    with jax.enable_x64():
        ja, jok, jit, _ = JMAT.solve_alpha_cf(
            jnp.asarray(img, jnp.float64), jnp.asarray(tri, jnp.float64),
            rtol=1e-7, max_iter=10000)
        ja = np.asarray(ja)
    ta, tok, tit, _ = TMAT.solve_alpha_cf(
        torch.from_numpy(img)[None], torch.from_numpy(tri)[None],
        rtol=1e-7, max_iter=10000)
    assert ta.dtype == torch.float64
    assert int(tit[0]) == int(jit) and bool(tok[0]) and bool(jok)
    assert np.abs(ta[0].numpy() - ja).max() < 1e-7


def test_batched_full_solve_keeps_per_image_counts():
    """Two images in one batch stop at the counts they have alone."""
    rng = np.random.default_rng(7)
    cases = [_ellipse_case(rng, 40, 56) for _ in range(2)]
    cases[1] = (cases[1][0][::-1].copy(), cases[1][1][::-1].copy())
    img = np.stack([c[0] for c in cases]).astype(np.float32) / np.float32(255)
    tri = np.stack([c[1] for c in cases]).astype(np.float32)
    _, ok, it, _, frac = TMAT.solve_alpha_cf_with_conditioning(
        torch.from_numpy(img), torch.from_numpy(tri))
    assert frac.shape == (2,) and bool(ok.all())
    for i in range(2):
        _, _, it1, _ = TMAT.solve_alpha_cf(
            torch.from_numpy(img[i:i + 1]), torch.from_numpy(tri[i:i + 1]))
        assert int(it1[0]) == int(it[i])


def test_rank_deficient_fraction_matches_jax():
    """A photo crop scores near 0 and a posterised one high: the same side
    of the 0.1 routing threshold as JAX, the value within 1e-3."""
    rgb = _photo()
    poster = (rgb // 64) * 64 + 32
    tri = np.full(rgb.shape[:2], 0.5, np.float32)
    tri[:8], tri[-8:] = 1.0, 0.0
    fr = {}
    for name, im in (("photo", rgb), ("poster", poster)):
        img = (im.astype(np.float64) / 255.0).astype(np.float32)
        j = float(JMAT.rank_deficient_fraction(jnp.asarray(img),
                                               jnp.asarray(tri)))
        t = float(TMAT.rank_deficient_fraction(
            torch.from_numpy(img)[None], torch.from_numpy(tri)[None])[0])
        assert abs(j - t) < 1e-3
        assert (j > 0.1) == (t > 0.1)
        fr[name] = t
    assert fr["photo"] < 0.1 < fr["poster"]


@pytest.mark.parametrize("hw,nhw", [((96, 416), (48, 208)),
                                    ((75, 101), (37, 50))])
def test_coarse_level_trimap_equals_jax(hw, nhw):
    """The pyramid's coarse level: `jax.image.resize(..., "linear")`
    antialiases when it shrinks; the port builds the same triangle weights.
    The coarse trimap (thresholds at 0.999) is equal and the coarse image
    within float32 rounding (1e-6). The upsample back is within 1e-5: at
    an odd size the sample positions, near 75, carry an ulp of 4e-6 that
    XLA's fused expression and numpy round differently, and a triangle
    weight moves by as much."""
    rng = np.random.default_rng(8)
    img = rng.random((*hw, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    r = np.hypot((yy - hw[0] / 2) / hw[0], (xx - hw[1] / 2) / hw[1])
    tri = np.full(hw, 0.5, np.float32)
    tri[r < 0.2] = 1.0
    tri[r > 0.35] = 0.0
    tri[rng.random(hw) < 0.01] = 0.5  # isolated unknown pixels
    jimg, jtri = JMAT._coarse_level(jnp.asarray(img), jnp.asarray(tri), *nhw)
    timg, ttri = TMAT._coarse_level(torch.from_numpy(img)[None],
                                    torch.from_numpy(tri)[None], *nhw)
    np.testing.assert_array_equal(ttri[0].numpy(), np.asarray(jtri))
    assert len(np.unique(np.asarray(jtri))) == 3
    assert np.abs(timg[0].numpy() - np.asarray(jimg)).max() < 1e-6
    a = rng.random(nhw).astype(np.float32)
    jup = np.asarray(JMAT._upsample_alpha(jnp.asarray(a), *hw))
    tup = TMAT._upsample_alpha(torch.from_numpy(a)[None], *hw)[0].numpy()
    assert np.abs(tup - jup).max() < 1e-5


@pytest.mark.parametrize("kw", [dict(polish=False), dict(polish=True),
                                dict(x64=True)],
                         ids=["f32", "polish", "x64"])
def test_estimate_alpha_cf_matches_jax(kw):
    """`estimate_alpha_cf` on a pyramid-sized case (long side 416 > 400,
    one coarse level): uint8 alpha at most one step from JAX's, equal on
    >= 0.999 of pixels after the float64 rungs and on >= 0.995 after the
    float32 rung alone (it stops at rtol 1e-5, within which two float32
    trajectories differ by a few 1e-4 in alpha, a tenth of a u8 step, so
    a few pixels in a thousand sit close enough to a rounding boundary to
    land on either side; measured 0.99797). The same keys in
    LAST_SOLVE_INFO (the polish backend is "f64" here, "host_f64" there)."""
    rng = np.random.default_rng(9)
    rgb, tri = _ellipse_case(rng, 96, 416)
    img = rgb.astype(np.float64) / 255.0
    ja = JMAT.estimate_alpha_cf(img, tri, **kw)
    jinfo = dict(JMAT.LAST_SOLVE_INFO)
    ta = TMAT.estimate_alpha_cf(img, tri, device="cpu", **kw)
    tinfo = dict(TMAT.LAST_SOLVE_INFO)
    assert ta.dtype == np.float64 and ta.shape == ja.shape
    d = np.abs(_u8(ta) - _u8(ja))
    floor = 0.995 if kw == dict(polish=False) else 0.999
    assert d.max() <= 1 and (d == 0).mean() >= floor
    assert set(tinfo) == set(jinfo)
    if kw.get("polish"):
        assert tinfo["polish_backend"] == "f64" and tinfo["polish_converged"]
        assert tinfo["polish_iters"] == jinfo["polish_iters"]
    if "f32_iters" in jinfo:
        assert tinfo["f32_iters"] == jinfo["f32_iters"]


def test_estimate_alpha_cf_ingest_and_routing():
    """The u8 ingest gives the planes of the plain float path (same alpha
    bits); a posterised image is routed to the float64 rung (no f32 keys
    left in LAST_SOLVE_INFO), as in JAX."""
    rng = np.random.default_rng(10)
    rgb, tri = _ellipse_case(rng, 40, 56)
    img = rgb.astype(np.float64) / 255.0
    a = TMAT.estimate_alpha_cf(img, tri, polish=False, device="cpu")
    # a float32 image is not exactly u8 / 255 in float64: no u8 ingest,
    # and the float32 plane it gives is the ingest table's
    b = TMAT.estimate_alpha_cf(img.astype(np.float32), tri, polish=False,
                               device="cpu")
    np.testing.assert_array_equal(a, b)

    poster = ((rgb // 64) * 64 + 32).astype(np.float64) / 255.0
    ja = JMAT.estimate_alpha_cf(poster, tri)
    assert "f32_iters" not in JMAT.LAST_SOLVE_INFO
    ta = TMAT.estimate_alpha_cf(poster, tri, device="cpu")
    assert "f32_iters" not in TMAT.LAST_SOLVE_INFO
    d = np.abs(_u8(ta) - _u8(ja))
    assert d.max() <= 1 and (d == 0).mean() >= 0.999


def test_estimate_alpha_cf_raises_on_non_convergence():
    """An iteration cap the CG cannot meet raises ValueError (what moves
    the compat ladder to its next rung); device="cuda" without a card
    raises RuntimeError instead of running on the CPU."""
    rng = np.random.default_rng(11)
    rgb, tri = _ellipse_case(rng, 32, 48)
    img = rgb.astype(np.float64) / 255.0
    with pytest.raises(ValueError, match="did not converge"):
        TMAT.estimate_alpha_cf(img, tri, cg_kwargs={"maxiter": 2},
                               device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TMAT.estimate_alpha_cf(img, tri)
