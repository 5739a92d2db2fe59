"""Closed-form matting in the PyTorch port against the JAX package.

The JAX side runs as its own tests run it on the CPU: the XLA formulation
of solvers/matting.py, and the Pallas kernels in interpret mode. The
port's plain versions (the CPU path of kernels K2 and K3) are held to
both, and its batched CG to `jax.vmap(solve_alpha_cf)`.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from image_segmenter_tpu.kernels.pallas_matvec import (
    build_matvec_stack, matvec_planes_tiled, tile_stack)
from image_segmenter_tpu.kernels.pallas_precompute import precompute_planes
from image_segmenter_tpu.solvers import matting as JMAT
from image_segmenter_tpu_torch.kernels import matvec as TMV
from image_segmenter_tpu_torch.kernels import precompute as TP
from image_segmenter_tpu_torch.solvers import matting as TMAT

# pytest runs several worker processes on the same cores: keep torch's
# CPU thread pool small so they do not oversubscribe them
torch.set_num_threads(2)

SHAPES = [(37, 53), (33, 130), (16, 24)]


def _image(rng, h, w, b=2):
    """Photo-like: smooth colour gradients plus noise, in [0, 1]."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for i in range(b):
        base = np.stack([0.5 + 0.4 * np.sin(xx / (5 + i) + yy / 7),
                         0.5 + 0.4 * np.cos(xx / 9 - i),
                         0.5 + 0.3 * np.sin((xx + yy) / (11 + 2 * i))], -1)
        out.append(np.clip(base + rng.normal(0, 0.02, base.shape), 0, 1))
    return np.stack(out).astype(np.float32)


def _jax_planes(img_hw3, eps):
    pre = JMAT._precompute(jnp.asarray(img_hw3), eps, 1, half_stats=True)
    return np.stack([np.asarray(pre.dinv[..., k]) for k in range(6)]
                    + [np.asarray(pre.diag), np.asarray(pre.valid_n)]
                    + [np.asarray(pre.mu[..., c]) for c in range(3)]
                    + [np.asarray(pre.rankdef, np.float32)])


def _close(got, ref, bound):
    """Every entry within `bound` in absolute OR relative terms: the
    factors span ~9 decades; near-zero entries carry only rounding-level
    absolute error."""
    err = np.abs(got - ref)
    rel = err / np.maximum(np.abs(ref), 1e-30)
    return float(np.minimum(err, rel).max())


@pytest.mark.parametrize("hw", SHAPES)
@pytest.mark.parametrize("eps", [1e-7, 1e-6])
def test_precompute_plain_matches_jax(hw, eps):
    """Plain K2 vs the JAX XLA `_precompute(half_stats=True)` and vs the
    interpret-mode Pallas `precompute_planes`: 1e-4 (abs or rel), the bound
    the JAX tests hold the Pallas kernel to (XLA contracts products into
    FMAs, torch on the CPU does not)."""
    rng = np.random.default_rng(7)
    img = _image(rng, *hw)
    got = TP.precompute_planes(torch.from_numpy(img).permute(0, 3, 1, 2)
                               .contiguous(), eps).numpy()
    assert got.shape == (2, 12, *hw)
    for b in range(2):
        assert _close(got[b], _jax_planes(img[b], eps), 1e-4) < 1e-4
        pallas = np.asarray(precompute_planes(jnp.asarray(img[b]), eps))
        assert _close(got[b], pallas, 1e-4) < 1e-4
        # counts and the rank-deficiency flags are exact
        np.testing.assert_array_equal(got[b, 7], pallas[7])


def test_precompute_flat_and_rank_deficient_regions():
    """Quantized-flat patches (rank-deficient windows, ridge-dominated
    pivots) keep the same factors and flags as the JAX package."""
    rng = np.random.default_rng(8)
    img = np.zeros((1, 24, 40, 3), np.float32)
    img[0, :, :20] = [0.2, 0.4, 0.6]
    img[0, :, 20:] = [0.8, 0.1, 0.3]
    img[0, 12:] += rng.normal(0, 0.01, (12, 40, 3)).astype(np.float32)
    got = TP.precompute_planes(torch.from_numpy(img).permute(0, 3, 1, 2)
                               .contiguous(), 1e-7).numpy()[0]
    ref = _jax_planes(img[0], 1e-7)
    assert _close(got, ref, 1e-4) < 1e-4
    np.testing.assert_array_equal(got[11], ref[11])
    assert got[11].sum() > 0


@pytest.mark.parametrize("hw", SHAPES)
def test_matvec_plain_matches_jax(hw):
    """Plain K3 vs the JAX XLA `_matvec` and the interpret-mode Pallas
    `matvec_planes_tiled`, all three fed the same planes (the port's K2
    output): max|diff| / max|ref| < 1e-5, as the JAX tests hold the Pallas
    kernel to XLA, on the same uniform-random images (photo-like windows
    are near rank-deficient, and their 1/eps-scale factors amplify the
    rounding difference between any two orders of evaluation)."""
    rng = np.random.default_rng(11)
    img = rng.random((2, *hw, 3)).astype(np.float32)
    p = rng.standard_normal((2, *hw)).astype(np.float32)
    img_t = torch.from_numpy(img).permute(0, 3, 1, 2).contiguous()
    planes = TP.precompute_planes(img_t, 1e-7)
    got = TMV.matvec_planes(planes, img_t, torch.from_numpy(p)).numpy()
    for b in range(2):
        pl = planes[b].numpy()
        image = jnp.asarray(img[b])
        n = jnp.asarray(pl[7])
        mu = jnp.asarray(np.moveaxis(pl[8:11], 0, -1))
        dinv6 = jnp.asarray(np.moveaxis(pl[0:6], 0, -1))
        pre = JMAT._Precomp(image, JMAT._pad_r(image, 1), n, n, mu, dinv6,
                            jnp.asarray(pl[6]), jnp.asarray(pl[11] > 0.5))
        ref = np.asarray(JMAT._matvec(pre, jnp.asarray(p[b]), 1))
        scale = np.abs(ref).max() + 1e-9
        assert np.abs(got[b] - ref).max() / scale < 1e-5
        stack = build_matvec_stack(image, n, mu, dinv6)
        tiled = np.asarray(matvec_planes_tiled(tile_stack(stack),
                                               jnp.asarray(p[b])))
        assert np.abs(got[b] - tiled).max() / scale < 1e-5


def _trimap_x0(rng, b, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    tri, x0 = [], []
    for i in range(b):
        r = np.hypot(yy - h * (0.4 + 0.1 * i), xx - w * 0.5)
        t = np.full((h, w), 0.5, np.float32)
        t[r < min(h, w) * 0.2] = 1.0
        t[r > min(h, w) * 0.4] = 0.0
        tri.append(t)
        x0.append(np.clip(1.2 - r / (min(h, w) * 0.4), 0, 1)
                  + rng.normal(0, 0.05, (h, w)))
    return np.stack(tri), np.stack(x0).astype(np.float32)


@pytest.mark.parametrize("hw", [(37, 53), (33, 130)])
def test_batched_solve_matches_vmapped_jax(hw):
    """Batched CG vs jax.vmap(solve_alpha_cf) at the pipeline's settings
    (half_stats, rtol 1e-4, warm start): the same per-image iteration
    counts and convergence flags; alpha within 1e-4, and its u8 values
    identical but for at most 0.1% of pixels by one step."""
    rng = np.random.default_rng(13)
    b = 3
    img = _image(rng, *hw, b=b)
    tri, x0 = _trimap_x0(rng, b, *hw)
    ja, jok, jit, jres = jax.vmap(
        lambda i, t, x: JMAT.solve_alpha_cf(i, t, max_iter=200, rtol=1e-4,
                                            half_stats=True, x0=x))(
        jnp.asarray(img), jnp.asarray(tri), jnp.asarray(x0))
    ta, tok, tit, tres = TMAT.solve_alpha_cf(
        torch.from_numpy(img), torch.from_numpy(tri), max_iter=200,
        rtol=1e-4, x0=torch.from_numpy(x0), half_stats=True)
    np.testing.assert_array_equal(tit.numpy(), np.asarray(jit))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert len(set(tit.tolist())) > 1  # images stop at different iterations

    def u8(a):
        return np.clip(np.floor(np.asarray(a) * 255.0 + 0.5), 0, 255)

    # XLA contracts products into FMAs and torch on the CPU does not, so
    # the two CG trajectories differ at float rounding; an alpha sitting on
    # a .5 boundary of the u8 rounding can then move by one step.
    du8 = np.abs(u8(ta.numpy()) - u8(ja))
    assert du8.max() <= 1 and (du8 > 0).mean() <= 1e-3
    assert np.abs(ta.numpy() - np.asarray(ja)).max() < 1e-4
    np.testing.assert_allclose(tres.numpy(), np.asarray(jres), rtol=1e-2)


def test_solve_caps_iterations():
    """max_iter stops each image, as the JAX while_loop's cond does."""
    rng = np.random.default_rng(17)
    img = _image(rng, 24, 40)
    tri, x0 = _trimap_x0(rng, 2, 24, 40)
    _, ok, it, _ = TMAT.solve_alpha_cf(
        torch.from_numpy(img), torch.from_numpy(tri), max_iter=3, rtol=1e-9,
        half_stats=True)
    assert it.tolist() == [3, 3] and not ok.any()
