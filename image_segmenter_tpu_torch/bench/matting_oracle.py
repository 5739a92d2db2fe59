"""Float64 reference for closed-form matting at photo scale, on the host.

A copy of the JAX package's tests/helpers/matting_oracle.py, its math
unchanged: the independent reference of the corpus acceptance run
(`bench/corpus_iou.py`), not port code. pymatting, the reference app's
engine, is not a dependency, so this restates its algorithm from the
Levin/Lischinski/Weiss closed-form formulation: the matting Laplacian as
an explicit scipy sparse matrix (float64, textbook E[xx^T] - mu mu^T
window statistics, a formulation unlike the solver's matrix-free float32
stencil) and a direct sparse solve of
(L + lam * diag(is_known)) alpha = lam * known_fg. Vectorized over the 81
window-offset pairs, so a 256 x 256 photo assembles in seconds. It runs on
the host's CPU with numpy and scipy.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

LAM = 100.0


def _window_stats(img: np.ndarray, eps: float, r: int):
    """Border-clipped window mean/inverse-covariance per center (f64)."""
    h, w, _ = img.shape
    ones = np.ones((h, w))

    def box(x):
        """sum over the (2r+1)^2 window centered at each pixel, border-clipped."""
        if x.ndim == 2:
            x = x[..., None]
        pad = np.pad(x, ((r, r), (r, r), (0, 0)))
        c = pad.cumsum(axis=0).cumsum(axis=1)
        c = np.pad(c, ((1, 0), (1, 0), (0, 0)))
        # inclusion-exclusion over the padded cumsum
        out = (c[2 * r + 1 : 2 * r + 1 + h, 2 * r + 1 : 2 * r + 1 + w]
               - c[: h, 2 * r + 1 : 2 * r + 1 + w]
               - c[2 * r + 1 : 2 * r + 1 + h, : w]
               + c[: h, : w])
        return out

    n = box(ones)[..., 0]
    mu = box(img) / n[..., None]
    # second moments E[x x^T] per window
    prods = np.stack([img[..., i] * img[..., j]
                      for i in range(3) for j in range(3)], axis=-1)
    m2 = box(prods) / n[..., None]
    m2 = m2.reshape(h, w, 3, 3)
    sigma = m2 - mu[..., :, None] * mu[..., None, :]
    dinv = np.linalg.inv(sigma + (eps / n)[..., None, None] * np.eye(3))
    return n, mu, dinv


def assemble_laplacian(img01: np.ndarray, eps: float = 1e-7, r: int = 1):
    """Explicit sparse matting Laplacian with border-clipped windows (f64)."""
    img = np.asarray(img01, np.float64)
    h, w, _ = img.shape
    npx = h * w
    n, mu, dinv = _window_stats(img, eps, r)

    idx = np.arange(npx).reshape(h, w)
    offsets = [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)]

    rows, cols, vals = [], [], []
    for ay, ax in offsets:
        for by, bx in offsets:
            # centers k for which both k+a and k+b are in bounds
            y0 = max(0, -ay, -by)
            y1 = min(h, h - ay, h - by)
            x0 = max(0, -ax, -bx)
            x1 = min(w, w - ax, w - bx)
            if y0 >= y1 or x0 >= x1:
                continue
            ky, kx = np.mgrid[y0:y1, x0:x1]
            i = idx[ky + ay, kx + ax].ravel()
            j = idx[ky + by, kx + bx].ravel()
            di = img[ky + ay, kx + ax] - mu[ky, kx]          # (.., 3)
            dj = img[ky + by, kx + bx] - mu[ky, kx]
            quad = np.einsum("...i,...ij,...j->...", di, dinv[ky, kx], dj)
            g = (1.0 + quad) / n[ky, kx]
            delta = 1.0 if (ay, ax) == (by, bx) else 0.0
            rows.append(i)
            cols.append(j)
            vals.append((delta - g).ravel())
    L = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(npx, npx),
    ).tocsr()
    return L


def solve_alpha_reference(img01: np.ndarray, trimap: np.ndarray,
                          eps: float = 1e-7, r: int = 1,
                          lam: float = LAM) -> np.ndarray:
    """Reference closed-form alpha (f64 direct solve), clipped to [0, 1]."""
    h, w, _ = img01.shape
    L = assemble_laplacian(img01, eps, r)
    tri = np.asarray(trimap, np.float64).ravel()
    is_known = (tri < 0.1) | (tri > 0.9)
    known_fg = (tri > 0.9).astype(np.float64)
    A = (L + lam * sp.diags(is_known.astype(np.float64))).tocsc()
    b = lam * known_fg
    alpha = spla.spsolve(A, b)
    return np.clip(alpha.reshape(h, w), 0.0, 1.0)


def build_trimap_reference(alpha_init: np.ndarray,
                           user_mask: np.ndarray | None = None) -> np.ndarray:
    """The reference trimap ladder, written independently from the spec at
    the reference app's processing/matting_refine.py:14-54: 220/20 thresholds,
    80/20 percentile fallback when the alpha range <= 50, stroke overrides,
    then a 128-threshold fallback if either side came out empty."""
    a = np.asarray(alpha_init, np.float64)
    if a.max() - a.min() > 50:
        hi, lo = 220.0, 20.0
    else:
        hi = np.percentile(a, 80)
        lo = np.percentile(a, 20)
    tri = np.full(a.shape, 0.5)
    tri[a >= hi] = 1.0
    tri[a <= lo] = 0.0
    if user_mask is not None:
        tri[user_mask == 1] = 1.0
        tri[user_mask == 2] = 0.0
    if not (tri == 1.0).any() or not (tri == 0.0).any():
        tri = np.where(a >= 128, 1.0, 0.0)
    return tri
