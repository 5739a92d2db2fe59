"""The chunked loops of the port's main path: the matting CG and the
Lloyd iterations of `kmeans_fit_det`.

Both run a fixed chunk of iterations between two reads of their stop
flag (`solvers/matting.CG_CHUNK`, `solvers/kmeans.LLOYD_CHUNK`), which is
what a CUDA graph of the chunk replays on the card. An image that stops
inside a chunk keeps its state, so every chunk size must give the bits
and the iteration counts of a chunk of one, the loop that reads the flag
after every iteration. And the CG's counts on corpus photos must be the
JAX package's, from `jax.vmap(solve_alpha_cf)`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_segmenter_tpu.solvers import matting as JMAT
from image_segmenter_tpu_torch.bench import corpus as TC
from image_segmenter_tpu_torch.parallel import mesh as TM
from image_segmenter_tpu_torch.pipeline import segment as TS
from image_segmenter_tpu_torch.solvers import kmeans as TKM
from image_segmenter_tpu_torch.solvers import matting as TMAT
from test_torch_kmeans import _photo
from test_torch_matting import _image, _trimap_x0

# pytest runs several worker processes on the same cores: keep torch's
# CPU thread pool small so they do not oversubscribe them
torch.set_num_threads(2)

CPU = torch.device("cpu")

# case -> (solve_alpha_cf's keyword arguments, float64, slots)
CG_CASES = {
    # the pipeline's settings; the three images stop at 18, 19 and 17
    "batch": (dict(max_iter=200, rtol=1e-4, half_stats=True), False, 1),
    # every image stops at max_iter 10, inside a chunk of 3 and of 8
    "cap": (dict(max_iter=10, rtol=1e-4, half_stats=True), False, 1),
    # the rows split over two CPU slots
    "split": (dict(max_iter=200, rtol=1e-4, half_stats=True), False, 2),
    # the compat path's float64 solve (full window inverse), 57-70 steps
    "f64": (dict(max_iter=400, rtol=1e-7), True, 1),
}


def _solve(case, chunk, monkeypatch):
    kw, f64, slots = CG_CASES[case]
    rng = np.random.default_rng(13)
    img = torch.from_numpy(_image(rng, 37, 53, b=3))
    tri, x0 = (torch.from_numpy(a) for a in _trimap_x0(rng, 3, 37, 53))
    if f64:
        img, tri, x0 = img.double(), tri.double(), None
    mesh = None if slots == 1 else TM.make_mesh((1, slots),
                                                devices=[CPU] * slots)
    monkeypatch.setattr(TMAT, "CG_CHUNK", chunk)
    return TMAT.solve_alpha_cf(img, tri, x0=x0, mesh=mesh, **kw)


@pytest.mark.parametrize("case", sorted(CG_CASES))
@pytest.mark.parametrize("chunk", [1, 3, TMAT.CG_CHUNK])
def test_chunked_cg_is_a_chunk_of_one(case, chunk, monkeypatch):
    """alpha, ok, the iteration counts and the residual of every image,
    bit for bit."""
    ref = _solve(case, 1, monkeypatch)
    got = _solve(case, chunk, monkeypatch)
    for name, g, r in zip(("alpha", "ok", "it", "res"), got, ref):
        assert torch.equal(g, r), name
    if case == "cap":
        assert got[2].tolist() == [10, 10, 10] and not got[1].any()
    else:
        assert got[1].all() and len(set(got[2].tolist())) > 1


def test_cg_loop_steps_a_chunk_in_place():
    """`step` writes the same tensors (the addresses a CUDA graph of it
    reads and writes) and counts CG_CHUNK iterations of an active image."""
    rng = np.random.default_rng(13)
    img = torch.from_numpy(_image(rng, 37, 53, b=3))
    tri, x0 = (torch.from_numpy(a) for a in _trimap_x0(rng, 3, 37, 53))
    loop = TMAT.CGLoop(img, tri, rtol=1e-4, max_iter=200, x0=x0,
                       half_stats=True)
    state = [loop.x.blocks[0], loop.r.blocks[0], loop.p.blocks[0], loop.rz,
             loop.pending, loop.it, loop.active, loop.flag]
    ptrs = [t.data_ptr() for t in state]
    assert bool(loop.flag)
    loop.step()
    assert [t.data_ptr() for t in state] == ptrs
    assert loop.it.tolist() == [TMAT.CG_CHUNK] * 3
    loop.run()
    assert loop.it.tolist() == [18, 19, 17] and not bool(loop.flag)


# case -> (k, max_iter)
LLOYD_CASES = {"photo": (16, 300), "cap": (16, 17), "empty": (5, 300)}


def _points(case):
    if case == "empty":  # fewer distinct colours than k: reseeds
        rng = np.random.default_rng(3)
        cols = np.array([[10, 10, 10], [200, 30, 30], [30, 200, 30]],
                        np.float32)
        pts = cols[rng.integers(0, 3, (2, 2000))]
        w = np.ones((2, 2000), np.float32)
    else:
        rng = np.random.default_rng(16)
        pts = _photo(rng, 2, 128, 128).reshape(2, -1, 3).astype(np.float32)
        w = (rng.random((2, 1 << 14)) > 0.2).astype(np.float32)
    return torch.from_numpy(pts), torch.from_numpy(w)


def _fit(case, chunk, monkeypatch):
    k, max_iter = LLOYD_CASES[case]
    monkeypatch.setattr(TKM, "LLOYD_CHUNK", chunk)
    loop = TKM.kmeans_fit_det_loop(*_points(case), k, max_iter=max_iter)
    loop.run()
    return loop.finish(), loop.it


@pytest.mark.parametrize("case", sorted(LLOYD_CASES))
@pytest.mark.parametrize("chunk", [1, 3, TKM.LLOYD_CHUNK])
def test_chunked_lloyd_is_a_chunk_of_one(case, chunk, monkeypatch):
    """kmeans_fit_det's centres, inertia and iteration counts, bit for
    bit; in "cap" one image converges (14 iterations) and the other stops
    at max_iter 17, inside a chunk of 3 and of 8."""
    ref, ref_it = _fit(case, 1, monkeypatch)
    got, it = _fit(case, chunk, monkeypatch)
    assert torch.equal(got.centers, ref.centers)
    assert torch.equal(got.inertia, ref.inertia)
    assert torch.equal(it, ref_it)
    if case == "cap":
        assert it.tolist() == [14, 17]
    # the public fit is the loop run to its end
    k, max_iter = LLOYD_CASES[case]
    fit = TKM.kmeans_fit_det(*_points(case), k, max_iter=max_iter)
    assert torch.equal(fit.centers, ref.centers)


# ---------------------------------------------------------------------------
# the CG's counts on corpus photos against JAX
# ---------------------------------------------------------------------------

PHOTOS = 4      # the corpus's first four photos
PHOTO_SIZE = 192


@pytest.fixture(scope="module")
def photo_system():
    """The pipeline's system on four corpus photos: image01 = u8 / 255,
    the trimap of `_trimap_device` from `synthetic_alpha_init`'s alpha,
    and that alpha / 255 as the warm start (float32 numpy)."""
    tiles = TC.load_corpus(size=PHOTO_SIZE, limit=PHOTOS)
    rgb = np.stack([t for _, t in tiles])
    alpha = np.stack([TC.synthetic_alpha_init(t) for _, t in tiles])
    tri = TS._trimap_device(torch.from_numpy(alpha)).numpy()
    img01 = rgb.astype(np.float32) / np.float32(255.0)
    x0 = alpha.astype(np.float32) / np.float32(255.0)
    return img01, tri, x0


@pytest.mark.parametrize("max_iter", [200, 12])
def test_cg_counts_on_corpus_photos_match_jax(photo_system, max_iter):
    """jax.vmap(solve_alpha_cf) and the port's batched, chunked CG at the
    pipeline's settings (rtol 1e-4, half_stats, warm start): the same
    iteration count and convergence flag for every photo, and the u8
    alpha of `test_batched_solve_matches_vmapped_jax`'s bound. At
    max_iter 12 some photos stop at the cap."""
    img01, tri, x0 = photo_system
    ja, jok, jit, _ = jax.vmap(
        lambda i, t, x: JMAT.solve_alpha_cf(i, t, max_iter=max_iter,
                                            rtol=1e-4, half_stats=True,
                                            x0=x))(
        jnp.asarray(img01), jnp.asarray(tri), jnp.asarray(x0))
    ta, tok, tit, _ = TMAT.solve_alpha_cf(
        torch.from_numpy(img01), torch.from_numpy(tri), max_iter=max_iter,
        rtol=1e-4, x0=torch.from_numpy(x0), half_stats=True)
    np.testing.assert_array_equal(tit.numpy(), np.asarray(jit))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    if max_iter == 12:
        assert (tit.numpy() == 12).any() and tok.numpy().any() \
            and not tok.numpy().all()

    def u8(a):
        return np.clip(np.floor(np.asarray(a) * 255.0 + 0.5), 0, 255)

    du8 = np.abs(u8(ta.numpy()) - u8(ja))
    assert du8.max() <= 1 and (du8 > 0).mean() <= 1e-3
