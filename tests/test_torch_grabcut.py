"""GrabCut in the PyTorch port against the JAX package, on the CPU.

The same seeded scenes go through image_segmenter_tpu.solvers.grabcut
and the port's solvers/grabcut. Tolerances:
- `_nlink_weights`: max relative error <= 1e-5;
- `_gmm_from_moments` on the same moments: <= 1e-4 relative;
- `tv_mincut` on the same unary and weights: thresholded masks equal
  except where |u_jax - 0.5| < 1e-2, iteration counts within 5 %;
- `mask_energy` on the same masks: <= 1e-6 relative; over ten lanes the
  bits of ten one-lane calls;
- `grabcut_core` / `apply_grabcut`: foreground IoU >= 0.99, the port's
  mask scored by the JAX package's `mask_energy` at most
  e_jax + 1e-3 |e_jax| + 1e-3, known pixels equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from image_segmenter_tpu.compat import grabcut as JC
from image_segmenter_tpu.solvers import grabcut as JG
from image_segmenter_tpu.utils import qt_image as JQ
from image_segmenter_tpu.utils import seeds as JS
from image_segmenter_tpu_torch.compat import grabcut as TC
from image_segmenter_tpu_torch.solvers import grabcut as TG
from image_segmenter_tpu_torch.utils import qt_image as TQ
from image_segmenter_tpu_torch.utils import seeds as TS

torch.set_num_threads(2)

H, W = 72, 96


def _scene(seed, h=H, w=W):
    """FG blob with distinct colour statistics on a textured background."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.float64)
    img[...] = [40, 90, 160]  # bgr background
    img += rng.normal(0, 12, img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    blob = ((yy - h / 2) ** 2 / (h / 3.2) ** 2
            + (xx - w / 2) ** 2 / (w / 3.5) ** 2) < 1
    img[blob] = [180, 120, 50]
    img[blob] = np.clip(img[blob].astype(int)
                        + rng.normal(0, 12, (blob.sum(), 3)), 0, 255)
    return np.clip(img, 0, 255).astype(np.uint8), blob


def _homogeneous_scene(seed, sd_fg=5, sd_bg=40, dmean=0, h=H, w=W):
    """A subject close to the background's mean colour in noise of another
    spread. At the defaults the first cut takes over a thousand
    iterations; at sd_fg 20, sd_bg 30, dmean 10 the alternation collapses
    to an empty foreground, and the collapse restart runs."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = rng.normal(128, sd_bg, (h, w, 3))
    blob = ((yy - h / 2) ** 2 / (h / 3) ** 2 + (xx - w / 2) ** 2 / (w / 3) ** 2) < 1
    img[blob] = rng.normal(128 + dmean, sd_fg, (blob.sum(), 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _rect_mask(h, w, m=8):
    mask = np.full((h, w), TG.BGD, np.uint8)
    mask[m:h - m, m:w - m] = TG.PR_FGD
    return mask


def _stroke_mask(blob):
    h, w = blob.shape
    init = np.full((h, w), TG.PR_BGD, np.uint8)
    init[blob] = TG.PR_FGD
    init[:4, :] = TG.BGD
    cy, cx = h // 2, w // 2
    init[cy - 3:cy + 3, cx - 3:cx + 3] = TG.FGD
    return init


def _fg(m):
    return (m == TG.FGD) | (m == TG.PR_FGD)


def _iou(a, b):
    return (a & b).sum() / max((a | b).sum(), 1)


def _jax_energy(img, m):
    return float(JG.mask_energy(jnp.asarray(img),
                                jnp.asarray(_fg(m).astype(np.float32))))


@pytest.mark.parametrize("seed", [0, 1])
def test_nlink_weights_match_jax(seed):
    img, _ = _scene(seed)
    ref = np.stack([np.asarray(x) for x in
                    JG._nlink_weights(jnp.asarray(img, jnp.float32))])
    got = TG._nlink_weights(torch.from_numpy(img).float().permute(2, 0, 1))
    assert got.shape == ref.shape == (4, H, W)
    rel = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
    assert rel <= 1e-5, rel


def test_gmm_from_moments_matches_jax():
    img, _ = _scene(2)
    mask = _rect_mask(H, W)
    pix = jnp.asarray(img, jnp.float32).reshape(-1, 3)
    fg_gmm, _ = JG._grabcut_init(jnp.asarray(img), jnp.asarray(mask))
    fw = jnp.asarray(_fg(mask).reshape(-1).astype(np.float32))
    moments = [np.array(m) for m in
               JG._component_moments(pix, fw, JG._assign(pix, fg_gmm), 5)]
    ref = JG._gmm_from_moments(*moments)
    got = TG._gmm_from_moments(*[torch.from_numpy(m)[None] for m in moments])
    for name, a, b in zip(TG.GMM._fields, ref, got):
        a = np.asarray(a)
        rel = np.abs(b[0].numpy() - a).max() / max(np.abs(a).max(), 1e-30)
        assert rel <= 1e-4, (name, rel)


def _cut_inputs():
    """A first alternation's unary and weights on the homogeneous scene:
    the cut takes over a thousand iterations there."""
    img = _homogeneous_scene(0)
    mask = _rect_mask(H, W)
    imgj, maskj = jnp.asarray(img), jnp.asarray(mask)
    fg_gmm, bg_gmm = JG._grabcut_init(imgj, maskj)
    pix = jnp.asarray(img, jnp.float32).reshape(-1, 3)
    unary = np.array(JG._data_term(pix, fg_gmm)
                     - JG._data_term(pix, bg_gmm)).reshape(H, W)
    wts = [np.array(x) for x in JG._nlink_weights(jnp.asarray(img, jnp.float32))]
    fixed_fg = np.zeros((H, W), bool)
    fixed_bg = mask == TG.BGD
    return unary, wts, fixed_fg, fixed_bg


@pytest.fixture(scope="module")
def cut_inputs():
    return _cut_inputs()


def _port_cut(unary, wts, fixed_fg, fixed_bg, max_iter=2500, chunk=50,
              warm_y=None):
    return TG.tv_mincut(torch.from_numpy(unary)[None],
                        torch.from_numpy(np.stack(wts)),
                        torch.from_numpy(fixed_fg)[None],
                        torch.from_numpy(fixed_bg)[None],
                        max_iter=max_iter, warm_y=warm_y, chunk=chunk)


def test_tv_mincut_matches_jax(cut_inputs):
    unary, wts, fixed_fg, fixed_bg = cut_inputs
    u_j, it_j, _ = JG.tv_mincut(jnp.asarray(unary),
                                [jnp.asarray(x) for x in wts],
                                jnp.asarray(fixed_fg), jnp.asarray(fixed_bg),
                                max_iter=2500)
    u_j, it_j = np.asarray(u_j), int(it_j)
    u_t, it_t, y_t = _port_cut(unary, wts, fixed_fg, fixed_bg)
    assert it_j > 1000  # a real solve, not the 50-iteration floor
    assert abs(int(it_t[0]) - it_j) <= 0.05 * it_j, (int(it_t[0]), it_j)
    sure = np.abs(u_j - 0.5) >= 1e-2
    assert ((u_t[0].numpy() > 0.5) == (u_j > 0.5))[sure].all()
    assert y_t.shape == (1, 4, H, W)


@pytest.mark.parametrize("chunk", [1, 7])
def test_tv_mincut_chunked_stop_is_exact(cut_inputs, chunk):
    """The host reads the stop flag once per chunk; a stopped lane is
    frozen, so a chunk of 50 gives the bits of a check every iteration
    (chunk 1) or every 7, also for two lanes that stop at different
    iterations and with a warm dual."""
    unary, wts, fixed_fg, fixed_bg = cut_inputs
    u2 = np.stack([unary, 0.5 * unary + 0.3])
    fg2, bg2 = np.stack([fixed_fg] * 2), np.stack([fixed_bg] * 2)
    warm = torch.from_numpy(np.random.default_rng(0).normal(
        0, 5, (2, 4, H, W)).astype(np.float32))

    def run(c):
        return TG.tv_mincut(torch.from_numpy(u2), torch.from_numpy(np.stack(wts)),
                            torch.from_numpy(fg2), torch.from_numpy(bg2),
                            max_iter=2500, warm_y=warm, chunk=c)

    a, b = run(50), run(chunk)
    assert a[1][0] != a[1][1]  # the lanes stop at different iterations
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_mincut_exactness():
    """The TV relaxation lands on the exact discrete cut of a tiny MRF
    (brute force over all 2^16 labelings), as the JAX package's test
    checks its own."""
    rng = np.random.default_rng(42)
    h, w = 4, 4
    n = h * w
    unary = rng.normal(0, 2, (h, w)).astype(np.float32)
    wts, edges = [], []
    ys, xs = np.mgrid[0:h, 0:w]
    for dy, dx, _ in TG._DIRS:
        wt = np.abs(rng.normal(0.5, 0.5, (h, w))).astype(np.float32)
        valid = (ys + dy >= 0) & (ys + dy < h) & (xs + dx >= 0) & (xs + dx < w)
        wt = np.where(valid, wt, 0.0).astype(np.float32)
        wts.append(wt)
        for y, x in zip(*np.nonzero(valid)):
            edges.append((y * w + x, (y + dy) * w + (x + dx), wt[y, x]))
    configs = ((np.arange(1 << n)[:, None] >> np.arange(n)) & 1).astype(np.float32)
    energies = configs @ unary.reshape(-1)
    for p, q, wgt in edges:
        energies += wgt * np.abs(configs[:, p] - configs[:, q])
    u, _, _ = _port_cut(unary, wts, np.zeros((h, w), bool),
                        np.zeros((h, w), bool), max_iter=5000)
    got = (u[0].numpy() > 0.5).astype(np.float32).reshape(-1)
    e_got = float(got @ unary.reshape(-1)
                  + sum(wgt * abs(got[p] - got[q]) for p, q, wgt in edges))
    assert e_got <= energies.min() + 1e-3, (e_got, energies.min())


def test_batched_lanes_equal_unbatched():
    """One alternation over three lanes (other masks, other GMMs, one with
    a warm dual) gives each lane's unbatched bits."""
    img, blob = _scene(4)
    im = TG.prepare(torch.from_numpy(img))
    masks = [_rect_mask(H, W), _rect_mask(H, W, 14), _stroke_mask(blob)]
    lanes = []
    for m in masks:
        mt = torch.from_numpy(m)[None]
        fg, bg = TG._grabcut_init(im, mt[0])
        m1, fg1, bg1, y1, _ = TG._grabcut_iter(im, mt, fg, bg, None)
        lanes.append((m1, fg1, bg1, y1))
    cat = lambda xs: torch.cat(xs)  # noqa: E731
    batched = TG._grabcut_iter(
        im, cat([x[0] for x in lanes]),
        TG._gmm_map(lambda *a: cat(a), *[x[1] for x in lanes]),
        TG._gmm_map(lambda *a: cat(a), *[x[2] for x in lanes]),
        cat([x[3] for x in lanes]))
    for i, (m1, fg1, bg1, y1) in enumerate(lanes):
        single = TG._grabcut_iter(im, m1, fg1, bg1, y1)
        assert torch.equal(batched[0][i], single[0][0])
        assert torch.equal(batched[3][i], single[3][0])
        assert int(batched[4][i]) == int(single[4][0])
        for a, b in zip(batched[1], single[1]):
            assert torch.equal(a[i], b[0])


def _ellipse_masks(seed, n, h=H, w=W):
    """n seeded hard segmentations (C, H, W) float32: ellipses of other
    centres and radii with 2 % of the pixels flipped."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for _ in range(n):
        cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
        ry, rx = rng.uniform(0.15, 0.4) * h, rng.uniform(0.15, 0.4) * w
        m = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1
        out.append(m ^ (rng.random((h, w)) < 0.02))
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("scene", ["blob", "homogeneous"])
def test_mask_energy_matches_jax(scene):
    """The standardized energy the polish and the collapse restart judge
    with: the port's score of a mask within 1e-6 relative of the JAX
    package's `mask_energy` of the same mask."""
    img = _scene(4)[0] if scene == "blob" else _homogeneous_scene(0, 20, 30, 10)
    masks = _ellipse_masks(1, 4)
    got = TG.mask_energy(TG.prepare(torch.from_numpy(img)),
                         torch.from_numpy(masks)).numpy()
    ref = np.array([float(JG.mask_energy(jnp.asarray(img), jnp.asarray(m)))
                    for m in masks])
    rel = np.abs(got - ref) / np.abs(ref)
    assert rel.max() <= 1e-6, rel


def test_mask_energy_lanes_equal_one_lane_calls():
    """Ten lanes, as the polish scores its candidates, give the bits of
    ten one-lane calls, as the full-resolution acceptance and the collapse
    restart score: the port ranks and accepts with one score."""
    img, _ = _scene(4)
    im = TG.prepare(torch.from_numpy(img))
    masks = torch.from_numpy(_ellipse_masks(2, 10))
    batched = TG.mask_energy(im, masks)
    single = torch.cat([TG.mask_energy(im, m[None]) for m in masks])
    assert batched.shape == (10,)
    assert torch.equal(batched, single), (batched - single).abs().max()


def test_polish_round_energy_is_the_unbatched_score():
    """`_polish_round` returns the winner's energy from its ten-lane
    ranking; it equals the one-lane score of the winning mask, which is
    what the JAX package's confirmation refit computes."""
    img, blob = _scene(8)
    im = TG.prepare(torch.from_numpy(img))
    mt = torch.from_numpy(_stroke_mask(blob))[None]
    fg, bg = TG._grabcut_init(im, mt[0])
    m, fg, bg, y, _ = TG._run_alternations(im, mt, fg, bg, None, 2)
    m_c, fg_c, bg_c, y_c, e_c = TG._polish_round(im, m, fg, bg, y, 1)
    assert m_c.shape == (1, H, W) and e_c.shape == ()
    assert torch.equal(e_c, TG.mask_energy(im, TG._fg_of(m_c))[0])


def _case(name):
    if name == "collapse":
        img = _homogeneous_scene(0, 20, 30, 10)
        return img, None, _rect_mask(H, W), None
    img, blob = _scene(5)
    if name.startswith("rect"):
        return img, blob, _rect_mask(H, W), (8, 8, W - 16, H - 16)
    return img, blob, _stroke_mask(blob), None


@pytest.mark.parametrize("name,splitmerge", [
    ("rect", False), ("rect", True), ("mask", False), ("mask", True),
    ("collapse", False)])
def test_grabcut_core_matches_jax(name, splitmerge):
    img, blob, mask, _ = _case(name)
    ref = np.asarray(JG.grabcut_core(jnp.asarray(img), jnp.asarray(mask),
                                     iterations=5, splitmerge=splitmerge))
    ref_info = dict(JG.LAST_SOLVE_INFO)
    got = TG.grabcut_core(img, mask, iterations=5, splitmerge=splitmerge,
                          device="cpu").numpy()
    info = dict(TG.LAST_SOLVE_INFO)
    assert got.dtype == np.uint8 and got.shape == (H, W)
    assert set(info) == set(ref_info), (set(info), set(ref_info))
    assert info["h2d_bytes"] == ref_info["h2d_bytes"]
    assert len(info["cut_iters"]) == 5
    if name == "collapse":
        assert "t_restart" in info and "t_restart" in ref_info
    else:
        assert _iou(_fg(got), _fg(ref)) >= 0.99
    known = (mask == TG.BGD) | (mask == TG.FGD)
    assert (got[known] == mask[known]).all()
    e_ref, e_got = _jax_energy(img, ref), _jax_energy(img, got)
    assert e_got <= e_ref + 1e-3 * abs(e_ref) + 1e-3, (e_got, e_ref)
    if not _fg(ref).any() and not _fg(got).any():
        return
    assert _iou(_fg(got), _fg(ref)) >= 0.99


def test_splitmerge_coarse_search_matches_jax():
    """Above the search dim the polish proposes on an AREA-downscaled
    image and accepts by full-resolution energy: the port's polish
    against the JAX package's from the same state, and never worse than
    the plain alternation."""
    img, _ = _scene(6)
    h, w = img.shape[:2]
    mask = _rect_mask(h, w, 10)
    imgj, maskj = jnp.asarray(img), jnp.asarray(mask)
    fg, bg = JG._grabcut_init(imgj, maskj, seed=42)
    m, y = maskj, None
    for _ in range(3):
        m, fg, bg, y, _ = JG._grabcut_iter(imgj, m, fg, bg, y)
    ref = np.asarray(JG._splitmerge_polish(imgj, m, fg, bg, y, extra_iters=1,
                                           rounds=1, search_max_dim=64))

    im = TG.prepare(torch.from_numpy(img))
    fg_t, bg_t = TG._grabcut_init(im, torch.from_numpy(mask))
    mt, yt = torch.from_numpy(mask)[None], None
    for _ in range(3):
        mt, fg_t, bg_t, yt, _ = TG._grabcut_iter(im, mt, fg_t, bg_t, yt)
    plain = mt[0].numpy()
    assert _iou(_fg(plain), _fg(np.asarray(m))) >= 0.99
    got = TG._splitmerge_polish(im, mt, fg_t, bg_t, yt, extra_iters=1,
                                rounds=1, search_max_dim=64)[0].numpy()
    assert _iou(_fg(got), _fg(ref)) >= 0.99
    e_ref, e_got = _jax_energy(img, ref), _jax_energy(img, got)
    assert e_got <= e_ref + 1e-3 * abs(e_ref) + 1e-3
    assert e_got <= _jax_energy(img, plain) + 1e-3
    assert (got[:10] == TG.BGD).all()  # known pixels pass through


@pytest.mark.parametrize("search_max_dim", [256, 48])
def test_polish_reads_the_host_at_most_twice(monkeypatch, search_max_dim):
    """The polish's accept and carry decisions stay on the device: outside
    the cuts (one read a chunk) and the k-means fits (one a Lloyd step) it
    converts a tensor to a Python bool at most twice, on the small path and
    on the coarse one, over three rounds."""
    img, blob = _scene(8)
    im = TG.prepare(torch.from_numpy(img))
    mt = torch.from_numpy(_stroke_mask(blob))[None]
    fg, bg = TG._grabcut_init(im, mt[0])
    m, fg, bg, y, _ = TG._run_alternations(im, mt, fg, bg, None, 2)
    reads, inside = [], []
    real_cut = TG.tv_mincut

    def cut(*a, **k):
        inside.append(1)
        try:
            return real_cut(*a, **k)
        finally:
            inside.pop()

    def counting_bool(x):
        if torch.is_tensor(x) and not inside:
            reads.append(x)
        return bool(x)

    monkeypatch.setattr(TG, "tv_mincut", cut)
    monkeypatch.setattr(TG, "bool", counting_bool, raising=False)
    out = TG._splitmerge_polish(im, m, fg, bg, y, extra_iters=1, rounds=3,
                                search_max_dim=search_max_dim)
    assert out.shape == (1, H, W)
    assert 1 <= len(reads) <= 2


@pytest.mark.parametrize("name", ["rect", "mask"])
def test_apply_grabcut_matches_jax(name):
    img, _, mask, rect = _case(name)
    init = None if rect else mask
    ref = JC.apply_grabcut(img, rect_xywh=rect, init_mask=init, iterations=3)
    got = TC.apply_grabcut(img, rect_xywh=rect, init_mask=init, iterations=3,
                           device="cpu")
    assert got.dtype == np.uint8 and set(np.unique(got)) <= {0, 1, 2, 3}
    assert _iou(_fg(got), _fg(ref)) >= 0.99
    e_ref, e_got = _jax_energy(img, ref), _jax_energy(img, got)
    assert e_got <= e_ref + 1e-3 * abs(e_ref) + 1e-3


_BAD_CALLS = [
    ("rgba", dict(rect_xywh=(0, 0, 2, 2)), (4, 4, 4), None),
    ("no seed", {}, (4, 4, 3), None),
    ("mask shape", dict(init_mask=np.zeros((5, 5), np.uint8)), (4, 4, 3), None),
    ("float image", dict(rect_xywh=(0, 0, 2, 2)), (4, 4, 3), np.float32),
    ("grey image", dict(rect_xywh=(0, 0, 2, 2)), (4, 4), None),
]


@pytest.mark.parametrize("what,kwargs,shape,dtype", _BAD_CALLS,
                         ids=[c[0] for c in _BAD_CALLS])
def test_apply_grabcut_validates_like_jax(what, kwargs, shape, dtype):
    img = np.zeros(shape, dtype or np.uint8)
    with pytest.raises(ValueError) as e_ref:
        JC.apply_grabcut(img, **kwargs)
    with pytest.raises(ValueError) as e_got:
        TC.apply_grabcut(img, device="cpu", **kwargs)
    assert str(e_got.value) == str(e_ref.value)


def _strokes(h, w):
    um = np.zeros((h, w), np.uint8)
    um[h // 3:h // 2, w // 3:w // 2] = 1
    um[2:6, 2:w // 4] = 2
    return um


@pytest.mark.parametrize("case", ["strokes", "rect+strokes", "rect",
                                  "bg only", "none", "rect+bg only"])
def test_grabcut_seeds_equal_jax(case):
    um = _strokes(100, 120)
    if "bg only" in case:
        um = np.where(um == 1, 0, um).astype(np.uint8)
    args = {
        "strokes": ((100, 120), um),
        "rect+strokes": ((100, 120), um, (20, 10, 70, 60)),
        "rect": ((100, 120), None, (10, 10, 60, 50)),
        "bg only": ((100, 120), um),
        "none": ((100, 120), None),
        "rect+bg only": ((100, 120), um, (0, 0, 50, 40)),
    }[case]
    ref, got = JS.grabcut_seeds(*args), TS.grabcut_seeds(*args)
    assert len(ref) == len(got) == 3
    for a, b in zip(ref, got):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def test_run_grabcut_workflow_equals_jax():
    """Strokes seed the whole image; a crop rect seeds a ROI (at the
    scenes' shape, so the JAX package compiles nothing new)."""
    img, _ = _scene(7)
    um = _strokes(H, W)
    ref = JS.run_grabcut_workflow(img, um, iterations=3)
    got = TS.run_grabcut_workflow(img, um, iterations=3, device="cpu")
    assert got.dtype == np.uint8 and got.shape == (H, W, 4)
    np.testing.assert_array_equal(got, ref)
    big = np.zeros((H + 10, W + 20, 3), np.uint8)
    big[5:5 + H, 12:12 + W] = img
    ref2 = JS.run_grabcut_workflow(big, None, rect_xywh=(12, 5, W, H),
                                   iterations=2)
    got2 = TS.run_grabcut_workflow(big, None, rect_xywh=(12, 5, W, H),
                                   iterations=2, device="cpu")
    np.testing.assert_array_equal(got2, ref2)
    assert TS.run_grabcut_workflow(img, None, device="cpu") is None


def test_composite_equals_jax():
    rng = np.random.default_rng(8)
    bgr = rng.integers(0, 256, (9, 11, 3), dtype=np.uint8)
    for m in (rng.integers(0, 2, (9, 11), dtype=np.uint8),
              rng.normal(0, 1, (9, 11))):
        np.testing.assert_array_equal(
            TQ.composite_foreground_over_transparent(bgr, m),
            JQ.composite_foreground_over_transparent(bgr, m))
    with pytest.raises(ValueError):
        TQ.composite_foreground_over_transparent(bgr[..., :2], m)


def test_cuda_is_the_default_device():
    """Without a card the default device raises; the CPU runs only when
    asked for."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    img, _ = _scene(0, 8, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TC.apply_grabcut(img, rect_xywh=(1, 1, 6, 6), iterations=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TG.grabcut_core(img, _rect_mask(8, 8, 1), iterations=1)
