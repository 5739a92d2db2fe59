"""CPU checks of what the redesigned K3 and K4 kernels rest on.

The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py).
Here, on the CPU:
- K4's exact integer path: for u8 pixels and whole-number palettes the key
  ((|c|^2 << 8) | k) - 512 (p . c) has its minimum at the nearest entry
  with the lowest index, so the bytes equal the plain version's; and the
  Python twin of the kernel's palette test tells the two kinds apart;
- K3's geometry: L @ p computed strip by strip and run by run, with the
  halos the kernel loads and the wrapper's own choice of run length,
  equals the plain version bit for bit, and the runs tile the rows;
- the plain versions against the JAX package's Pallas kernels in interpret
  mode at one more ragged shape each.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from image_segmenter_tpu.kernels.pallas_matvec import (
    build_matvec_stack, matvec_planes_tiled, tile_stack)
from image_segmenter_tpu.kernels.pallas_quantize import quantize_map as jquant
from image_segmenter_tpu_torch.kernels import matvec as TMV
from image_segmenter_tpu_torch.kernels import precompute as TP
from image_segmenter_tpu_torch.kernels import quantize as TQ

torch.set_num_threads(2)

H100_SMS = 132


# ---------------------------------------------------------------------------
# K4: the integer keys
# ---------------------------------------------------------------------------

def _key_argmin(rgb_u8: np.ndarray, pal: np.ndarray) -> np.ndarray:
    """The kernel's whole-number search in int64: per pixel the k that
    minimises ((|c|^2 << 8) | k) - 512 (p . c). rgb (N, 3), pal (k, 3)."""
    p = rgb_u8.astype(np.int64)
    c = pal.astype(np.int64)
    ck = ((c * c).sum(-1) << 8) | np.arange(len(c))
    key = ck[None, :] - 512 * (p @ c.T)
    assert np.abs(key).max() < 2 ** 31     # the kernel keeps it in int32
    return key.min(axis=1) & 0xFF


def _whole_case(seed: int, n: int, k: int):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    pal = rng.integers(0, 256, (k, 3)).astype(np.float32)
    if k >= 3:
        pal[k - 1] = pal[0]                    # an exact copy: equal distances
        # two entries mirrored around a pixel: equal distances, other colours
        pal[1] = np.clip(rgb[0].astype(np.float32) + [3, -2, 1], 0, 255)
        pal[2] = 2 * rgb[0].astype(np.float32) - pal[1]
        if not ((pal[2] >= 0) & (pal[2] <= 255)).all():
            pal[2] = pal[1]
    rgb[1] = pal[0].astype(np.uint8)           # distance 0 to entries 0, k - 1
    return rgb, pal


@settings(max_examples=60, derandomize=True, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), n=st.integers(2, 300),
       k=st.integers(1, 16))
def test_integer_key_picks_the_plain_versions_entry(seed, n, k):
    rgb, pal = _whole_case(seed, n, k)
    idx = _key_argmin(rgb, pal)
    # the int64 distances, first minimum
    d = ((rgb.astype(np.int64)[:, None] - pal.astype(np.int64)[None]) ** 2
         ).sum(-1)
    np.testing.assert_array_equal(idx, d.argmin(axis=1))
    # and the plain version's bytes, with the alpha and brightness tests
    rng = np.random.default_rng(seed + 1)
    alpha = (rng.random(n) > 0.3).astype(np.uint8) * 255
    thr = np.float32(rng.choice([-1.0, 10.0, 30.0, 200.0]))
    ref = TQ.quantize_map_plain(
        torch.from_numpy(rgb)[None, None], torch.from_numpy(alpha)[None, None],
        torch.from_numpy(pal)[None], k, torch.tensor([thr])).numpy()[0, 0]
    bright = rgb.astype(np.float32).sum(-1) * np.float32(1.0 / 3.0)
    fit = (alpha > 0) & (bright > thr)
    out = np.where(fit[:, None], pal.astype(np.int32).astype(np.uint8)[idx], 0)
    np.testing.assert_array_equal(out, ref)


def test_integer_key_extremes_fit_int32():
    """Black and white pixels against black and white entries: the largest
    and smallest keys the kernel can meet."""
    rgb = np.array([[0, 0, 0], [255, 255, 255]], np.uint8)
    pal = np.array([[255, 255, 255], [0, 0, 0]] * 128, np.float32)  # k = 256
    np.testing.assert_array_equal(_key_argmin(rgb, pal), [1, 0])


@pytest.mark.parametrize("name,edit,whole", [
    ("whole", lambda p: p, True),
    ("fractional", lambda p: p + 0.25, False),
    ("one fractional entry", lambda p: _set(p, (1, 4, 2), 17.5), False),
    ("negative", lambda p: _set(p, (0, 0, 0), -1.0), False),
    ("above 255", lambda p: _set(p, (0, 2, 1), 256.0), False),
    ("nan", lambda p: _set(p, (1, 1, 1), float("nan")), False),
    ("fractional past k_real", lambda p: _set(p, (1, 9, 0), 0.5), True),
    ("minus zero", lambda p: _set(p, (0, 3, 0), -0.0), True),
])
def test_whole_number_palette_twin(name, edit, whole):
    rng = np.random.default_rng(3)
    pal = edit(rng.integers(0, 256, (2, 12, 3)).astype(np.float32))
    got = TQ.whole_number_palette(torch.from_numpy(pal), 9)
    assert got.dtype == torch.bool and got.shape == (2,)
    assert bool(got.all()) is whole
    if not whole:      # per image: only the edited image says no
        assert int(got.sum()) == (0 if name == "fractional" else 1)


def _set(pal, at, value):
    pal = pal.copy()
    pal[at] = value
    return pal


def test_quantize_wrapper_takes_the_plain_version_on_the_cpu():
    """A CPU tensor goes to the plain version, whole-number palette or not,
    and launches nothing."""
    rng = np.random.default_rng(5)
    rgb = torch.from_numpy(rng.integers(0, 256, (2, 9, 11, 3), dtype=np.uint8))
    alpha = torch.from_numpy((rng.random((2, 9, 11)) > 0.3))
    pal = torch.from_numpy(rng.integers(0, 256, (2, 8, 3)).astype(np.float32))
    pal[1] += 0.5
    thr = torch.tensor([20.0, -1.0])
    before = TQ.LAUNCHES
    assert torch.equal(TQ.quantize_map(rgb, alpha, pal, 8, thr),
                       TQ.quantize_map_plain(rgb, alpha, pal, 8, thr))
    assert TQ.LAUNCHES == before
    with pytest.raises(ValueError):
        TQ.quantize_map(rgb, alpha, pal[:1], 8, thr)


# ---------------------------------------------------------------------------
# K3: strips and runs
# ---------------------------------------------------------------------------

def matvec_planes_strips(planes, img, p, strip, rows):
    """L @ p as csrc/matvec.cu walks it: per image, per strip of `strip`
    output columns and per run of `rows` output rows, from the operands
    with the kernel's halos (2 for p and the image, zero outside the
    image; 1 for the factor planes) and nothing else."""
    b, h, w = p.shape
    pad2 = torch.nn.functional.pad
    p2 = pad2(p, (2, 2, 2, 2))             # index + 2
    i2 = pad2(img, (2, 2, 2, 2))
    f1 = pad2(planes, (1, 1, 1, 1))        # index + 1; the pad is never used
    out = torch.full_like(p, float("nan"))
    for x0 in range(0, w, strip):
        x1 = min(x0 + strip, w)
        for r0, r1 in TMV.run_bounds(h, rows):
            # centre grid: rows r0 - 1 .. r1, columns x0 - 1 .. x1
            hc, wc = r1 - r0 + 2, x1 - x0 + 2
            pw = p2[:, r0:r0 + hc + 2, x0:x0 + wc + 2]       # halo 2
            iw = i2[:, :, r0:r0 + hc + 2, x0:x0 + wc + 2]
            fw = f1[:, :, r0:r0 + hc, x0:x0 + wc]            # halo 1
            ki1, ki2, ki3, kl21, kl31, kl32 = fw[:, 0:6].unbind(1)
            nk, mu = fw[:, 7], fw[:, 8:11]
            hp = (pw[..., 0:wc] + pw[..., 1:wc + 1]) + pw[..., 2:wc + 2]
            psum = (hp[:, 0:hc] + hp[:, 1:hc + 1]) + hp[:, 2:hc + 2]
            cov = torch.zeros_like(mu)
            for dy in range(3):
                for dx in range(3):
                    cov = cov + (iw[..., dy:dy + hc, dx:dx + wc] - mu) \
                        * pw[:, None, dy:dy + hc, dx:dx + wc]
            n_div = torch.clamp_min(nk, 1.0)
            pbar = psum / n_div
            v0, v1, v2 = (cov / n_div[:, None]).unbind(1)
            bq = kl21 * kl32 - kl31
            t1 = v1 - kl21 * v0
            t2 = bq * v0 - kl32 * v1 + v2
            w0, w1, w2 = ki1 * v0, ki2 * t1, ki3 * t2
            a0 = w0 - kl21 * w1 + bq * w2
            a1 = w1 - kl32 * w2
            a2 = w2
            bb = pbar - ((a0 * mu[:, 0] + a1 * mu[:, 1]) + a2 * mu[:, 2])
            # windows centred outside the image contribute nothing
            cy = torch.arange(r0 - 1, r1 + 1)[:, None]
            cx = torch.arange(x0 - 1, x1 + 1)[None, :]
            inside = (cy >= 0) & (cy < h) & (cx >= 0) & (cx < w)
            ab = torch.stack([a0, a1, a2, bb], 1)
            ab = torch.where(inside, ab, torch.zeros(()))
            wo, ho = wc - 2, hc - 2
            hs = (ab[..., 0:wo] + ab[..., 1:wo + 1]) + ab[..., 2:wo + 2]
            box = (hs[:, :, 0:ho] + hs[:, :, 1:ho + 1]) + hs[:, :, 2:ho + 2]
            pix = img[:, :, r0:r1, x0:x1]
            out[:, r0:r1, x0:x1] = planes[:, 7, r0:r1, x0:x1] * p[:, r0:r1, x0:x1] \
                - (((box[:, 0] * pix[:, 0] + box[:, 1] * pix[:, 1])
                    + box[:, 2] * pix[:, 2]) + box[:, 3])
    return out


def _matvec_operands(seed, b, h, w):
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.random((b, 3, h, w), dtype=np.float32))
    p = torch.from_numpy(rng.standard_normal((b, h, w)).astype(np.float32))
    return TP.precompute_planes(img, 1e-7), img, p


@pytest.mark.parametrize("bhw", [(2, 37, 53), (1, 33, 130), (2, 203, 389),
                                 (1, 576, 1024), (1, 1, 1), (1, 5, 3)])
def test_matvec_strip_walk_equals_plain_bit_for_bit(bhw):
    """The wrapper's strip width and its run length for an H100."""
    b, h, w = bhw
    planes, img, p = _matvec_operands(13, b, h, w)
    ref = TMV.matvec_planes_plain(planes, img, p)
    rows = TMV.run_rows(h, w, b, H100_SMS)
    got = matvec_planes_strips(planes, img, p, TMV.STRIP, rows)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("bhw", [(2, 23, 150), (1, 9, 260), (1, 30, 128)])
@pytest.mark.parametrize("rows", [1, 2, 7])
def test_matvec_strip_walk_short_runs(bhw, rows):
    """Runs shorter than the halo they re-read: each run stands alone."""
    planes, img, p = _matvec_operands(14, *bhw)
    ref = TMV.matvec_planes_plain(planes, img, p)
    assert torch.equal(matvec_planes_strips(planes, img, p, TMV.STRIP, rows),
                       ref)


@pytest.mark.parametrize("b", [1, 4])
def test_matvec_runs_tile_the_rows(b):
    for w in (53, 1024):
        for h in range(1, 601):
            rows = TMV.run_rows(h, w, b, H100_SMS)
            assert 1 <= rows <= h
            bounds = TMV.run_bounds(h, rows)
            assert bounds[0][0] == 0 and bounds[-1][1] == h
            assert all(a1 == b0 for (_, a1), (b0, _)
                       in zip(bounds, bounds[1:]))
            assert all(0 < r1 - r0 <= rows for r0, r1 in bounds)
            # what the C entry launches: ceil(h / rows) runs
            assert len(bounds) == -(-h // rows)


def test_matvec_run_length_fills_the_card():
    """The main path's shape on an H100: 8 strips x 4 images x 12 runs of 48
    rows, one wave at `BLOCKS_PER_SM` blocks an SM."""
    rows = TMV.run_rows(576, 1024, 4, H100_SMS)
    assert rows == 48
    blocks = 8 * 4 * len(TMV.run_bounds(576, rows))
    assert blocks <= TMV.BLOCKS_PER_SM * H100_SMS
    # one wave at every shape the card can hold in one, and not far under it
    for b, h, w in [(1, 576, 1024), (1, 720, 1280), (4, 720, 1280),
                    (2, 768, 1024), (8, 576, 1024), (3, 400, 1000)]:
        strips = -(-w // TMV.STRIP)
        blocks = strips * b * len(TMV.run_bounds(
            h, TMV.run_rows(h, w, b, H100_SMS)))
        assert 0.6 * TMV.BLOCKS_PER_SM * H100_SMS < blocks \
            <= TMV.BLOCKS_PER_SM * H100_SMS, (b, h, w, blocks)
    # a small card or a large batch: never shorter than MIN_RUN_ROWS
    assert TMV.run_rows(576, 1024, 64, 16) == 576
    assert TMV.run_rows(576, 1024, 1, 1000) == TMV.MIN_RUN_ROWS
    assert TMV.run_rows(5, 1024, 1, 1000) == 5


def test_micro_matvec_runs_at_a_given_shape_on_the_cpu(capsys):
    """The variant bench takes H and W: on the CPU every wrapper takes its
    plain version, so each form stays within the drift bound."""
    from image_segmenter_tpu_torch.bench import micro_matvec

    micro_matvec.main(["micro_matvec", "cpu", "9", "12"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 8 and all("x9x12" in ln for ln in lines)
    for row in micro_matvec.run("cpu", b=1, h=9, w=12, inner=3):
        assert row["drift"] < 1e-5


def test_matvec_wrapper_takes_the_plain_version_on_the_cpu():
    planes, img, p = _matvec_operands(15, 1, 9, 12)
    before = TMV.LAUNCHES
    assert torch.equal(TMV.matvec_planes(planes, img, p),
                       TMV.matvec_planes_plain(planes, img, p))
    assert TMV.LAUNCHES == before
    with pytest.raises(ValueError):
        TMV.matvec_planes(planes, img, p[:, :5])


def test_wrapper_and_kernel_agree_on_the_strip_width():
    """`run_rows` counts strips of `STRIP` columns; csrc/matvec.cu walks
    strips of SW."""
    import re
    from image_segmenter_tpu_torch.kernels import _build

    src = (_build.CSRC / "matvec.cu").read_text()
    assert int(re.search(r"constexpr int SW = (\d+);", src).group(1)) \
        == TMV.STRIP


def test_c_entries_take_what_their_signatures_say():
    """ctypes checks nothing: each `extern "C"` entry of csrc/ must have as
    many parameters as its row in `_build.SIGNATURES`, pointers where the
    row has pointers."""
    import ctypes
    import re
    from image_segmenter_tpu_torch.kernels import _build

    found = {}
    for src in _build.CSRC.glob("*.cu"):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       src.read_text()):
            found[name] = [" ".join(q.split()) for q in params.split(",")]
    assert set(found) == set(_build.SIGNATURES)
    kinds = {ctypes.c_void_p: "*", ctypes.c_int64: "int64_t ",
             ctypes.c_int: "int ", ctypes.c_float: "float "}
    for name, argtypes in _build.SIGNATURES.items():
        assert len(found[name]) == len(argtypes), name
        for param, argtype in zip(found[name], argtypes):
            assert kinds[argtype] in param, (name, param)
            assert ("*" in param) == (argtype is ctypes.c_void_p), (name, param)


# ---------------------------------------------------------------------------
# the JAX side, unchanged
# ---------------------------------------------------------------------------

def test_matvec_plain_matches_pallas_tiled_at_another_ragged_shape():
    """max|diff| / max|ref| < 1e-5, the bound of tests/test_torch_matting.py,
    on uniform-random images as there."""
    h, w = 41, 77
    rng = np.random.default_rng(21)
    img = rng.random((h, w, 3)).astype(np.float32)
    p = rng.standard_normal((h, w)).astype(np.float32)
    img_t = torch.from_numpy(img).permute(2, 0, 1)[None].contiguous()
    planes = TP.precompute_planes(img_t, 1e-7)
    got = TMV.matvec_planes_plain(planes, img_t, torch.from_numpy(p)[None])[0]
    pl = planes[0].numpy()
    stack = build_matvec_stack(jnp.asarray(img), jnp.asarray(pl[7]),
                               jnp.asarray(np.moveaxis(pl[8:11], 0, -1)),
                               jnp.asarray(np.moveaxis(pl[0:6], 0, -1)))
    tiled = np.asarray(matvec_planes_tiled(tile_stack(stack), jnp.asarray(p)))
    scale = np.abs(tiled).max() + 1e-9
    assert np.abs(got.numpy() - tiled).max() / scale < 1e-5


@pytest.mark.parametrize("kind", ["whole", "fractional"])
def test_quantize_plain_matches_pallas_at_another_ragged_shape(kind):
    """Bit-exact, as in tests/test_torch_kmeans.py, for both kinds of
    palette the card's kernel tells apart."""
    b, h, w, k_max, k_real = 2, 45, 67, 16, 13
    rng = np.random.default_rng(22)
    rgb = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    alpha = (rng.random((b, h, w)) > 0.3).astype(np.uint8) * 255
    pal = rng.integers(0, 256, (b, k_max, 3)).astype(np.float32)
    if kind == "fractional":
        pal = (pal + rng.random(pal.shape)).astype(np.float32)
    pal[:, 6] = pal[:, 2]
    rgb[:, 0, 0] = pal[:, 2].astype(np.uint8)
    thr = np.array([30.0, -1.0], np.float32)
    assert bool(TQ.whole_number_palette(torch.from_numpy(pal), k_real).all()) \
        is (kind == "whole")
    got = TQ.quantize_map_plain(torch.from_numpy(rgb), torch.from_numpy(alpha),
                                torch.from_numpy(pal), k_real,
                                torch.from_numpy(thr)).numpy()
    for i in range(b):
        ref = np.asarray(jquant(jnp.asarray(rgb[i]), jnp.asarray(alpha[i]),
                                jnp.asarray(pal[i]), jnp.int32(k_real),
                                jnp.float32(thr[i]), k_max=k_max))
        np.testing.assert_array_equal(got[i], ref)
