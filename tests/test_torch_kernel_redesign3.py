"""CPU checks of what the redesigned K6 and K7 kernels rest on.

The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py).
Here, on the CPU:
- K6's walk: L @ p computed strip by strip and run by run, with the rows
  and columns the kernel stages (zeros past the planes' edge), the
  wrapper's run length and the plain version's order of every sum, equals
  the plain version bit for bit, also on a `valid` plane with holes and a
  ragged border; the plain version equals the JAX package's Pallas kernel
  in interpret mode on such a plane;
- K7's pixel packing and integer key: a numpy twin of the kernel's
  __byte_perm packing, its dp4a keys and its scatter back into planes
  gives the plain version's bytes on whole-number palettes, and uses the
  kernel's own selectors;
- the two grids: K7's blocks for each image, K6's run length.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from image_segmenter_tpu.kernels import pallas_matting as JK6
from image_segmenter_tpu.solvers import matting as JMAT
from image_segmenter_tpu_torch.kernels import _build
from image_segmenter_tpu_torch.kernels import matting as K6
from image_segmenter_tpu_torch.kernels import precompute as KP
from image_segmenter_tpu_torch.kernels import quantize as K4
from image_segmenter_tpu_torch.kernels import quantize_flat as K7

torch.set_num_threads(2)

H100_SMS = 132
_SHIFTS = [(dy, dx) for dy in range(3) for dx in range(3)]


# ---------------------------------------------------------------------------
# K6: strips and runs
# ---------------------------------------------------------------------------

def matvec_recompute_strips(p_pad, static, strip, rows):
    """K6 as csrc/matvec_recompute.cu walks it: per image, per strip of
    `strip` output columns and per run of `rows` output rows, from the rows
    and columns the kernel stages (valid, p and the image at halo 2, the
    factors at the window centres; zeros past column Wp and row Hp) and
    nothing else, every sum over the nine shifts row-major from 0."""
    b, hp, wp = p_pad.shape
    ho = K6._out_rows(hp)
    strips = -(-wp // strip)
    pad = (0, strips * strip + 4 - wp, 0, ho + 4 - hp)
    data = torch.nn.functional.pad(
        torch.stack([static[:, 0], p_pad, static[:, 1], static[:, 2],
                     static[:, 3]], 1), pad)          # padded coordinates
    fac = torch.nn.functional.pad(static[:, 4:10], pad)
    out = torch.full((b, ho, wp), float("nan"))
    for x0 in range(0, wp, strip):
        for r0, r1 in K6.run_bounds(ho, rows):
            # centres: padded rows r0 + 1 .. r1 + 2, columns x0 + 1 ..
            # x0 + strip + 2; their windows: rows r0 .. r1 + 3, columns
            # x0 .. x0 + strip + 3
            hc, wc = r1 - r0 + 2, strip + 2
            v, p, r, g, bl = data[:, :, r0:r1 + 4, x0:x0 + strip + 4].unbind(1)
            vp = v * p

            def sh(x, dy, dx):
                return x[..., dy:dy + hc, dx:dx + wc]

            n = torch.zeros((b, hc, wc))
            m = [torch.zeros((b, hc, wc)) for _ in range(3)]
            ps = torch.zeros((b, hc, wc))
            for dy, dx in _SHIFTS:
                vs = sh(v, dy, dx)
                n = n + vs
                for c, img in enumerate((r, g, bl)):
                    m[c] = m[c] + vs * sh(img, dy, dx)
                ps = ps + sh(vp, dy, dx)
            ninv = 1.0 / torch.clamp_min(n, 1.0)
            mu = [mc * ninv for mc in m]
            pbar = ps * ninv
            cov = [torch.zeros((b, hc, wc)) for _ in range(3)]
            for dy, dx in _SHIFTS:
                for c, img in enumerate((r, g, bl)):
                    cov[c] = cov[c] + (sh(img, dy, dx) - mu[c]) * sh(vp, dy, dx)
            i1, i2, i3, l21, l31, l32 = fac[:, :, r0 + 1:r1 + 3,
                                            x0 + 1:x0 + strip + 3].unbind(1)
            bq = l21 * l32 - l31
            k0, k1, k2 = (cv * ninv for cv in cov)
            t1 = k1 - l21 * k0
            t2 = bq * k0 - l32 * k1 + k2
            w0, w1, w2 = i1 * k0, i2 * t1, i3 * t2
            a0 = w0 - l21 * w1 + bq * w2
            a1 = w1 - l32 * w2
            a2 = w2
            bsc = pbar - ((a0 * mu[0] + a1 * mu[1]) + a2 * mu[2])
            vc = sh(v, 1, 1)
            ab = torch.stack([a0 * vc, a1 * vc, a2 * vc, bsc * vc], 1)
            # output rows r0 .. r1 - 1 at padded rows + 2, columns x0 ..
            ny = r1 - r0
            box = torch.zeros((b, 4, ny, strip))
            for dy, dx in _SHIFTS:
                box = box + ab[..., dy:dy + ny, dx:dx + strip]
            pix = (slice(None), slice(2, 2 + ny), slice(2, 2 + strip))
            acc = box[:, 3]
            for c, img in enumerate((r, g, bl)):
                acc = acc + box[:, c] * img[pix]
            q = n[:, 1:1 + ny, 1:1 + strip] * p[pix] - acc
            cols = torch.arange(x0, x0 + strip)
            q = torch.where(cols < wp - 4, q, torch.zeros(()))
            x1 = min(x0 + strip, wp)
            out[:, r0:r1, x0:x1] = q[..., :x1 - x0]
    return out


def _valid_with_holes(rng, b, h, w):
    """1 inside the image but for scattered holes, a hole of a few rows
    and columns, and a ragged right and bottom border."""
    valid = (rng.random((b, h, w)) > 0.1).astype(np.float32)
    valid[:, h // 3:h // 3 + 3, w // 4:w // 4 + 5] = 0.0
    for i in range(h):
        valid[:, i, w - rng.integers(0, min(w, 4) + 1):] = 0.0
    for j in range(w):
        valid[:, h - rng.integers(0, min(h, 3) + 1):, j] = 0.0
    return valid


def _k6_operands(seed, b, h, w, masked):
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.random((b, 3, h, w), dtype=np.float32))
    p = torch.from_numpy(rng.standard_normal((b, h, w)).astype(np.float32))
    planes = KP.precompute_planes(img, 1e-7)
    valid = torch.from_numpy(_valid_with_holes(rng, b, h, w)) if masked \
        else torch.ones((b, h, w))
    return K6.pad_p(p), K6.pack_static(valid, img, planes[:, 0:6])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bhw", [(1, 576, 1024), (2, 37, 53), (1, 203, 389),
                                 (1, 1, 1), (3, 64, 96), (1, 16, 124)])
def test_k6_strip_walk_equals_plain_bit_for_bit(bhw, masked):
    """The wrapper's strip width and its run length for an H100, at the
    bench shape (one image), ragged shapes and one pixel."""
    b, h, w = bhw
    p_pad, static = _k6_operands(31, b, h, w, masked)
    ref = K6.matvec_planes_plain(p_pad, static)
    ho, wp = ref.shape[1:]
    rows = K6.run_rows(ho, wp, b, H100_SMS)
    got = matvec_recompute_strips(p_pad, static, K6.STRIP, rows)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("rows", [1, 2, 3, 5])
@pytest.mark.parametrize("bhw", [(2, 23, 150), (1, 40, 260)])
def test_k6_strip_walk_short_runs(bhw, rows):
    """Runs shorter than the four rows they re-read: each run stands
    alone, on a masked `valid`."""
    p_pad, static = _k6_operands(32, *bhw, masked=True)
    assert torch.equal(matvec_recompute_strips(p_pad, static, K6.STRIP, rows),
                       K6.matvec_planes_plain(p_pad, static))


@pytest.mark.parametrize("hw", [(37, 53), (45, 130)])
def test_k6_plain_matches_pallas_on_a_masked_valid(hw):
    """Plain K6 against the interpret-mode Pallas kernel on a `valid` plane
    with holes and a ragged border: within 1e-6 of max|ref| over the whole
    output, as tests/test_torch_matvec_variants.py holds it on a full
    plane."""
    h, w = hw
    rng = np.random.default_rng(33)
    img = rng.random((h, w, 3)).astype(np.float32)
    p = rng.standard_normal((h, w)).astype(np.float32)
    valid = _valid_with_holes(rng, 1, h, w)[0]
    pre = JMAT._precompute(jnp.asarray(img), 1e-7, 1, half_stats=True)
    st_j = JK6.pack_static(jnp.asarray(valid), jnp.asarray(img), pre.dinv)
    pp_j = JK6.pad_p(jnp.asarray(p))
    pallas = np.asarray(JK6.matvec_planes(pp_j, st_j))
    chw = lambda x: torch.from_numpy(np.array(x)).permute(2, 0, 1)  # noqa: E731
    st_t = K6.pack_static(torch.from_numpy(valid), chw(img), chw(pre.dinv))
    pp_t = K6.pad_p(torch.from_numpy(p))
    np.testing.assert_array_equal(st_t.numpy(), np.asarray(st_j))
    got = K6.matvec_planes(pp_t, st_t).numpy()
    assert got.shape == pallas.shape
    scale = np.abs(pallas).max() + 1e-9
    assert np.abs(got - pallas).max() / scale < 1e-6


def test_k6_runs_tile_the_rows():
    for b in (1, 4):
        for hp in range(5, 700, 7):
            ho = K6._out_rows(hp)
            for wp in (128, 1152):
                rows = K6.run_rows(ho, wp, b, H100_SMS)
                bounds = K6.run_bounds(ho, rows)
                assert bounds[0][0] == 0 and bounds[-1][1] == ho
                assert all(a1 == b0 for (_, a1), (b0, _)
                           in zip(bounds, bounds[1:]))
                assert all(0 < r1 - r0 <= rows for r0, r1 in bounds)
                assert len(bounds) == -(-ho // rows)   # what the C entry runs


def test_k6_run_length_fills_the_card_in_one_wave():
    """The bench shape on an H100: 9 strips x 4 images x the runs, within
    one wave of `BLOCKS_PER_SM` blocks an SM and not far under it."""
    for b, hp, wp in [(4, 580, 1152), (1, 580, 1152), (2, 772, 1152),
                      (4, 724, 1408), (8, 580, 1152)]:
        ho = K6._out_rows(hp)
        strips = -(-wp // K6.STRIP)
        blocks = strips * b * len(K6.run_bounds(
            ho, K6.run_rows(ho, wp, b, H100_SMS)))
        assert 0.6 * K6.BLOCKS_PER_SM * H100_SMS < blocks \
            <= K6.BLOCKS_PER_SM * H100_SMS, (b, hp, wp, blocks)
    # a small card or a large batch: one run; never shorter than the floor
    assert K6.run_rows(576, 1152, 64, 16) == 576
    assert K6.run_rows(576, 1152, 1, 10000) == K6.MIN_RUN_ROWS
    assert K6.run_rows(32, 128, 1, 10000) == K6.MIN_RUN_ROWS


def test_k6_wrapper_and_kernel_agree_on_the_strip_width():
    src = (_build.CSRC / "matvec_recompute.cu").read_text()
    assert int(re.search(r"constexpr int SW = (\d+);", src).group(1)) \
        == K6.STRIP


def test_k6_wrapper_takes_the_plain_version_on_the_cpu():
    p_pad, static = _k6_operands(34, 2, 9, 12, masked=True)
    before = K6.LAUNCHES
    assert torch.equal(K6.matvec_planes(p_pad, static),
                       K6.matvec_planes_plain(p_pad, static))
    assert K6.LAUNCHES == before


# ---------------------------------------------------------------------------
# K7: the packing, the integer key and the scatter back
# ---------------------------------------------------------------------------

# the kernel's selectors, in the order pack4 and unpack4 use them
PACK_SEL = (0x5140, 0x7362, 0x0410, 0x0532, 0x0610, 0x0732)
UNPACK_SEL = (0x5140, 0x5140, 0x5410, 0x7632, 0x7362, 0x7362, 0x5410)


def byte_perm(x, y, s):
    """CUDA's __byte_perm on uint32 arrays: byte i of the result is byte
    (s >> 4 i) & 7 of the eight bytes x (0-3), y (4-7)."""
    x = np.asarray(x, np.uint64)
    y = np.asarray(y, np.uint64)
    both = x | (y << np.uint64(32))
    out = np.zeros(np.broadcast(x, y).shape, np.uint64)
    for i in range(4):
        sel = (s >> (4 * i)) & 7
        out |= ((both >> np.uint64(8 * sel)) & np.uint64(0xFF)) \
            << np.uint64(8 * i)
    return out.astype(np.uint32)


def dp4a(a, b):
    """Unsigned __dp4a(a, b, 0): the sum of the products of the four byte
    pairs."""
    a = np.asarray(a, np.uint32)
    b = np.asarray(b, np.uint32)
    return sum(((a >> (8 * i)) & 0xFF).astype(np.int64)
               * ((b >> (8 * i)) & 0xFF).astype(np.int64) for i in range(4))


def pack4(r, g, b):
    """Words of the r, g and b planes (4 pixels each) -> 4 packed pixels."""
    lo = byte_perm(r, g, PACK_SEL[0])
    hi = byte_perm(r, g, PACK_SEL[1])
    return [byte_perm(lo, b, PACK_SEL[2]), byte_perm(lo, b, PACK_SEL[3]),
            byte_perm(hi, b, PACK_SEL[4]), byte_perm(hi, b, PACK_SEL[5])]


def unpack4(c):
    """4 colours r | g << 8 | b << 16 -> one word of each output plane."""
    lo = byte_perm(c[0], c[1], UNPACK_SEL[0])
    hi = byte_perm(c[2], c[3], UNPACK_SEL[1])
    blo = byte_perm(c[0], c[1], UNPACK_SEL[4])
    bhi = byte_perm(c[2], c[3], UNPACK_SEL[5])
    return (byte_perm(lo, hi, UNPACK_SEL[2]), byte_perm(lo, hi, UNPACK_SEL[3]),
            byte_perm(blo, bhi, UNPACK_SEL[6]))


def quantize_planes_twin(planes, alpha, pal, k_real, thr):
    """csrc/quantize_flat.cu's 16-byte path on a whole-number palette, in
    numpy: planes (3, B, N) u8 with N % 16 == 0, alpha (B, N) u8, pal
    (B, k_max, 3) float32 whole numbers in [0, 255], thr (B,) float32."""
    _, nb, n = planes.shape
    k_use = max(0, min(pal.shape[1], k_real))
    words = planes.reshape(3, nb, n // 4, 4).view(np.uint32)[..., 0]
    awords = alpha.reshape(nb, n // 4, 4).view(np.uint32)[..., 0]
    out = np.empty_like(words)
    for i in range(nb):
        c = pal[i, :k_use].astype(np.int64)
        entry = (c[:, 0] | (c[:, 1] << 8) | (c[:, 2] << 16)).astype(np.uint32)
        ck = ((c * c).sum(1) << 8) | np.arange(k_use)
        colour = np.zeros(257, np.uint32)     # the table stage_palette fills
        colour[:k_use] = entry
        wr, wg, wb = words[0, i], words[1, i], words[2, i]
        cols = []
        for j, pix in enumerate(pack4(wr.reshape(-1, 4), wg.reshape(-1, 4),
                                      wb.reshape(-1, 4))):
            best = np.full(pix.shape, 2 ** 31 - 1, np.int64)
            for k in range(k_use):
                key = ck[k] - 512 * dp4a(pix, entry[k])
                assert np.abs(key).max() < 2 ** 31        # int32 in the kernel
                best = np.minimum(best, key)
            idx = best & 0xFF
            bright = dp4a(pix, 0x00010101).astype(np.float32) \
                * np.float32(1.0 / 3.0)
            a = (awords[i].reshape(-1, 4) >> np.uint32(8 * j)) & 0xFF
            fit = (a != 0) & (bright > thr[i])
            cols.append(np.where(fit, colour[idx], 0).astype(np.uint32))
        # word w of a 16-pixel step holds pixels 4 w .. 4 w + 3
        for w in range(4):
            got = unpack4([cols[j][:, w] for j in range(4)])
            for q in range(3):
                out[q, i].reshape(-1, 4)[:, w] = got[q]
    return out.view(np.uint8).reshape(3, nb, n)


def _planes_case(seed, b, n, k_max):
    rng = np.random.default_rng(seed)
    planes = rng.integers(0, 256, (3, b, n), dtype=np.uint8)
    alpha = ((rng.random((b, n)) > 0.3) * rng.integers(1, 256, (b, n))
             ).astype(np.uint8)
    pal = rng.integers(0, 256, (b, k_max, 3)).astype(np.float32)
    if k_max >= 6:
        pal[:, 5] = pal[:, 2]                  # exact ties: index 2 must win
        # two entries mirrored around a pixel: equal distances, other colours
        px = planes[:, :, 0].T.astype(np.float32)      # (b, 3)
        pal[:, 3] = np.clip(px + [3, -2, 1], 0, 255)
        pal[:, 4] = np.where(((2 * px - pal[:, 3]) >= 0)
                             & ((2 * px - pal[:, 3]) <= 255),
                             2 * px - pal[:, 3], pal[:, 3])
        planes[:, :, 1] = pal[:, 2].T.astype(np.uint8)  # distance 0 to 2, 5
    thr = rng.choice([-1.0, 10.0, 30.0, 200.0], b).astype(np.float32)
    return planes, alpha, pal, thr


def _plain(planes, alpha, pal, k_real, thr):
    return K7.quantize_planes_plain(
        torch.from_numpy(planes), torch.from_numpy(alpha),
        torch.from_numpy(pal), k_real, torch.from_numpy(thr)).numpy()


@pytest.mark.parametrize("k_real", [0, 1, 11, 16])
def test_k7_twin_equals_plain_on_whole_number_palettes(k_real):
    planes, alpha, pal, thr = _planes_case(41, 3, 16 * 40, 16)
    assert bool(K4.whole_number_palette(torch.from_numpy(pal), k_real).all())
    np.testing.assert_array_equal(
        quantize_planes_twin(planes, alpha, pal, k_real, thr),
        _plain(planes, alpha, pal, k_real, thr))


def test_k7_twin_256_entries_and_extremes():
    """The largest palette the kernel stages, with black and white pixels
    and entries: the largest and smallest keys."""
    planes, alpha, pal, thr = _planes_case(42, 2, 16 * 24, 256)
    planes[:, :, :16] = 0
    planes[:, :, 16:32] = 255
    pal[:, 100] = 0.0
    pal[:, 200] = 255.0
    np.testing.assert_array_equal(
        quantize_planes_twin(planes, alpha, pal, 256, thr),
        _plain(planes, alpha, pal, 256, thr))


@settings(max_examples=40, derandomize=True, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), words=st.integers(1, 12),
       k=st.integers(1, 16))
def test_k7_twin_random_cases(seed, words, k):
    planes, alpha, pal, thr = _planes_case(seed, 2, 16 * words, 16)
    np.testing.assert_array_equal(
        quantize_planes_twin(planes, alpha, pal, k, thr),
        _plain(planes, alpha, pal, k, thr))


def test_k7_packing_round_trips():
    """Each packed pixel holds its own r, g, b in bytes 0-2; unpacking the
    packed pixels gives back the planes' words."""
    rng = np.random.default_rng(43)
    r, g, b = (rng.integers(0, 2 ** 32, 1000, dtype=np.uint64).astype(np.uint32)
               for _ in range(3))
    pix = pack4(r, g, b)
    for j in range(4):
        s = np.uint32(8 * j)
        for q, plane in enumerate((r, g, b)):
            np.testing.assert_array_equal((pix[j] >> np.uint32(8 * q)) & 0xFF,
                                          (plane >> s) & 0xFF)
    back = unpack4([p & 0x00FFFFFF for p in pix])
    for got, want in zip(back, (r, g, b)):
        np.testing.assert_array_equal(got, want)


def test_k7_twin_uses_the_kernels_selectors():
    src = (_build.CSRC / "quantize_flat.cu").read_text()

    def selectors(fn):
        body = src[src.index(f"void {fn}("):]
        body = body[:body.index("\n}\n")]
        return tuple(int(s, 16) for s in re.findall(
            r"__byte_perm\([^;]*?(0x[0-9A-Fa-f]{4})\)", body))

    assert selectors("pack4") == PACK_SEL
    assert selectors("unpack4") == UNPACK_SEL
    assert int(re.search(r"constexpr int kThreads = (\d+);", src).group(1)) \
        == K7.THREADS


def test_k7_grid_blocks():
    """K4's rule: a thread for every 16 pixels, at most `BLOCKS_PER_SM`
    blocks for each SM over the batch, at least one block an image."""
    # the bench shape: 8,294,400 pixels an image, 4 images, 132 SMs
    assert K7.grid_blocks(2160 * 3840, 4, H100_SMS) == 528
    assert K7.grid_blocks(2160 * 3840, 1, H100_SMS) == 2025
    for n in (0, 1, 15, 16, 1961, 4096, 4097, 2400, 10 ** 6, 8294400):
        for b in (1, 2, 3, 4, 7, 64, 5000):
            blocks = K7.grid_blocks(n, b, H100_SMS)
            need = max(1, -(-n // (K7.THREADS * K7.PIXELS)))
            # never more blocks than the 16-pixel words need, at least one
            assert 1 <= blocks <= need
            # the batch's grid within the cap, rounded up to whole images
            assert b * (blocks - 1) < K7.BLOCKS_PER_SM * H100_SMS
            # fewer than needed only where the cap fills the card
            if blocks < need:
                assert b * blocks >= K7.BLOCKS_PER_SM * H100_SMS


def test_k7_wrapper_takes_the_plain_version_on_the_cpu():
    planes, alpha, pal, thr = _planes_case(44, 2, 16 * 5 + 3, 16)
    before = K7.LAUNCHES
    got = K7.quantize_planes(torch.from_numpy(planes), torch.from_numpy(alpha),
                             torch.from_numpy(pal), 11, torch.from_numpy(thr))
    assert K7.LAUNCHES == before
    np.testing.assert_array_equal(got.numpy(),
                                  _plain(planes, alpha, pal, 11, thr))


# ---------------------------------------------------------------------------
# the sweep's variants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag", sorted(
    __import__("image_segmenter_tpu_torch.bench.sweep_k6_k7",
               fromlist=["variants"]).variants()))
def test_sweep_variants_change_one_constant(tag):
    """Every variant of bench/sweep_k6_k7.py finds its constants in the
    kernel's source, and the variant at the kernel's own values is the
    source itself."""
    from image_segmenter_tpu_torch.bench import sweep_k6_k7 as S

    name, consts = S.variants()[tag]
    src = S.variant_source(name, **consts)
    for key, value in consts.items():
        assert f"constexpr int {key} = {value};" in src
    own = {key: int(re.search(rf"constexpr int {key} = (\d+);",
                              (_build.CSRC / name).read_text()).group(1))
           for key in consts}
    assert S.variant_source(name, **own) == (_build.CSRC / name).read_text()
    with pytest.raises(ValueError):
        S.variant_source(name, kNoSuchConstant=1)
