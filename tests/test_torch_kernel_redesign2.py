"""CPU checks of what the redesigned K2 and K1 kernels rest on.

The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py).
Here, on the CPU:
- K2's walk: the planes computed strip by strip and run by run as
  csrc/precompute.cu computes them (the count and the masks from the
  window's position, the members centred once, pass C on pass B's
  residuals without the mask factor, each diag term formed at its window
  and summed at its pixel in three groups of three) equal the plain version
  bit for bit, and the wrapper's runs tile the rows within one wave;
- K1's walk: the kernel's unaligned head, 16-byte pieces with a grid stride
  and tail, counted into a table per warp and folded block by block, meet
  every byte once and equal `hist256_plain` and np.bincount on random,
  all-equal, alpha-like, unaligned and empty rows; and the wrapper's grid
  rule;
- the plain versions against the JAX package on the same seeded inputs
  (the Pallas precompute in interpret mode, 1e-4 abs or rel; the JAX
  histogram, exact), and `u8_quantile` taking several q from one histogram.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from image_segmenter_tpu.kernels.pallas_precompute import (
    precompute_planes as jax_precompute)
from image_segmenter_tpu.ops import histogram as JHG
from image_segmenter_tpu_torch.bench import micro_precompute_hist as BENCH
from image_segmenter_tpu_torch.kernels import histogram as TH
from image_segmenter_tpu_torch.kernels import precompute as TP
from image_segmenter_tpu_torch.ops import histogram as THG

torch.set_num_threads(2)

H100_SMS = 132
DELTA = 1e-5


# ---------------------------------------------------------------------------
# K2: the walk of csrc/precompute.cu
# ---------------------------------------------------------------------------

def precompute_planes_walk(img, eps, strip, rows):
    """(B, 3, H, W) -> (B, 12, H, W) as the kernel computes it: per strip
    of `strip` output columns and run of `rows` output rows, on the centre
    grid one wider on every side, from the image with a halo of 2 (zeros
    outside) and nothing else."""
    b, _, h, w = img.shape
    f32 = torch.float32
    ip = torch.nn.functional.pad(img, (2, 2, 2, 2))       # index + 2
    out = torch.full((b, 12, h, w), float("nan"))
    for x0 in range(0, w, strip):
        x1 = min(x0 + strip, w)
        for r0 in range(0, h, rows):
            r1 = min(r0 + rows, h)
            hc, wc = r1 - r0 + 2, x1 - x0 + 2      # centre grid
            cy = torch.arange(r0 - 1, r1 + 1)[:, None]
            cx = torch.arange(x0 - 1, x1 + 1)[None, :]
            exists = (cy >= 0) & (cy < h) & (cx >= 0) & (cx < w)
            # the window's members, row-major: (my, mx) at j = 3 (my+1) + mx+1
            wins, vs = [], []
            for my in (-1, 0, 1):
                for mx in (-1, 0, 1):
                    wins.append(ip[:, :, r0 + 1 + my:r0 + 1 + my + hc,
                                   x0 + 1 + mx:x0 + 1 + mx + wc])
                    vrow = ((cy + my >= 0) & (cy + my < h)).to(f32)
                    vcol = ((cx + mx >= 0) & (cx + mx < w)).to(f32)
                    vs.append(vrow * vcol)
            ny = (cy - 1 >= 0).int() + 1 + (cy + 1 < h).int()
            nx = (cx - 1 >= 0).int() + 1 + (cx + 1 < w).int()
            n = (ny * nx).to(f32).expand(hc, wc)
            t = [(wins[3 * r] + wins[3 * r + 1]) + wins[3 * r + 2]
                 for r in range(3)]
            mu = ((t[0] + t[1]) + t[2]) / n
            d = [(wins[j] - mu) * vs[j] for j in range(9)]   # (B, 3, hc, wc)
            zero = torch.zeros((b, hc, wc))
            a00 = a01 = a02 = a11 = a22 = zero
            for j in range(9):
                d0, d1, d2 = d[j][:, 0], d[j][:, 1], d[j][:, 2]
                a00 = a00 + d0 * d0
                a01 = a01 + d0 * d1
                a02 = a02 + d0 * d2
                a11 = a11 + d1 * d1
                a22 = a22 + d2 * d2
            tr = (a00 + a11) + a22
            eps_w = torch.clamp_min(DELTA * tr, eps)
            p1 = a00 + eps_w
            l21 = a01 / p1
            l31 = a02 / p1
            q22 = q23 = zero
            r2, r3 = [], []
            for j in range(9):
                r2.append(d[j][:, 1] - l21 * d[j][:, 0])
                r3.append(d[j][:, 2] - l31 * d[j][:, 0])
                q22 = q22 + r2[j] * r2[j]
                q23 = q23 + r2[j] * r3[j]
            p2 = q22 + eps_w * (1.0 + l21 * l21)
            l32 = (q23 + eps_w * l21 * l31) / p2
            q3 = zero
            for j in range(9):
                rr = r3[j] - l32 * r2[j]
                q3 = q3 + rr * rr
            bq = l21 * l32 - l31
            p3 = q3 + eps_w * ((bq * bq + l32 * l32) + 1.0)
            rankdef = ((q3 < DELTA * tr) & (tr > 1e-4)).to(f32)
            i1, i2, i3 = n / p1, n / p2, n / p3
            v00 = i1 + l21 * l21 * i2 + bq * bq * i3
            v01 = -l21 * i2 - bq * l32 * i3
            v02 = bq * i3
            v11 = i2 + l32 * l32 * i3
            v12 = -l32 * i3
            v22 = i3
            n_div = torch.clamp_min(n, 1.0)
            g = []
            for j in range(9):
                e0, e1, e2 = d[j][:, 0], d[j][:, 1], d[j][:, 2]
                quad = (v00 * e0 * e0 + v11 * e1 * e1 + v22 * e2 * e2
                        + 2.0 * (v01 * e0 * e1 + v02 * e0 * e2 + v12 * e1 * e2))
                # windows centred outside the image give 0
                g.append(torch.where(exists, (1.0 + quad) / n_div, zero))
            ho, wo = hc - 2, wc - 2

            def at(x, dy, dx):   # x at centre (y + dy, x + dx) per output pixel
                return x[..., 1 + dy:1 + dy + ho, 1 + dx:1 + dx + wo]

            s0 = (at(g[8], -1, -1) + at(g[7], -1, 0)) + at(g[6], -1, 1)
            s1 = ((s0 + at(g[5], 0, -1)) + at(g[4], 0, 0)) + at(g[3], 0, 1)
            closed = ((s1 + at(g[2], 1, -1)) + at(g[1], 1, 0)) + at(g[0], 1, 1)
            diag = at(n, 0, 0) - closed
            planes = [i1, i2, i3, l21, l31, l32, None, n.expand(b, hc, wc),
                      mu[:, 0], mu[:, 1], mu[:, 2], rankdef]
            for k, pl in enumerate(planes):
                out[:, k, r0:r1, x0:x1] = diag if pl is None else at(pl, 0, 0)
    return out


def _image(seed, b, h, w, kind="random"):
    rng = np.random.default_rng(seed)
    if kind == "near-singular":   # a flat colour plus 1e-4 noise
        img = np.float32([0.3, 0.6, 0.45])[None, :, None, None] \
            + 1e-4 * rng.standard_normal((b, 3, h, w)).astype(np.float32)
    elif kind == "flat":          # exactly rank-deficient windows
        img = np.broadcast_to(np.float32([0.2, 0.5, 0.7])[None, :, None, None],
                              (b, 3, h, w)).copy()
        img[:, :, : h // 2] += 0.25 * rng.random((b, 1, h // 2, w),
                                                 dtype=np.float32)
    else:
        img = rng.random((b, 3, h, w), dtype=np.float32)
    return torch.from_numpy(np.ascontiguousarray(img, np.float32))


# a small batch, a ragged width (no multiple of 4, several strips), an
# image narrower than one strip, one of a single row and one of one pixel
WALK_SHAPES = [(4, 24, 40), (2, 37, 53), (1, 33, 131), (2, 19, 7), (1, 1, 64),
               (1, 1, 1)]


@pytest.mark.parametrize("kind", ["random", "near-singular", "flat"])
@pytest.mark.parametrize("bhw", WALK_SHAPES)
def test_precompute_walk_equals_plain_bit_for_bit(bhw, kind):
    """The kernel claims the plain version's bits: so must its twin, with
    the wrapper's strip width and its run length for an H100."""
    b, h, w = bhw
    img = _image(31, b, h, w, kind)
    ref = TP.precompute_planes_plain(img, 1e-7)
    rows = TP.run_rows(h, w, b, H100_SMS)
    got = precompute_planes_walk(img, 1e-7, TP.STRIP, rows)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("rows", [1, 2, 5])
@pytest.mark.parametrize("strip", [1, 3, 30])
def test_precompute_walk_short_runs_and_narrow_strips(strip, rows):
    """Runs and strips no larger than the halo they recompute: each stands
    alone."""
    img = _image(32, 2, 11, 35)
    ref = TP.precompute_planes_plain(img, 1e-6)
    assert torch.equal(precompute_planes_walk(img, 1e-6, strip, rows), ref)


def test_precompute_walk_within_stated_bound_of_plain():
    """The contract of the card's check: every entry within 1e-4, absolute
    or relative (here the error is 0)."""
    img = _image(33, 4, 24, 40, "near-singular")
    ref = TP.precompute_planes_plain(img, 1e-7)
    got = precompute_planes_walk(img, 1e-7, TP.STRIP, 8)
    err = (got - ref).abs()
    assert float(torch.minimum(err, err / ref.abs().clamp_min(1e-30)).max()) \
        < 1e-4


@pytest.mark.parametrize("b", [1, 4])
def test_precompute_runs_tile_the_rows_within_one_wave(b):
    for w in (53, 576, 1024):
        strips = -(-w // TP.STRIP)
        for h in range(1, 1100, 7):
            rows = TP.run_rows(h, w, b, H100_SMS)
            assert 1 <= rows <= h
            runs = -(-h // rows)           # what the C entry launches
            if rows > TP.MIN_RUN_ROWS:
                assert b * strips * runs <= TP.WARPS_PER_SM * H100_SMS


def test_precompute_run_length_on_the_main_path():
    """4 x 576 x 1024 on an H100: 35 strips x 15 runs of 39 rows x 4 images,
    2,100 warps for 2,112 places."""
    assert TP.run_rows(576, 1024, 4, H100_SMS) == 39
    assert TP.run_rows(576, 1024, 64, 16) == 576
    assert TP.run_rows(576, 1024, 1, 1000) == TP.MIN_RUN_ROWS
    assert TP.run_rows(5, 1024, 1, 1000) == 5


def test_precompute_wrapper_and_kernel_agree_on_the_strip_width():
    import re
    from image_segmenter_tpu_torch.kernels import _build

    src = (_build.CSRC / "precompute.cu").read_text()
    assert int(re.search(r"constexpr int SW = (\d+);", src).group(1)) \
        == TP.STRIP
    warps = int(re.search(r"constexpr int kWarps = (\d+);", src).group(1))
    blocks = int(re.search(r"__launch_bounds__\(kThreads, (\d+)\)",
                           src).group(1))
    assert warps * blocks == TP.WARPS_PER_SM


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 9])
def test_shared_reciprocal_division_is_the_rounded_quotient(n):
    """csrc/precompute.cu divides by the window count n through one
    reciprocal (div_n): q = x rn, rem = fma(-q, n, x), q' = fma(rem, rn, q).
    q' is the float32 quotient x / n, which the twin above and the plain
    version compute; q alone is not (n = 3, 6, 9). The fused steps are taken
    in float64, where the products are exact."""
    rng = np.random.default_rng(36)
    x = np.concatenate([
        rng.random(400000, dtype=np.float32) * 9,                # box sums
        1 + rng.random(400000, dtype=np.float32) * 1e4,          # 1 + quad
        rng.integers(0, 2 ** 31 - 2 ** 24, 400000).astype(np.uint32)
        .view(np.float32)]).astype(np.float32)
    x = x[(np.abs(x) > 1e-30) & (np.abs(x) < 1e30)]
    nf = np.float32(n)
    rn = np.float32(1) / nf
    q = x * rn
    rem = (x.astype(np.float64) - q.astype(np.float64) * n).astype(np.float32)
    q2 = (q.astype(np.float64) + rem.astype(np.float64) * float(rn)) \
        .astype(np.float32)
    np.testing.assert_array_equal(q2, x / nf)
    assert (n in (1, 2, 4)) == bool((q == x / nf).all())


def test_precompute_wrapper_takes_the_plain_version_on_the_cpu():
    img = _image(34, 1, 9, 12)
    before = TP.LAUNCHES
    assert torch.equal(TP.precompute_planes(img, 1e-7),
                       TP.precompute_planes_plain(img, 1e-7))
    assert TP.LAUNCHES == before
    with pytest.raises(ValueError):
        TP.precompute_planes(img[:, :2], 1e-7)


@pytest.mark.parametrize("hw", [(24, 40), (19, 7), (21, 131)])
def test_precompute_plain_matches_pallas_interpret(hw):
    """The same seeded image through the JAX package's kernel (interpret
    mode on the CPU) and the port: 1e-4, absolute or relative."""
    h, w = hw
    rng = np.random.default_rng(35)
    img = rng.random((h, w, 3)).astype(np.float32)
    got = TP.precompute_planes(
        torch.from_numpy(img).permute(2, 0, 1)[None].contiguous(),
        1e-7)[0].numpy()
    ref = np.asarray(jax_precompute(jnp.asarray(img), 1e-7))
    err = np.abs(got - ref)
    assert float(np.minimum(err, err / np.maximum(np.abs(ref), 1e-30)).max()) \
        < 1e-4


# ---------------------------------------------------------------------------
# K1: the walk of csrc/histogram.cu
# ---------------------------------------------------------------------------

def hist_row_walk(row: np.ndarray, misalign: int, blocks: int):
    """One row counted as csrc/histogram.cu counts it with `blocks` blocks:
    every byte goes to the table of the warp whose thread meets it (an
    unaligned head byte by byte, then 16-byte pieces with a grid stride,
    then the tail), a block folds its warps' tables, the row's totals add
    the blocks'. `misalign` is the row's address mod 16. Returns (totals
    int64 (256,), tables int64 (blocks, warps, 256))."""
    n = len(row)
    warps = TH.THREADS // 32
    stride = blocks * TH.THREADS
    tables = np.zeros((blocks, warps, 256), np.int64)

    def count(idx, thread):   # byte positions idx met by global thread ids
        block, warp = thread // TH.THREADS, thread % TH.THREADS // 32
        np.add.at(tables, (block, warp, row[idx]), 1)

    head = min((16 - misalign) & 15, n)
    nvec = (n - head) // 16
    i = np.arange(head)
    count(i, i % stride)
    v = np.repeat(np.arange(nvec), 16)            # piece of every body byte
    count(head + np.arange(16 * nvec), v % stride)
    i = np.arange(head + 16 * nvec, n)
    count(i, (i - head - 16 * nvec) % stride)
    return tables.sum(axis=(0, 1)), tables


def _hist_cases():
    rng = np.random.default_rng(41)
    n = 70000
    run = rng.integers(0, 256, n, dtype=np.uint8)
    run[100:30000] = 7
    return {
        "random": rng.integers(0, 256, n, dtype=np.uint8),
        "all 0": np.zeros(n, np.uint8),
        "all 255": np.full(n, 255, np.uint8),
        "all 7": np.full(n, 7, np.uint8),
        "a run of 7": run,
        "alpha-like": BENCH.alpha_like(1, n, rng)[0],
        "shorter than a load": rng.integers(0, 256, 11, dtype=np.uint8),
        "one byte": np.array([200], np.uint8),
        "empty": np.zeros(0, np.uint8),
    }


@pytest.mark.parametrize("misalign", [0, 1, 13])
@pytest.mark.parametrize("name", list(_hist_cases()))
def test_hist_walk_is_exact(name, misalign):
    """Head, pieces and tail meet every byte once, whatever the alignment
    and the number of blocks; the float32 counts are the plain version's."""
    row = _hist_cases()[name]
    ref = np.bincount(row, minlength=256)
    for blocks in (1, TH.blocks_per_row(len(row), 1, H100_SMS), 5):
        totals, tables = hist_row_walk(row, misalign, blocks)
        np.testing.assert_array_equal(totals, ref)
        assert tables.shape == (blocks, TH.THREADS // 32, 256)
        assert tables.min() >= 0 and tables.sum() == len(row)
    plain = TH.hist256_plain(torch.from_numpy(row)[None])
    assert plain.dtype == torch.float32
    np.testing.assert_array_equal(ref.astype(np.float32), plain[0].numpy())
    assert torch.equal(TH.hist256(torch.from_numpy(row)[None]), plain)


def test_hist_wrapper_takes_the_plain_version_on_the_cpu():
    x = torch.from_numpy(_hist_cases()["random"][:4000].reshape(4, 1000))
    before = TH.LAUNCHES
    assert torch.equal(TH.hist256(x), TH.hist256_plain(x))
    assert TH.LAUNCHES == before and not TH._scratch
    assert TH.hist256(x[:0]).shape == (0, 256)
    with pytest.raises(ValueError):
        TH.hist256(x.to(torch.int32))


def test_alpha_like_plane_is_mostly_0_and_255():
    x = BENCH.alpha_like(3, 20000, np.random.default_rng(0))
    assert x.shape == (3, 20000) and x.dtype == np.uint8
    hot = ((x == 0) | (x == 255)).mean(axis=1)
    assert (hot >= 0.9).all() and (hot < 0.99).all()
    assert ((x == 255).mean(axis=1) > 0.05).all()


def test_micro_precompute_hist_runs_on_the_cpu(capsys):
    """On the CPU every wrapper takes its plain version: the bench's rows
    must say exact and bit-equal, and two runs give the same hashes."""
    rng = np.random.default_rng(45)
    hist = {"random 2x999": rng.integers(0, 256, (2, 999), dtype=np.uint8),
            "alpha-like 2x999": BENCH.alpha_like(2, 999, rng)}
    rows = BENCH.run("cpu", k2_shape=(1, 3, 9, 12), hist=hist)
    assert [r["kernel"][:2] for r in rows] == ["K2", "K1", "K1"]
    assert rows[0]["bit_equal"] and rows[0]["err"] == 0.0
    assert all(r["exact"] for r in rows[1:])
    again = BENCH.run("cpu", k2_shape=(1, 3, 9, 12), hist=hist)
    assert [r["sha"] for r in rows] == [r["sha"] for r in again]
    assert BENCH.photo_batch(2, 5, 7, 0).shape == (2, 5, 7, 3)


def test_hist_blocks_per_row():
    """About two resident blocks an SM over all rows, never more blocks
    than the row has work for, never fewer than one."""
    per_sm = TH.BLOCKS_PER_SM * H100_SMS
    assert TH.blocks_per_row(2160 * 3840, 4, H100_SMS) == per_sm // 4
    assert TH.blocks_per_row(576 * 1024, 4, H100_SMS) == 18
    assert TH.blocks_per_row(0, 4, H100_SMS) == 1
    assert TH.blocks_per_row(5, 1, H100_SMS) == 1
    assert TH.blocks_per_row(1 << 30, 1000, H100_SMS) == 1
    for b in (1, 2, 3, 4, 7, 64):
        for n in (1, 70000, 1 << 20, 1 << 27):
            k = TH.blocks_per_row(n, b, H100_SMS)
            assert 1 <= k <= max(1, per_sm // b)
            assert (k - 1) * TH.BLOCK_BYTES < max(n, 1)


def test_hist_wrapper_and_kernel_agree_on_their_constants():
    import re
    from image_segmenter_tpu_torch.kernels import _build

    src = (_build.CSRC / "histogram.cu").read_text()
    assert int(re.search(r"constexpr int kThreads = (\d+);", src).group(1)) \
        == TH.THREADS
    assert int(re.search(r"constexpr int kRow = (\d+);", src).group(1)) \
        == TH.SCRATCH_ROW
    # one launch a call: no memset in the C entry, no cast in the wrapper
    assert "cudaMemset" not in src
    import inspect
    assert ".to(torch.float32)" not in inspect.getsource(TH.hist256)


@pytest.mark.parametrize("shape", [(3, 4099), (2, 64, 33), (1, 0)])
def test_histogram_matches_jax(shape):
    """The same seeded bytes through the JAX package's `histogram_u8` and
    the port's: exact."""
    rng = np.random.default_rng(42)
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    if x.size:
        x.reshape(shape[0], -1)[0, : x[0].size // 2] = 255
    got = THG.histogram_u8(torch.from_numpy(x)).numpy()
    for b in range(shape[0]):
        np.testing.assert_array_equal(
            got[b], np.asarray(JHG.histogram_u8(jnp.asarray(x[b]))))
        np.testing.assert_array_equal(
            got[b], np.bincount(x[b].reshape(-1), minlength=256))


# ---------------------------------------------------------------------------
# one histogram for several quantiles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["random", "alpha-like", "constant"])
def test_u8_quantiles_from_one_histogram(kind):
    """`u8_quantile` with several q gives, per q, the bits of a call with
    that q alone, and the JAX package's value."""
    rng = np.random.default_rng(43)
    if kind == "random":
        x = rng.integers(0, 256, (3, 31, 17), dtype=np.uint8)
    elif kind == "alpha-like":
        x = BENCH.alpha_like(3, 31 * 17, rng).reshape(3, 31, 17)
    else:
        x = np.full((3, 31, 17), 9, np.uint8)
    xt = torch.from_numpy(x)
    qs = (0.8, 0.2, 0.5, 0.0, 1.0)
    many = THG.u8_quantile(xt, qs)
    assert many.shape == (len(qs), 3) and many.dtype == torch.float32
    for i, q in enumerate(qs):
        one = THG.u8_quantile(xt, q)
        assert one.shape == (3,)
        assert torch.equal(many[i], one)
        for b in range(3):
            ref = float(JHG.u8_quantile(jnp.asarray(x[b]), q))
            assert abs(float(one[b]) - ref) <= 1e-4 * max(1.0, abs(ref))


def test_trimap_counts_its_alpha_once(monkeypatch):
    """The trimap's two quantiles come from one histogram."""
    from image_segmenter_tpu_torch.pipeline import segment as SEG

    calls = []
    real = THG.hist256
    monkeypatch.setattr(THG, "hist256", lambda x: calls.append(1) or real(x))
    rng = np.random.default_rng(44)
    a = torch.from_numpy(rng.integers(100, 140, (2, 12, 15), dtype=np.uint8))
    tri = SEG._trimap_device(a)
    assert len(calls) == 1
    assert set(np.unique(tri.numpy())) <= {0.0, 0.5, 1.0}
