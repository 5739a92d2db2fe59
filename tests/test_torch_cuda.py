"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without an NVIDIA GPU. This
file imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from image_segmenter_tpu_torch.kernels import hist_variants as K8
from image_segmenter_tpu_torch.kernels import histogram as KH
from image_segmenter_tpu_torch.kernels import matting as K6
from image_segmenter_tpu_torch.kernels import matvec as KMV
from image_segmenter_tpu_torch.kernels import precompute as KP
from image_segmenter_tpu_torch.kernels import quantize as KQ
from image_segmenter_tpu_torch.kernels import quantize_flat as K7
from image_segmenter_tpu_torch.kernels import resample as RS
from image_segmenter_tpu_torch.kernels import sam_attention as SA
from image_segmenter_tpu_torch.kernels import swin_attention as KSW

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from image_segmenter_tpu_torch.utils.backend import strict_f32

    strict_f32()
    return torch.device("cuda")


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


@pytest.mark.parametrize("shape", [(3, 1000), (2, 1 << 20), (1, 37 * 53)])
def test_histogram_kernel_exact(cuda, shape):
    x = torch.randint(0, 256, shape, generator=_gen(cuda, 1), device=cuda,
                      dtype=torch.uint8)
    x[0, :500] = 7
    before = KH.LAUNCHES
    got = KH.hist256(x)
    assert KH.LAUNCHES == before + 1
    assert torch.equal(got, KH.hist256_plain(x))
    off = x[0, 3:].reshape(1, -1)  # unaligned start
    assert torch.equal(KH.hist256(off), KH.hist256_plain(off))


def _bincount(x):
    return np.stack([np.bincount(r, minlength=256) for r in x.cpu().numpy()]) \
        .astype(np.float32).reshape(x.shape[0], 256)


@pytest.mark.parametrize("kind", ["random", "alpha-like", "all 0", "all 255",
                                  "all 7", "words"])
@pytest.mark.parametrize("shape", [(4, 2160 * 3840), (4, 576 * 1024),
                                   (2, 37 * 53), (3, 2 * 32768 + 777), (1, 5),
                                   (2, 0), (70, 4099)])
def test_histogram_kernel_aggregation_exact(cuda, shape, kind):
    """Bytes of 0 and 255 in registers, 16 and 4 equal bytes as one
    addition: exact against np.bincount on the inputs each path is for, at
    the main path's two sizes, ragged ones, an empty row and more rows than
    the scratch first holds."""
    from image_segmenter_tpu_torch.bench.micro_precompute_hist import \
        alpha_like

    rng = np.random.default_rng(11)
    b, n = shape
    if kind == "random":
        xh = rng.integers(0, 256, shape, dtype=np.uint8)
    elif kind == "alpha-like":
        xh = alpha_like(b, n, rng)
    elif kind == "words":
        xh = np.repeat(rng.integers(0, 256, (b, -(-n // 4)), dtype=np.uint8),
                       4, axis=1)[:, :n]
    else:
        xh = np.full(shape, int(kind.split()[1]), np.uint8)
    x = torch.from_numpy(np.ascontiguousarray(xh)).to(cuda)
    before = KH.LAUNCHES
    got = KH.hist256(x)
    assert KH.LAUNCHES == before + 1
    assert got.dtype == torch.float32 and got.shape == (b, 256)
    np.testing.assert_array_equal(got.cpu().numpy(), _bincount(x))
    if n > 3:
        off = x[0, 3:].reshape(1, -1)  # unaligned start
        np.testing.assert_array_equal(KH.hist256(off).cpu().numpy(),
                                      _bincount(off))


def test_histogram_kernel_200_calls_back_to_back(cuda):
    """The scratch is cleared by the kernel itself: 200 calls on changing
    inputs and sizes without a synchronisation between them, each exact."""
    g = _gen(cuda, 12)
    sizes = [576 * 1024, 37 * 53, 1 << 20, 4099, 2160 * 3840]
    xs = []
    for i in range(20):
        x = torch.randint(0, 256, (1 + i % 4, sizes[i % len(sizes)]),
                          generator=g, device=cuda, dtype=torch.uint8)
        if i % 3 == 0:
            x[:, : x.shape[1] // 2] = 255 * (i % 2)
        xs.append(x)
    refs = [torch.from_numpy(_bincount(x)) for x in xs]
    torch.cuda.synchronize()
    before = KH.LAUNCHES
    outs = [KH.hist256(xs[i % 20]) for i in range(200)]
    torch.cuda.synchronize()
    assert KH.LAUNCHES == before + 200
    for i, out in enumerate(outs):
        assert torch.equal(out.cpu(), refs[i % 20]), i
    # the scratch of this stream is all zero again
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert int(KH._scratch_for(xs[0].device, stream, 1).abs().sum()) == 0


def test_histogram_kernel_two_streams(cuda):
    """Each stream has its own scratch: calls that overlap on two streams
    stay exact."""
    g = _gen(cuda, 13)
    x1 = torch.randint(0, 256, (4, 2160 * 3840), generator=g, device=cuda,
                       dtype=torch.uint8)
    x2 = torch.randint(0, 200, (4, 2160 * 3840), generator=g, device=cuda,
                       dtype=torch.uint8)
    r1, r2 = _bincount(x1), _bincount(x2)
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    outs1, outs2 = [], []
    for _ in range(20):
        outs1.append(KH.hist256(x1))
        with torch.cuda.stream(side):
            outs2.append(KH.hist256(x2))
    torch.cuda.synchronize()
    for o1, o2 in zip(outs1, outs2):
        np.testing.assert_array_equal(o1.cpu().numpy(), r1)
        np.testing.assert_array_equal(o2.cpu().numpy(), r2)


# a ragged shape, a width that is no multiple of 4 over several strips, an
# image narrower than a strip, one row, one pixel, and one image of the
# main path
@pytest.mark.parametrize("kind", ["random", "near-singular"])
@pytest.mark.parametrize("shape", [(2, 3, 37, 53), (1, 3, 33, 130),
                                   (2, 3, 64, 96), (1, 3, 203, 389),
                                   (2, 3, 19, 7), (1, 3, 1, 64), (1, 3, 1, 1),
                                   (1, 3, 576, 1024), (4, 3, 576, 1024)])
def test_precompute_kernel_matches_plain(cuda, shape, kind):
    """Same order of operations, no FMA contraction: within 1e-4 (abs or
    rel), and in fact bit for bit."""
    img = torch.rand(shape, generator=_gen(cuda, 2), device=cuda)
    if kind == "near-singular":   # a flat colour plus 1e-4 noise
        img = torch.tensor([0.3, 0.6, 0.45], device=cuda)[None, :, None, None] \
            + 1e-4 * (img - 0.5)
    before = KP.LAUNCHES
    got = KP.precompute_planes(img, 1e-7)
    assert KP.LAUNCHES == before + 1
    ref = KP.precompute_planes_plain(img, 1e-7)
    err = (got - ref).abs()
    rel = err / ref.abs().clamp_min(1e-30)
    assert float(torch.minimum(err, rel).max()) < 1e-4
    assert torch.equal(got, ref)


# (2, 203, 389) spans several strips and several runs with a ragged edge;
# (1, 576, 1024) is one image of the main path (aligned 16-byte pieces)
@pytest.mark.parametrize("bhw", [(2, 37, 53), (1, 33, 130), (3, 64, 96),
                                 (2, 203, 389), (1, 576, 1024), (1, 1, 1)])
def test_matvec_kernel_matches_plain(cuda, bhw):
    """Within 1e-5 of max|ref|, and in fact the same bits: the kernel keeps
    the plain version's order of sums and is built without FMA contraction."""
    g = _gen(cuda, 3)
    b, h, w = bhw
    img = torch.rand((b, 3, h, w), generator=g, device=cuda)
    planes = KP.precompute_planes(img, 1e-7)
    p = torch.randn((b, h, w), generator=g, device=cuda)
    before = KMV.LAUNCHES
    got = KMV.matvec_planes(planes, img, p)
    assert KMV.LAUNCHES == before + 1
    ref = KMV.matvec_planes_plain(planes, img, p)
    assert float((got - ref).abs().max() / (ref.abs().max() + 1e-9)) < 1e-5
    assert torch.equal(got, ref)
    # an operand that does not start on a 16-byte boundary: 4-byte pieces
    if w % 4 == 0 and b * h * w > 1:
        flat = torch.empty(b * h * w + 1, device=cuda)
        off = flat[1:].view(b, h, w).copy_(p)
        assert off.data_ptr() % 16 != 0
        assert torch.equal(KMV.matvec_planes(planes, img, off), ref)


def _matvec_operands(cuda, bhw, seed):
    g = _gen(cuda, seed)
    b, h, w = bhw
    img = torch.rand((b, 3, h, w), generator=g, device=cuda)
    planes = KP.precompute_planes(img, 1e-7)
    p = torch.randn((b, h, w), generator=g, device=cuda)
    return img, planes, p


# (1, 16, 124): W + 4 is a multiple of 128, so a tile's halo passes the
# padded width and the kernels' bounds checks are what keeps them in range
RAGGED = [(2, 37, 53), (1, 33, 130), (3, 64, 96), (1, 16, 124)]


@pytest.mark.parametrize("bhw", RAGGED)
def test_matvec_stack_kernel_matches_plain_and_k3(cuda, bhw):
    """K5 within 1e-5 of max|ref| of its plain version (the bound the JAX
    tests hold the Pallas kernel to), and bit-equal to K3 on the same
    operands: same arithmetic in the same order, no FMA contraction."""
    img, planes, p = _matvec_operands(cuda, bhw, 5)
    stack = KMV.build_matvec_stack_planes(img, planes)
    before = KMV.STACK_LAUNCHES
    got = KMV.matvec_stack(stack, p)
    assert KMV.STACK_LAUNCHES == before + 1
    ref = KMV.matvec_stack_plain(stack, p)
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5
    assert torch.equal(got, KMV.matvec_planes(planes, img, p))
    one = KMV.matvec_stack(stack[0], p[0])  # the unbatched form
    assert torch.equal(one, got[0])


@pytest.mark.parametrize("bhw", RAGGED)
def test_matvec_recompute_kernel_matches_plain(cuda, bhw):
    """K6 gives its plain version's bits over its whole output (the
    partial sums next to the image included): the same order of every sum,
    no FMA contraction. Within 1e-5 of max|ref| of K3's matvec inside the
    image."""
    img, planes, p = _matvec_operands(cuda, bhw, 6)
    b, h, w = bhw
    static = K6.pack_static(torch.ones_like(p), img, planes[:, 0:6])
    p_pad = K6.pad_p(p)
    before = K6.LAUNCHES
    got = K6.matvec_planes(p_pad, static)
    assert K6.LAUNCHES == before + 1
    ref = K6.matvec_planes_plain(p_pad, static)
    assert got.shape == ref.shape
    scale = float(ref[:, :h, :w].abs().max())
    assert float((got - ref).abs().max()) / scale < 1e-5
    assert torch.equal(got, ref)
    k3 = KMV.matvec_planes(planes, img, p)
    assert float((got[:, :h, :w] - k3).abs().max()) / scale < 1e-5
    one = K6.matvec_planes(p_pad[0], static[0])  # the unbatched form
    assert torch.equal(one, got[0])


def _valid_with_holes(cuda, b, h, w, seed):
    """1 but for scattered holes, a hole of a few rows and columns and a
    ragged right border."""
    g = _gen(cuda, seed)
    valid = (torch.rand((b, h, w), generator=g, device=cuda) > 0.1).float()
    valid[:, h // 3:h // 3 + 3, w // 4:w // 4 + 5] = 0.0
    cut = torch.randint(0, min(w, 4) + 1, (h,), generator=g, device=cuda)
    valid[:, torch.arange(w, device=cuda)[None, :] >= (w - cut)[:, None]] = 0.0
    return valid


# the bench shape at b 4, several strips and runs with a ragged edge, one
# pixel, and the ragged shapes
@pytest.mark.parametrize("bhw", RAGGED + [(4, 576, 1024), (2, 203, 389),
                                          (1, 1, 1)])
def test_matvec_recompute_kernel_masked_valid_bits(cuda, bhw):
    """K6 on a `valid` plane with holes and a ragged border: the plain
    version's bits; also where Wp is no multiple of 4 (4-byte pieces)."""
    img, planes, p = _matvec_operands(cuda, bhw, 16)
    valid = _valid_with_holes(cuda, *bhw, 17)
    static = K6.pack_static(valid, img, planes[:, 0:6])
    p_pad = K6.pad_p(p)
    assert torch.equal(K6.matvec_planes(p_pad, static),
                       K6.matvec_planes_plain(p_pad, static))
    wp = p_pad.shape[2] - 1
    p_odd = p_pad[..., :wp].contiguous()
    s_odd = static[..., :wp].contiguous()
    assert torch.equal(K6.matvec_planes(p_odd, s_odd),
                       K6.matvec_planes_plain(p_odd, s_odd))


# (2, 37, 53): H*W odd, the pixel-by-pixel path; the others take 4 pixels a
# thread. k_real 1 and 11 leave palette rows unused.
@pytest.mark.parametrize("palette", ["whole", "fractional", "mixed"])
@pytest.mark.parametrize("bhw,k_real", [((2, 37, 53), 11), ((1, 128, 200), 16),
                                        ((4, 48, 50), 1), ((4, 48, 50), 11),
                                        ((4, 48, 50), 16), ((2, 16, 16), 0)])
def test_quantize_kernel_bit_exact(cuda, bhw, k_real, palette):
    """Whole-number palettes (the integer path), fractional ones (the
    separately rounded float path) and batches that mix the two image by
    image, with exact ties: the plain version's bytes."""
    g = _gen(cuda, 4)
    b = bhw[0]
    rgb = torch.randint(0, 256, (*bhw, 3), generator=g, device=cuda,
                        dtype=torch.uint8)
    alpha = torch.rand(bhw, generator=g, device=cuda) > 0.3
    pal = torch.randint(0, 256, (b, 16, 3), generator=g,
                        device=cuda).float()
    frac = torch.rand((b, 16, 3), generator=g, device=cuda) * 255
    if palette == "fractional":
        pal = frac
    elif palette == "mixed":
        pal[1::2] = frac[1::2]
    pal[:, 4] = pal[:, 1]
    rgb[:, 0, 0] = pal[:, 1].to(torch.uint8)
    thr = torch.tensor([30.0, 10.0, -1.0, 30.0][:b], device=cuda)
    whole = KQ.whole_number_palette(pal, k_real)
    if k_real > 0:
        assert whole.tolist() == [palette == "whole"
                                  or (palette == "mixed" and i % 2 == 0)
                                  for i in range(b)]
    ref = KQ.quantize_map_plain(rgb, alpha, pal, k_real, thr)
    before = KQ.LAUNCHES
    assert torch.equal(KQ.quantize_map(rgb, alpha, pal, k_real, thr), ref)
    assert KQ.LAUNCHES == before + 1
    if palette == "whole" and b > 1:
        # an image that does not start on a word boundary: byte path
        flat = torch.empty(rgb.numel() + 3, dtype=torch.uint8, device=cuda)
        off = flat[3:].view_as(rgb).copy_(rgb)
        a_u8 = torch.empty(alpha.numel() + 1, dtype=torch.uint8, device=cuda)
        a_off = a_u8[1:].view_as(alpha).copy_(alpha)
        assert torch.equal(KQ.quantize_map(off, a_off, pal, k_real, thr), ref)


def test_quantize_kernel_256_entries(cuda):
    """The largest palette the kernel stages, whole and fractional."""
    g = _gen(cuda, 9)
    rgb = torch.randint(0, 256, (2, 64, 100, 3), generator=g, device=cuda,
                        dtype=torch.uint8)
    alpha = torch.rand((2, 64, 100), generator=g, device=cuda) > 0.3
    pal = torch.randint(0, 256, (2, 256, 3), generator=g, device=cuda).float()
    pal[1] += torch.rand((256, 3), generator=g, device=cuda)
    thr = torch.tensor([-1.0, 30.0], device=cuda)
    assert KQ.whole_number_palette(pal, 256).tolist() == [True, False]
    assert torch.equal(KQ.quantize_map(rgb, alpha, pal, 256, thr),
                       KQ.quantize_map_plain(rgb, alpha, pal, 256, thr))


@pytest.mark.parametrize("s", [255.0, 3.0])
def test_true_div_rounds_as_the_cpu(cuda, s):
    """x / s on the card rounds as the CPU's division (a plain x / s on a
    CUDA tensor multiplies by 1 / s and differs for many u8 levels)."""
    from image_segmenter_tpu_torch.utils.backend import true_div

    x = torch.arange(766, dtype=torch.float32)
    assert torch.equal(true_div(x.to(cuda), s).cpu(), x / s)


def test_pipeline_on_the_card(cuda):
    """The main path on the card launches all four kernels and keeps the
    output contract; from the same CNN mask its matting and quantize
    stages give the CPU's bytes."""
    from image_segmenter_tpu_torch.pipeline.segment import Pipeline

    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (2, 96, 128, 3), dtype=np.uint8)
    pipe = Pipeline(model="u2netp", k=8, cg_iters=30, device="cuda")
    mods = (KH, KP, KMV, KQ)
    before = [m.LAUNCHES for m in mods]
    rgba, alpha, pal = pipe.run(imgs)
    assert all(m.LAUNCHES > n for m, n in zip(mods, before))
    a = rgba[..., 3]
    assert bool(((a == 0) | (a == 255)).all())
    cpu = Pipeline(model="u2netp", k=8, cg_iters=30, device="cpu")
    x = torch.from_numpy(imgs)
    mask = pipe.stages.cnn(pipe.session.module, x.to(cuda)).cpu()
    g_sharp, g_alpha = pipe.stages.matting(x.to(cuda), mask.to(cuda))
    c_sharp, c_alpha = cpu.stages.matting(x, mask)
    g = [t.cpu() for t in (g_alpha, g_sharp, *pipe.stages.quantize(x.to(cuda),
                                                                   g_sharp))]
    c = [c_alpha, c_sharp, *cpu.stages.quantize(x, c_sharp)]
    for gt, ct in zip(g, c):
        assert torch.equal(gt, ct)


def _photo_like(b, h, w, seed):
    """Smooth gradients and noise: a CG and a Lloyd run of some length."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for i in range(b):
        base = np.stack([127 + 100 * np.sin((xx + 17 * i) / 23.0),
                         127 + 100 * np.cos(yy / (19.0 + i)),
                         127 + 100 * np.sin((xx + yy) / 31.0)], -1)
        out.append(base + rng.normal(0, 6, base.shape))
    return np.clip(np.stack(out), 0, 255).astype(np.uint8)


def test_compiled_run_is_the_eager_run(cuda):
    """`Pipeline.run` on the card replays its graphs: the eager stages'
    bytes and loop counts, K1-K4 counted from the replays (K3 a whole
    number of CG chunks after the first residual), a second call on
    other images that leaves the first call's outputs alone, and a second
    shape with a program of its own."""
    from image_segmenter_tpu_torch.pipeline import segment as SEG
    from image_segmenter_tpu_torch.utils.loops import drive
    from image_segmenter_tpu_torch.solvers.matting import CG_CHUNK

    pipe = SEG.Pipeline(model="u2netp", k=16, device="cuda")
    x = torch.from_numpy(_photo_like(2, 240, 320, 0)).to(cuda)
    first = pipe.run(x)  # warm-up and capture
    mods = (KH, KP, KMV, KQ)
    before = [m.LAUNCHES for m in mods]
    out = pipe.run(x)
    launches = [m.LAUNCHES - n for m, n in zip(mods, before)]
    (prog,) = pipe.programs.values()
    cg_it, lloyd_it = prog.iterations()
    loops = []
    eager = drive(SEG.batch_program(pipe.stages, pipe.session.module, x),
                  loops)
    for a, b, c in zip(out, first, eager):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(cg_it, loops[0].it) and torch.equal(lloyd_it,
                                                           loops[1].it)
    chunks = -(-int(cg_it.max()) // CG_CHUNK)
    assert launches == [2, 1, 1 + CG_CHUNK * chunks, 1]

    keep = [t.clone() for t in out]
    other = pipe.run(torch.flip(x, dims=[0]))
    assert all(torch.equal(a, b) for a, b in zip(out, keep))
    assert not torch.equal(other.alpha, out.alpha)
    y = torch.from_numpy(_photo_like(1, 200, 256, 1)).to(cuda)
    got = pipe.run(y)
    assert len(pipe.programs) == 2
    for a, b in zip(got, pipe.run_eager(y)):
        assert torch.equal(a, b)


def test_compiled_run_spans(cuda):
    """The compiled run under torch.profiler (utils/profiling.py): one
    `compiled.segment` a graph of straight code, the CG's `loop.step`
    spans the K3 launches' chunks, a flag read more than chunks a loop,
    one `compiled.capture` a shape, and the outputs unchanged."""
    from torch.profiler import ProfilerActivity, profile

    from image_segmenter_tpu_torch.pipeline import segment as SEG
    from image_segmenter_tpu_torch.solvers.matting import CG_CHUNK
    from image_segmenter_tpu_torch.utils import profiling as P

    P.clear()
    pipe = SEG.Pipeline(model="u2netp", k=16, device="cuda")
    x = torch.from_numpy(_photo_like(2, 240, 320, 0)).to(cuda)
    first = pipe.run(x)  # warm-up and capture, untraced
    (prog,) = pipe.programs.values()
    launches = KMV.LAUNCHES
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out = pipe.run(x)
        torch.cuda.synchronize()
    launches = KMV.LAUNCHES - launches
    assert all(torch.equal(a, b) for a, b in zip(out, first))
    (call,) = [c for c in P.record().calls
               if c.spans[0].name == "pipeline.run"]
    loops = len(prog.iterations())
    names = [s.name for s in call.spans]
    chunks = sum(call.chunks.values())
    assert names.count("compiled.segment") == prog.graphs() - loops
    assert names.count("compiled.ingest") == 1 == names.count(
        "compiled.outputs")
    assert call.chunks["CGLoop"] == (launches - 1) // CG_CHUNK
    assert call.flag_reads == chunks + loops
    assert call.graph_replays == prog.graphs() - loops + chunks
    captures = [s for s in P.record().setup if s.name == "compiled.capture"]
    assert [s.attrs for s in captures] == [(prog.serial,)]
    pipe.run(torch.from_numpy(_photo_like(1, 200, 256, 1)).to(cuda))
    pipe.run(x)
    captures = [s for s in P.record().setup if s.name == "compiled.capture"]
    assert len(captures) == 2 and captures[0].attrs == (prog.serial,)


# the bench shape, a ragged one (the byte path) and rows of a multiple of
# 16 (the 16-byte path at a small size)
@pytest.mark.parametrize("bhw,k_real", [((4, 2160, 3840), 16),
                                        ((2, 37, 53), 11), ((3, 48, 50), 16)])
def test_quantize_flat_kernel_equals_k4_and_plain(cuda, bhw, k_real):
    g = _gen(cuda, 7)
    b, h, w = bhw
    rgb = torch.randint(0, 256, (b, h, w, 3), generator=g, device=cuda,
                        dtype=torch.uint8)
    alpha = torch.rand((b, h, w), generator=g, device=cuda) > 0.3
    pal = torch.randint(0, 256, (b, 16, 3), generator=g,
                        device=cuda).to(torch.float32)
    pal[:, 5] = pal[:, 2]  # exact ties: the first index must win
    thr = torch.tensor([30.0, 10.0, -1.0, 30.0][:b], device=cuda)
    before = K7.LAUNCHES
    got = K7.quantize_map_flat(rgb, alpha, pal, k_real, thr)
    assert K7.LAUNCHES == before + 1
    assert torch.equal(got, KQ.quantize_map(rgb, alpha, pal, k_real, thr))
    assert torch.equal(got, K7.quantize_map_flat_plain(rgb, alpha, pal, k_real,
                                                       thr))
    # fractional palette entries: the same float arithmetic, no FMA
    frac = pal + torch.rand(pal.shape, generator=g, device=cuda)
    assert torch.equal(K7.quantize_map_flat(rgb, alpha, frac, k_real, thr),
                       KQ.quantize_map_plain(rgb, alpha, frac, k_real, thr))


@pytest.mark.parametrize("shape", [(4, 2160 * 3840), (1, 2160 * 3840),
                                   (2, 37 * 53), (3, 2 * 32768 + 777), (1, 5)])
@pytest.mark.parametrize("variant", sorted(K8.STEPS))
def test_hist_variant_kernel_exact(cuda, variant, shape):
    """Random rows with a long run, alpha-like rows and all-equal rows (the
    byte counters' worst case): float32 counts equal to K1 and np.bincount,
    one launch a call."""
    from image_segmenter_tpu_torch.bench.micro_precompute_hist import \
        alpha_like

    x = torch.randint(0, 256, shape, generator=_gen(cuda, 8), device=cuda,
                      dtype=torch.uint8)
    x[0, : shape[1] // 3] = 255  # a long run of one value
    alpha = torch.from_numpy(alpha_like(*shape, np.random.default_rng(8))) \
        .to(cuda)
    equal = torch.full(shape, 7, dtype=torch.uint8, device=cuda)
    for xi in (x, alpha, equal):
        before = K8.LAUNCHES
        got = K8.hist_variant(xi, variant)
        assert K8.LAUNCHES == before + 1
        assert got.dtype == torch.float32 and got.shape == (shape[0], 256)
        assert torch.equal(got, KH.hist256(xi))
        np.testing.assert_array_equal(got.cpu().numpy(), _bincount(xi))
        if shape[1] < 1 << 20:
            assert torch.equal(got, K8.hist_variant_plain(xi, variant))
        off = xi[0, 3:].reshape(1, -1)  # unaligned start
        assert torch.equal(K8.hist_variant(off, variant), KH.hist256(off))


@pytest.mark.parametrize("variant", sorted(K8.STEPS))
def test_hist_variant_kernel_is_one_device_operation(cuda, variant):
    """No memset before the kernel and no cast after it (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.randint(0, 256, (4, 1 << 20), generator=_gen(cuda, 14),
                      device=cuda, dtype=torch.uint8)
    K8.hist_variant(x, variant)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            K8.hist_variant(x, variant)
        torch.cuda.synchronize()
    ops = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ops:
        pytest.skip("torch.profiler recorded no device operation here")
    assert len(ops) == 10, sorted(set(ops))


def test_hist_variant_kernel_200_calls_back_to_back(cuda):
    """K1's scratch is cleared by K8 itself: 200 calls on changing inputs,
    sizes and variants, K1 between them, without a synchronisation, each
    exact; the scratch of the stream is zero after them."""
    g = _gen(cuda, 15)
    sizes = [576 * 1024, 37 * 53, 1 << 20, 4099, 2160 * 3840]
    xs = []
    for i in range(20):
        x = torch.randint(0, 256, (1 + i % 4, sizes[i % len(sizes)]),
                          generator=g, device=cuda, dtype=torch.uint8)
        if i % 3 == 0:
            x[:, : x.shape[1] // 2] = 255 * (i % 2)
        xs.append(x)
    refs = [torch.from_numpy(_bincount(x)) for x in xs]
    names = sorted(K8.STEPS)
    torch.cuda.synchronize()
    before = K8.LAUNCHES
    outs = [K8.hist_variant(xs[i % 20], names[i % 5]) if i % 7 else
            KH.hist256(xs[i % 20]) for i in range(200)]
    torch.cuda.synchronize()
    assert K8.LAUNCHES == before + sum(1 for i in range(200) if i % 7)
    for i, out in enumerate(outs):
        assert torch.equal(out.cpu(), refs[i % 20]), i
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert int(KH._scratch_for(xs[0].device, stream, 1).abs().sum()) == 0


def test_hist_variant_kernel_two_streams(cuda):
    """Each stream has its own scratch: calls that overlap on two streams
    stay exact."""
    g = _gen(cuda, 16)
    x1 = torch.randint(0, 256, (4, 2160 * 3840), generator=g, device=cuda,
                       dtype=torch.uint8)
    x2 = torch.randint(0, 200, (4, 2160 * 3840), generator=g, device=cuda,
                       dtype=torch.uint8)
    r1, r2 = _bincount(x1), _bincount(x2)
    names = sorted(K8.STEPS)
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    outs1, outs2 = [], []
    for i in range(20):
        outs1.append(K8.hist_variant(x1, names[i % 5]))
        with torch.cuda.stream(side):
            outs2.append(K8.hist_variant(x2, names[-1 - i % 5]))
    torch.cuda.synchronize()
    for o1, o2 in zip(outs1, outs2):
        np.testing.assert_array_equal(o1.cpu().numpy(), r1)
        np.testing.assert_array_equal(o2.cpu().numpy(), r2)


def test_prng_and_colour_ops_card_equals_cpu(cuda):
    """The random stream is integer work: the same bits on the card. The
    colour conversions take their powers in float64: the same float32."""
    from image_segmenter_tpu_torch.ops import color as C
    from image_segmenter_tpu_torch.utils import prng as P

    key = P.key(42)
    assert torch.equal(P.bits(key, (70001,), cuda).cpu(),
                       P.bits(key, (70001,), "cpu"))
    assert torch.equal(P.uniform(key, (4, 1025), cuda).cpu(),
                       P.uniform(key, (4, 1025), "cpu"))
    rng = np.random.default_rng(0)
    u8 = torch.from_numpy(rng.integers(0, 256, (100000, 3), dtype=np.uint8))
    assert torch.equal(C.rgb_u8_to_hsv_cv(u8.to(cuda)).cpu(),
                       C.rgb_u8_to_hsv_cv(u8))
    lab_card, lab_cpu = C.rgb_u8_to_lab(u8.to(cuda)).cpu(), C.rgb_u8_to_lab(u8)
    assert float((lab_card - lab_cpu).abs().max()) <= 1e-4


# the bench shape, a ragged one (the byte path), rows of a multiple of 16
# (the 16-byte path) with 16, 1 and no palette entry, and 256 entries
@pytest.mark.parametrize("palette", ["whole", "fractional", "mixed"])
@pytest.mark.parametrize("bhw,k_real", [((4, 2160, 3840), 16),
                                        ((2, 37, 53), 11), ((3, 48, 50), 16),
                                        ((4, 48, 50), 1), ((2, 16, 16), 0),
                                        ((2, 64, 100), 256)])
def test_quantize_flat_kernel_palette_kinds(cuda, bhw, k_real, palette):
    """K7 on whole-number palettes (K4's integer keys), fractional ones
    (the separately rounded float path) and batches that mix the two image
    by image, with exact ties: the plain version's bytes and K4's; on
    planes that start off a 16-byte boundary too (the byte path)."""
    g = _gen(cuda, 10)
    b, h, w = bhw
    k_max = max(16, k_real)
    rgb = torch.randint(0, 256, (b, h, w, 3), generator=g, device=cuda,
                        dtype=torch.uint8)
    alpha = torch.rand((b, h, w), generator=g, device=cuda) > 0.3
    pal = torch.randint(0, 256, (b, k_max, 3), generator=g,
                        device=cuda).float()
    frac = torch.rand((b, k_max, 3), generator=g, device=cuda) * 255
    if palette == "fractional":
        pal = frac
    elif palette == "mixed":
        pal[1::2] = frac[1::2]
    pal[:, 5] = pal[:, 2]
    rgb[:, 0, 0] = pal[:, 2].to(torch.uint8)
    thr = torch.tensor([30.0, 10.0, -1.0, 30.0][:b], device=cuda)
    ref = KQ.quantize_map_plain(rgb, alpha, pal, k_real, thr)
    before = K7.LAUNCHES
    got = K7.quantize_map_flat(rgb, alpha, pal, k_real, thr)
    assert K7.LAUNCHES == before + 1
    assert torch.equal(got, ref)
    assert torch.equal(got, KQ.quantize_map(rgb, alpha, pal, k_real, thr))
    planes = K7.split_planes(rgb)
    flat = torch.empty(planes.numel() + 1, dtype=torch.uint8, device=cuda)
    off = flat[1:].view_as(planes).copy_(planes)
    a_u8 = alpha.reshape(b, h * w).to(torch.uint8)
    assert torch.equal(K7.stack_planes(K7.quantize_planes(off, a_u8, pal,
                                                          k_real, thr), h, w),
                       ref)


# ---------------------------------------------------------------------------
# the cutout path on the card: GrabCut and ISNet against the CPU port
# ---------------------------------------------------------------------------

def test_grabcut_core_card_matches_cpu(cuda):
    """GrabCut (10 alternations, split-merge polish) on a 120 x 160 scene:
    foreground IoU >= 0.99 between the card and the CPU, the known pixels
    passed through, and the same bytes on a second call on the card."""
    from image_segmenter_tpu_torch.utils.seeds import config4_rect, \
        portrait_scene
    from image_segmenter_tpu_torch.compat.grabcut import apply_grabcut

    img, _ = portrait_scene(120, 160, 3)
    rect = config4_rect(120, 160)
    got = apply_grabcut(img, rect_xywh=rect, iterations=10)
    ref = apply_grabcut(img, rect_xywh=rect, iterations=10, device="cpu")
    fg_g, fg_c = (got == 1) | (got == 3), (ref == 1) | (ref == 3)
    assert (fg_g & fg_c).sum() / max((fg_g | fg_c).sum(), 1) >= 0.99
    x, y, w, h = rect
    outside = np.ones(img.shape[:2], bool)
    outside[y:y + h, x:x + w] = False
    assert (got[outside] == 0).all()
    assert np.array_equal(got, apply_grabcut(img, rect_xywh=rect,
                                             iterations=10))


@pytest.mark.parametrize("hw", [(256, 192), (1024, 768)])
def test_compiled_grabcut_is_the_eager_grabcut(cuda, hw):
    """grabcut_core on the card runs its units from CUDA graphs: the
    private eager path's mask bytes, cut iterations and restart flag, at
    the polish's small path (256 x 192) and at config 4's shape (1024 x
    768, the coarse search), and a third call bit-identical."""
    from image_segmenter_tpu_torch.solvers import grabcut as GC
    from image_segmenter_tpu_torch.utils.seeds import config4_rect, \
        portrait_scene

    h, w = hw
    img, _ = portrait_scene(h, w, 21)
    x, y, rw, rh = config4_rect(h, w)
    mask = np.zeros((h, w), np.uint8)
    mask[y:y + rh, x:x + rw] = GC.PR_FGD

    def solve(fn):
        out = fn(img, mask, iterations=10, device="cuda").cpu().numpy()
        info = GC.LAST_SOLVE_INFO
        return out, info["cut_iters"], info.get("restart_accepted")

    GC.clear_programs()
    first = solve(GC.grabcut_core)  # warm-up and captures
    # one group, the image's: the coarse search's units join it
    assert [shape for shape, _ in GC._UNITS.groups] == [(h, w)]
    second = solve(GC.grabcut_core)
    eager = solve(GC._grabcut_core_eager)
    third = solve(GC.grabcut_core)
    for got in (first, second, third):
        assert np.array_equal(got[0], eager[0])
        assert got[1:] == eager[1:]


def test_compiled_grabcut_memory_is_bounded(cuda):
    """Cutting images of five shapes (about as many pixels each, none
    past the polish's coarse search) keeps the units of the last
    `PROGRAM_SHAPES` shapes: the groups stay at that count and the device
    memory reserved after each later shape stays within a quarter of that
    after the second, over what was reserved before the first."""
    from image_segmenter_tpu_torch.pipeline.compiled import PROGRAM_SHAPES
    from image_segmenter_tpu_torch.solvers import grabcut as GC
    from image_segmenter_tpu_torch.utils.seeds import config4_rect, \
        portrait_scene

    GC.clear_programs()
    torch.cuda.synchronize()
    base = torch.cuda.memory_reserved()
    reserved = []
    for h, w in ((192, 256), (256, 192), (208, 236), (236, 208),
                 (240, 204)):
        img, _ = portrait_scene(h, w, 21)
        x, y, rw, rh = config4_rect(h, w)
        mask = np.zeros((h, w), np.uint8)
        mask[y:y + rh, x:x + rw] = GC.PR_FGD
        GC.grabcut_core(img, mask, iterations=3, device="cuda")
        torch.cuda.synchronize()
        assert len(GC._UNITS.groups) == min(len(reserved) + 1,
                                            PROGRAM_SHAPES)
        reserved.append(torch.cuda.memory_reserved() - base)
    assert max(reserved[2:]) <= 1.25 * reserved[1], reserved
    GC.clear_programs()


def test_compiled_pipeline_memory_is_bounded(cuda):
    """`Pipeline.run` on three frame shapes of as many pixels keeps the
    programs of the last `PROGRAM_SHAPES`: the programs stay at that
    count, the last call's program last (a shape run again too, with no
    new capture), and the device memory reserved after the third shape
    stays within a quarter of that after the second, over what was
    reserved before the first."""
    import gc

    from image_segmenter_tpu_torch.pipeline import segment as SEG
    from image_segmenter_tpu_torch.pipeline.compiled import PROGRAM_SHAPES

    pipe = SEG.Pipeline(model="u2netp", k=16, device="cuda")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    reserved, frames = [], []
    for i, (h, w) in enumerate(((240, 320), (320, 240), (256, 300))):
        frames.append(torch.from_numpy(_photo_like(2, h, w, i)).to(cuda))
        pipe.run(frames[-1])
        torch.cuda.synchronize()
        assert len(pipe.programs) == min(i + 1, PROGRAM_SHAPES)
        assert list(pipe.programs)[-1] == ((2, h, w), str(pipe.device))
        reserved.append(torch.cuda.memory_reserved() - base)
    assert reserved[2] <= 1.25 * reserved[1], reserved
    kept = pipe.programs
    out = pipe.run(frames[1])
    assert list(pipe.programs) == [((2, 256, 300), str(pipe.device)),
                                   ((2, 320, 240), str(pipe.device))]
    assert list(pipe.programs.values())[-1] is kept[((2, 320, 240),
                                                     str(pipe.device))]
    for a, b in zip(out, pipe.run_eager(frames[1])):
        assert torch.equal(a, b)


def test_prng_key_words_in_a_captured_graph(cuda):
    """A categorical draw captured in a CUDA graph after one eager call
    (which makes its key words) replays the eager draw's indices, and
    the key words on the card are the CPU's."""
    from image_segmenter_tpu_torch.utils import prng as P

    keys = [P.fold_in(P.key(42), i) for i in range(3)]
    logits = torch.randn((3, 5000), generator=_gen(cuda, 9), device=cuda)
    eager = P.categorical_batched(keys, logits, 4)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=stream):
        out = P.categorical_batched(keys, logits, 4)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    k1, k2 = P._key_words(keys, cuda)
    c1, c2 = P._key_words(keys, "cpu")
    assert torch.equal(k1.cpu(), c1) and torch.equal(k2.cpu(), c2)


def _ellipse_masks(seed, n, h, w):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for _ in range(n):
        cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
        ry, rx = rng.uniform(0.15, 0.4) * h, rng.uniform(0.15, 0.4) * w
        m = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1
        out.append(m ^ (rng.random((h, w)) < 0.02))
    return torch.from_numpy(np.stack(out).astype(np.float32))


@pytest.mark.parametrize("hw,lanes", [((120, 160), 10), ((256, 192), 10),
                                      ((1024, 768), 2)])
def test_grabcut_mask_energy_lanes_equal_one_lane_calls(cuda, hw, lanes):
    """On the card, the standardized energy of each lane equals a one-lane
    call's bit for bit: ten lanes at the polish's coarse search, two at
    the full-resolution acceptance (config 4's 1024 x 768)."""
    from image_segmenter_tpu_torch.solvers import grabcut as GC
    from image_segmenter_tpu_torch.utils.seeds import portrait_scene

    img, _ = portrait_scene(*hw, 5)
    im = GC.prepare(torch.from_numpy(img).to(cuda))
    masks = _ellipse_masks(6, lanes, *hw).to(cuda)
    batched = GC.mask_energy(im, masks)
    single = torch.cat([GC.mask_energy(im, m[None]) for m in masks])
    assert torch.equal(batched, single), (batched - single).abs().max()


def test_grabcut_mask_energy_card_matches_cpu(cuda):
    """The card's standardized energies within 1e-5 relative of the CPU's
    on the same masks (120 x 160, four lanes)."""
    from image_segmenter_tpu_torch.solvers import grabcut as GC
    from image_segmenter_tpu_torch.utils.seeds import portrait_scene

    img, _ = portrait_scene(120, 160, 5)
    masks = _ellipse_masks(7, 4, 120, 160)
    got = GC.mask_energy(GC.prepare(torch.from_numpy(img).to(cuda)),
                         masks.to(cuda)).cpu()
    ref = GC.mask_energy(GC.prepare(torch.from_numpy(img)), masks)
    rel = ((got.double() - ref.double()).abs() / ref.double().abs()).max()
    assert rel <= 1e-5, rel


def test_isnet_rembg_card_matches_cpu(cuda):
    """rembg with ISNet (1024 x 1024 input, seeded weights) on 384 x 512:
    sharp alpha agreement >= 0.99 between the card and the CPU (the bf16
    convolutions round by library), alpha in {0, 255}."""
    from image_segmenter_tpu_torch.utils.seeds import portrait_scene
    from image_segmenter_tpu_torch.compat.rembg_infer import \
        rembg_remove_bgr_to_rgba

    bgr, _ = portrait_scene(384, 512, 4)
    got = rembg_remove_bgr_to_rgba(bgr, model="isnet-general-use")
    ref = rembg_remove_bgr_to_rgba(bgr, model="isnet-general-use",
                                   device="cpu")
    assert got.shape == ref.shape == (384, 512, 4)
    assert np.isin(got[..., 3], (0, 255)).all()
    assert (got[..., 3] == ref[..., 3]).mean() >= 0.99


# ---------------------------------------------------------------------------
# region cleanup and tendrils: the card against the CPU (no kernel of their
# own; torch ops whose integer results must not depend on the device)
# ---------------------------------------------------------------------------

def _region_image(h, w, seed):
    rng = np.random.default_rng(seed)
    pal = rng.integers(0, 256, (6, 3)).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    idx = (yy // max(1, h // 5) + xx // max(1, w // 6)) % 6
    idx = np.where(rng.random((h, w)) < 0.08, rng.integers(0, 6, (h, w)), idx)
    img = np.zeros((h, w, 4), np.uint8)
    img[..., :3] = pal[idx]
    img[..., 3] = 255
    img[h // 8:h // 4, w // 8:w // 3, 3] = 0
    return img


def _spiral_ids(n):
    """A one-pixel-wide spiral corridor (tests/test_torch_connected_components
    .py has the same)."""
    g = np.zeros((n, n), np.int32)
    y, x, dy, dx = 0, 0, 0, 1
    seen = np.zeros((n, n), bool)
    for _ in range(n * n):
        g[y, x] = 1
        seen[y, x] = True
        ny, nx = y + 2 * dy, x + 2 * dx
        if not (0 <= ny < n and 0 <= nx < n) or seen[ny, nx]:
            dy, dx = dx, -dy
            ny, nx = y + 2 * dy, x + 2 * dx
            if not (0 <= ny < n and 0 <= nx < n) or seen[ny, nx]:
                break
        for _ in range(2):
            y, x = y + dy, x + dx
            g[y, x] = 1
            seen[y, x] = True
    return g


@pytest.mark.parametrize("conn", [4, 8])
@pytest.mark.parametrize("shape", [(37, 53), (1, 60), (60, 1), (120, 160),
                                   "spiral"])
def test_component_stats_card_equals_cpu(cuda, shape, conn):
    from image_segmenter_tpu_torch.ops import connected_components as CC

    rng = np.random.default_rng(5)
    if shape == "spiral":
        cid = _spiral_ids(63)
        valid = np.ones(cid.shape, bool)
    else:
        cid = rng.integers(0, 3, shape).astype(np.int32)
        valid = rng.random(shape) > 0.1
    cpu = CC.component_stats(torch.as_tensor(cid), torch.as_tensor(valid), conn)
    card = CC.component_stats(torch.as_tensor(cid, device=cuda),
                              torch.as_tensor(valid, device=cuda), conn)
    for a, b in zip(cpu, card):
        assert torch.equal(a, b.cpu())


def test_chunked_fixpoint_on_the_card(cuda, monkeypatch):
    from image_segmenter_tpu_torch.ops import connected_components as CC

    img = _region_image(120, 160, 3)
    cid = torch.as_tensor(img[..., :3].astype(np.int64), device=cuda)
    key = (cid[..., 0] << 16) | (cid[..., 1] << 8) | cid[..., 2]
    valid = torch.as_tensor(img[..., 3] > 0, device=cuda)
    out = {}
    for n in (1, 4):
        monkeypatch.setattr(CC, "SWEEPS_PER_READ", n)
        out[n] = CC.label_components(key, valid, 8)
    assert torch.equal(out[1], out[4])


def test_region_cleanup_card_equals_cpu(cuda):
    from image_segmenter_tpu_torch.compat import region_cleanup as RC
    from image_segmenter_tpu_torch.compat import tendril_trimming as TT

    img = _region_image(120, 160, 0)
    for conn in (4, 8):
        np.testing.assert_array_equal(
            RC.merge_small_regions(img, 40, connectivity=conn, device="cuda"),
            RC.merge_small_regions(img, 40, connectivity=conn, device="cpu"))
        np.testing.assert_array_equal(
            RC.get_region_boundaries(img, conn, device="cuda"),
            RC.get_region_boundaries(img, conn, device="cpu"))
    for thr in (1, 2, 3):
        g, gi, _ = TT.trim_tendrils(img, thr, device="cuda")
        c, ci, _ = TT.trim_tendrils(img, thr, device="cpu")
        np.testing.assert_array_equal(g, c)
        assert gi == ci


def test_train_step_card_matches_cpu(cuda):
    """One U^2-Netp training step (64 x 64, batch 2) from the same seeded
    weights on the card and on the CPU, float32 without TF32: the loss
    within 1e-4 relative, each gradient within 0.25 relative L2 and their
    median within 0.1, the new BatchNorm statistics within 1e-3. The
    bounds are those tests/test_torch_train.py holds the CPU to against
    the JAX package: the training BatchNorms over the tiny innermost maps
    make float32 gradients differ by some percent with the order of sums
    (the conv biases ahead of a BatchNorm, 0 in exact arithmetic, to 1e-4
    absolute)."""
    from image_segmenter_tpu_torch.models.u2net import U2NET
    from image_segmenter_tpu_torch.pipeline import train as TR

    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.standard_normal((2, 3, 64, 64))
                            .astype(np.float32))
    masks = torch.from_numpy((rng.random((2, 64, 64)) > 0.6)
                             .astype(np.float32))
    out = {}
    for dev in ("cpu", "cuda"):
        module = U2NET(small=True).to(dev)
        tx, state = TR.create_train_state(module, seed=0)
        loss, grads, stats = TR.loss_and_grads(module, state, imgs.to(dev),
                                               masks.to(dev))
        out[dev] = (float(loss), {k: v.cpu() for k, v in grads.items()},
                    {k: v.cpu() for k, v in stats.items()})
    (lc, gc, sc), (lg, gg, sg) = out["cpu"], out["cuda"]
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    rel = []
    for k, g in gg.items():
        if k.endswith("conv_s1.bias"):
            assert g.abs().max() <= 1e-4 and gc[k].abs().max() <= 1e-4, k
            continue
        rel.append(float((g - gc[k]).norm() / gc[k].norm().clamp_min(1e-30)))
        assert rel[-1] <= 0.25, k
    assert np.median(rel) <= 0.1
    for k, v in sg.items():
        assert (v - sc[k]).abs().max() <= 1e-3, k


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_row_split_train_step_card_matches_one_slot(cuda, shape):
    """`shard_train_step` with the rows split over slots of the card
    (U^2-Netp, 4 x 64 x 64, standard normal images) against the one-slot
    step from the same state, for 2 steps, under chip_smoke phase 16's
    bounds: each step's loss within 1e-4 relative; after step 1 the fuse
    conv (graft_entry.HELD_PARAMS) within 1e-4 and the statistics within
    1e-3; every parameter moved."""
    from image_segmenter_tpu_torch import graft_entry as G
    from image_segmenter_tpu_torch.models.u2net import U2NET
    from image_segmenter_tpu_torch.parallel import mesh as PM
    from image_segmenter_tpu_torch.pipeline import train as TR

    module = U2NET(small=True).to(cuda)
    tx, state0 = TR.create_train_state(module, seed=0)
    step = TR.make_train_step(module, tx)
    imgs, masks = (t.to(cuda) for t in G.train_batch(4, 64))
    sharded = TR.shard_train_step(
        step, PM.make_mesh(shape, devices=[cuda] * (shape[0] * shape[1])))
    state = state0
    for i in range(2):
        new, loss = sharded(state, imgs, masks)
        ref, loss_1 = step(state, imgs, masks)
        assert abs(float(loss) - float(loss_1)) <= 1e-4 * abs(float(loss_1))
        if i == 0:
            for k in G.HELD_PARAMS:
                assert (new.params[k] - ref.params[k]).abs().max() <= 1e-4, k
            for k, v in new.batch_stats.items():
                assert (v - ref.batch_stats[k]).abs().max() <= 1e-3, k
        state = new
    for k, v in state.params.items():
        assert (v - state0.params[k]).abs().max() > 0, k


def test_bench_headline_on_the_card(cuda, monkeypatch, capsys):
    """The bench at 1 x 540 x 960 on the card prints one stdout line that
    parses, with every field, the card's label and the main path's
    kernels launched."""
    import json

    from image_segmenter_tpu_torch.bench import bench as B

    for k, v in {"BENCH_H": "540", "BENCH_W": "960", "BENCH_BATCH": "1",
                 "BENCH_REPS": "1", "BENCH_SECONDARY": "none"}.items():
        monkeypatch.setenv(k, v)
    assert B.main([]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1, lines
    rec = json.loads(lines[0])
    assert set(B.FIELDS) <= set(rec)
    assert rec["metric"] == "pipeline_u2netp_matting_kmeans16_540x960_b1"
    assert rec["value"] > 0 and rec["device_resident_mp_s"] > 0
    assert rec["card"] == B.card_label(cuda) and rec["h2d_gbs"]["pre"] > 0
    assert all(n > 0 for n in rec["launches"].values()), rec["launches"]


def _cg_bits(loop):
    """The loop-carried state, floats as their bits (NaN equals NaN)."""
    out = {"x": loop.x.blocks[0], "r": loop.r.blocks[0],
           "p": loop.p.blocks[0], "rz": loop.rz, "pending": loop.pending,
           "it": loop.it, "active": loop.active, "flag": loop.flag}
    return {k: v.view(torch.int32) if v.dtype == torch.float32 else v
            for k, v in out.items()}


@pytest.mark.parametrize("bhw,case,chunk", [((4, 2160, 3840), "all", 8),
                                            ((4, 2160, 3840), "all", 3),
                                            ((1, 1080, 1920), "breakdown", 8),
                                            ((1, 1080, 1920), "non-finite",
                                             8)])
def test_fused_cg_step_is_the_plain_step(cuda, bhw, case, chunk,
                                         monkeypatch):
    """The CG of `Pipeline.run` on photo mosaics of the corpus (matting at
    4 x 576 x 1024 and 1 x 576 x 1024): a chunk through kernels/cg_update
    (`_step_fused`, the path CGLoop takes on the card) against a chunk
    through `_body`, bit for bit on x, r, p, rz, pending, it, active and
    the flag after every chunk. "all": image 0 as it comes, image 1 starts
    with a restart pending, image 2 with p = 0 (a breakdown at the noise
    floor, then a restart), image 3 gets an infinite residual entry once 8
    iterations have run and stops at the next, inside a chunk;
    "breakdown": p = 0 at the start; "non-finite": the infinite entry.
    A chunk of 3 iterations ends on the second scalar state, which the
    fused step copies back."""
    from image_segmenter_tpu_torch.bench.bench import photo_batch
    from image_segmenter_tpu_torch.kernels import cg_update as KCG
    from image_segmenter_tpu_torch.pipeline.segment import Pipeline
    from image_segmenter_tpu_torch.solvers import matting as MAT

    monkeypatch.setattr(MAT, "CG_CHUNK", chunk)

    pipe = Pipeline(model="u2netp", k=16, device="cuda")
    x = torch.from_numpy(photo_batch(*bhw)).to(cuda)
    mask = pipe.stages.cnn(pipe.session.module, x)
    fused, plain = (next(pipe.stages.matting_program(x, mask))
                    for _ in range(2))
    assert fused.update == "fused" and fused.x.blocks[0].shape[1:] == (
        576, 1024)
    b = bhw[0]
    inf_lane = {"all": 3, "non-finite": 0}.get(case)
    for loop in (fused, plain):
        if case == "all":
            loop.pending[1] = True
        if case in ("all", "breakdown"):
            loop.p.blocks[0][2 if case == "all" else 0] = 0.0
    hit, chunks = None, 0
    while bool(plain.flag):
        if inf_lane is not None and hit is None and int(plain.it.max()) >= 8:
            hit = int(plain.it[inf_lane])
            for loop in (fused, plain):
                loop.r.blocks[0][inf_lane, 100, 200] = float("inf")
        k3, cu = KMV.LAUNCHES, KCG.LAUNCHES
        fused.step()
        assert (KMV.LAUNCHES - k3, KCG.LAUNCHES - cu) == (chunk, 3 * chunk)
        plain._step_plain()
        chunks += 1
        got, want = _cg_bits(fused), _cg_bits(plain)
        for name in want:
            assert torch.equal(got[name], want[name]), (chunks, name)
    it = plain.it.tolist()
    assert not bool(fused.flag) and chunks >= 2 and len(it) == b
    if inf_lane is not None:
        assert it[inf_lane] == hit + 1
    for a, c in zip(fused.finish()[:4], plain.finish()[:4]):
        assert torch.equal(a, c)


def test_main_path_keeps_its_sha256(cuda):
    """`Pipeline.run` on chip_smoke's phase-4 batch, compiled (its CG
    through the fused update, counted at each replay) and eager, gives
    chip_smoke's MAIN_PATH_SHA256."""
    import chip_smoke as C

    from image_segmenter_tpu_torch.bench.micro_precompute_hist import _sha
    from image_segmenter_tpu_torch.kernels import cg_update as KCG
    from image_segmenter_tpu_torch.pipeline.segment import Pipeline

    pipe = Pipeline(model="u2netp", k=16, device="cuda")
    x = torch.from_numpy(C.photo_batch(C.BATCH, C.H4K, C.W4K, seed=0)) \
        .to(cuda)
    pipe.run(x)  # warm-up and capture
    k3, cu = KMV.LAUNCHES, KCG.LAUNCHES
    out = pipe.run(x)
    torch.cuda.synchronize()
    assert KCG.LAUNCHES - cu == 3 * (KMV.LAUNCHES - k3 - 1) > 0
    for got in (out, pipe.run_eager(x)):
        sha = {name: _sha(t) for name, t in zip(got._fields, got)}
        assert sha == C.MAIN_PATH_SHA256


# ---------------------------------------------------------------------------
# SAM's encoder attention (kernels/sam_attention.py)
# ---------------------------------------------------------------------------

def _sam_attn_operands(dev, b, nh, h, w, d, seed):
    """q, k, v as views of one (b, h w, 3 nh d) bfloat16 projection, rel_h
    and rel_w from models/sam.Attention's einsums (chip_smoke's)."""
    import chip_smoke as C

    return C.sam_attn_operands(dev, b, nh, h, w, d, seed)


def _assert_attention_close(got, ref, ops):
    """The kernel and its plain version round the same bias and sum in
    float32; they differ where P is rounded to bfloat16 against another
    running maximum (each weight by at most 2^-7 relative between the two,
    so the output by at most 2^-7 of the row's probability-weighted |v|)
    and in the output's last bit (2^-7 of |ref| where the float32 values
    straddle a rounding): chip_smoke.sam_attn_tolerance, elementwise."""
    import chip_smoke as C

    diff = (got.float() - ref.float()).abs()
    tol = C.sam_attn_tolerance(ops, ref)
    assert bool((diff <= tol).all()), float((diff / tol).max())


SAM_ATTN_SHAPES = {  # (B', heads, h, w, d)
    "vith_global": (4, 16, 64, 64, 80),
    "vith_window": (100, 16, 14, 14, 80),
    "vitb_global": (4, 12, 64, 64, 64),
    "tiny_window": (18, 2, 4, 4, 16),
    "tiny_global": (2, 2, 10, 10, 16),
    "ragged": (3, 5, 7, 9, 64),
    "wide_rows": (2, 3, 5, 40, 16),
}


@pytest.mark.parametrize("shape", list(SAM_ATTN_SHAPES))
def test_sam_attention_kernel_matches_its_plain_version(cuda, shape):
    """ViT-H's global (4 x 16 x 4096, d 80, a 64 x 64 grid: key tiles of
    one grid row) and windowed (100 x 16 x 196, d 80, 14 x 14: tiles of
    two grid rows of 16 slots, 14 of them keys, the last tile half off
    the grid) attention, ViT-B's global one, the test config's, an odd
    grid and one of 40-key rows in 64-slot tiles, against the plain
    version on the same strided views; one launch a call."""
    b, nh, h, w, d = SAM_ATTN_SHAPES[shape]
    ops = _sam_attn_operands(cuda, b, nh, h, w, d, seed=b + d)
    before = SA.LAUNCHES
    got = SA.attention(*ops)
    assert SA.LAUNCHES == before + 1
    assert got.shape == (b, h * w, nh * d) and got.dtype == torch.bfloat16
    _assert_attention_close(got, SA.attention_plain(*ops), ops)
    # a dropped bias is far outside that tolerance
    zero = torch.zeros_like(ops[3])
    moved = (SA.attention(*ops[:3], zero, ops[4], ops[5]).float()
             - got.float()).abs().max()
    assert float(moved) > 8 * 2 ** -8 * float(ops[2].float().abs().max())


def test_sam_attention_kernel_replays_from_a_cuda_graph(cuda):
    """At ViT-H's two shapes, the kernel captured in a CUDA graph and
    replayed gives the eager call's bits; the capture counts one launch
    each and the replays none (pipeline/compiled.py adds them)."""
    runs = []
    for shape in ("vith_global", "vith_window"):
        ops = _sam_attn_operands(cuda, *SAM_ATTN_SHAPES[shape], seed=3)
        runs.append((ops, SA.attention(*ops)))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    before = SA.LAUNCHES
    with torch.cuda.stream(side), torch.cuda.graph(graph, stream=side):
        outs = [SA.attention(*ops) for ops, _ in runs]
    assert SA.LAUNCHES == before + 2
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert SA.LAUNCHES == before + 2
    for out, (_, eager) in zip(outs, runs):
        assert torch.equal(out, eager)


def test_sam_attention_refuses_card_inputs_it_does_not_take(cuda):
    ops = list(_sam_attn_operands(cuda, 2, 2, 4, 4, 16, seed=1))
    with pytest.raises(ValueError, match="bfloat16"):
        SA.attention(*[t.float() for t in ops[:5]], ops[5])
    odd = _sam_attn_operands(cuda, 2, 2, 4, 4, 48, seed=1)
    with pytest.raises(ValueError, match="head dim"):
        SA.attention(*odd)
    wide = _sam_attn_operands(cuda, 1, 1, 2, 72, 16, seed=1)
    with pytest.raises(ValueError, match="do not fit"):
        SA.attention(*wide)
    with pytest.raises(ValueError, match="stride"):
        SA.attention(ops[0].transpose(2, 3), *ops[1:])


def test_sam_encoder_launches_the_attention_kernel_once_a_block(
        cuda, monkeypatch):
    """A bfloat16 encoder of the test config (4 blocks, two windowed, two
    global) on the card: one launch a block, and no call of
    F.scaled_dot_product_attention."""
    import torch.nn.functional as F

    from image_segmenter_tpu_torch.models import sam as S

    def refuse(*args, **kwargs):
        raise AssertionError("the encoder called SDPA")

    monkeypatch.setattr(F, "scaled_dot_product_attention", refuse)
    cfg = S.SamConfig(embed_dim=32, depth=4, num_heads=2,
                      global_attn_indexes=(1, 3), window_size=4,
                      patch_size=16, img_size=160, prompt_dim=32)
    m = S.Sam(cfg, half=True).to(cuda)
    S.seeded_init(m, torch.Generator(device=cuda).manual_seed(1))
    before = SA.LAUNCHES
    with torch.no_grad():
        m.image_encoder(torch.randn(2, 3, 160, 160, device=cuda),
                        torch.bfloat16)
    assert SA.LAUNCHES - before == cfg.depth


# ---------------------------------------------------------------------------
# RS: resizes as one banded kernel (kernels/resample, csrc/resample.cu)
# ---------------------------------------------------------------------------

RESIZE_METHODS = ("area", "linear", "lanczos_pil", "bilinear_pil",
                  "nearest_cv", "nearest_pil")
# (src, dst): the 4K main path's (the CNN's 320 input and its mask back,
# the matting's 576 x 1024 shrink and its alpha back; SAM's BILINEAR_PIL
# to 576 x 1024 is the shrink's shape), ISNet's 1024 and 1080p's
RESAMPLE_SHAPES = [((2160, 3840), (320, 320)), ((320, 320), (2160, 3840)),
                   ((2160, 3840), (576, 1024)), ((576, 1024), (2160, 3840)),
                   ((2160, 3840), (1024, 1024)),
                   ((1024, 1024), (2160, 3840)),
                   ((1080, 1920), (320, 320)), ((320, 320), (1080, 1920)),
                   ((1080, 1920), (576, 1024)), ((576, 1024), (1080, 1920))]


def _u8(g, shape, dev):
    return torch.randint(0, 256, shape, generator=g, device=dev,
                         dtype=torch.uint8)


def _layout(t):
    """The strides of the dimensions longer than 1: a dimension of one
    element has no layout of its own."""
    return [st for st, n in zip(t.stride(), t.shape) if n > 1]


@pytest.mark.parametrize("src,dst", RESAMPLE_SHAPES)
@pytest.mark.parametrize("method", RESIZE_METHODS)
def test_resample_kernel_is_the_dense_bytes(cuda, method, src, dst):
    """One launch a resize, byte for byte the dense float64 contraction
    (`resize_u8_plain`, cuBLAS on the card) and in its layout (what a
    reduction after it sums in follows the layout), batch 1 and 4, one
    channel and three."""
    from image_segmenter_tpu_torch.ops import resize as RZ

    g = _gen(cuda, 5)
    for b in (1, 4):
        for shape in ((b, *src), (b, *src, 3)):
            x = _u8(g, shape, cuda)
            before = RS.LAUNCHES
            got = RZ.resize_u8(x, dst, method)
            assert RS.LAUNCHES == before + 1
            ref = RZ.resize_u8_plain(x, dst, method)
            assert got.shape == ref.shape and _layout(got) == _layout(ref)
            assert torch.equal(got, ref), (shape, int((got != ref).sum()))


@pytest.mark.parametrize("method", RESIZE_METHODS)
def test_resample_kernel_odd_shapes(cuda, method):
    """One-pixel and odd sizes, a view of three channels of four, four
    channels, one output column that reads a whole row: the dense bytes
    and layout. The same size is a copy, with no launch."""
    from image_segmenter_tpu_torch.ops import resize as RZ

    g = _gen(cuda, 6)
    rgba = _u8(g, (2, 61, 97, 4), cuda)
    cases = [(_u8(g, (1, 1, 1), cuda), (7, 5)),
             (_u8(g, (2, 97, 61), cuda), (1, 1)),
             (_u8(g, (3, 23, 37, 3), cuda), (61, 97)),
             (rgba[..., :3], (23, 37)), (rgba, (40, 130)),
             (_u8(g, (1, 5, 3000, 3), cuda), (2, 1))]
    for x, dst in cases:
        got = RZ.resize_u8(x, dst, method)
        ref = RZ.resize_u8_plain(x, dst, method)
        assert torch.equal(got, ref) and _layout(got) == _layout(ref), \
            (tuple(x.shape), dst)
    before = RS.LAUNCHES
    for x in (rgba, rgba[..., :3]):
        same = RZ.resize_u8(x, (61, 97), method)
        ref = RZ.resize_u8_plain(x, (61, 97), method)
        assert RS.LAUNCHES == before and torch.equal(same, x)
        assert _layout(same) == _layout(ref)


@pytest.mark.parametrize("model", ["u2netp", "isnet-general-use"])
def test_pipeline_launches_the_resample_kernel_once_a_resize(cuda, model):
    """A replayed `Pipeline.run` carries kernels/resample's counter: five
    launches a call (the CNN's input and its mask back, the matting's two
    shrinks and its alpha back), as the eager run; no float64 GEMM runs."""
    from torch.profiler import ProfilerActivity, profile

    from image_segmenter_tpu_torch.pipeline import segment as SEG

    pipe = SEG.Pipeline(model=model, k=16, matting_dim=128, device="cuda")
    x = torch.from_numpy(_photo_like(2, 240, 320, 0)).to(cuda)
    pipe.run(x)  # warm-up and capture
    for run in (pipe.run, pipe.run_eager):
        before = RS.LAUNCHES
        run(x)
        assert RS.LAUNCHES - before == 5
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pipe.run(x)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    assert any("resample" in n for n in names)
    assert not any("gemm_f64" in n or "f64f64" in n for n in names)


# BiRefNet's deformable convolution: (H, W) of the decoder's scales at
# 1024 x 1024 and the branches' kernels, batch 4
DEFORM_SHAPES = [(hw, k) for hw in (32, 64, 128, 256) for k in (1, 3, 7)]


def _deform_operands(dev, hw, k, seed):
    """chip_smoke's operands: offsets N(0, 2^2) with one tap in 16 thrown
    outside the image, modulators in (0, 2), a (256, k, k, 64) bfloat16
    weight and a bias."""
    g = _gen(dev, seed)
    cl = torch.channels_last
    x = torch.randn(4, 64, hw, hw, generator=g, device=dev).to(
        torch.bfloat16, memory_format=cl)
    off = 2.0 * torch.randn(4, 2 * k * k, hw, hw, generator=g, device=dev)
    far = torch.rand(off.shape, generator=g, device=dev) < 1 / 16
    off = torch.where(far, off.sign() * 3.0 * hw, off)
    mask = 2.0 * torch.rand(4, k * k, hw, hw, generator=g, device=dev)
    wt = (torch.randn(256, k, k, 64, generator=g, device=dev)
          / (8.0 * k)).to(torch.bfloat16)
    bias = 0.1 * torch.randn(256, generator=g, device=dev)
    return (x, off.contiguous(memory_format=cl),
            mask.contiguous(memory_format=cl), wt, bias)


@pytest.mark.parametrize("hw,k", DEFORM_SHAPES)
def test_deform_conv_kernel_matches_its_plain_version(cuda, hw, k):
    """The same bfloat16 operand of samples on both sides; the sums in
    float32 in other orders and each result rounded to bfloat16: within
    2^-7 of |ref| and 2^-12 of the largest output (chip_smoke's
    tolerance)."""
    from image_segmenter_tpu_torch.kernels import deform_conv as KDC

    ops = _deform_operands(cuda, hw, k, seed=hw + k)
    before = KDC.LAUNCHES
    got = KDC.deform_conv(*ops, relu=True)
    assert KDC.LAUNCHES == before + 1
    ref = KDC.deform_conv_plain(*ops, relu=True, rows=16)
    r = ref.float().abs()
    tol = 2 ** -7 * r + 2 ** -12 * float(r.max())
    assert bool(((got.float() - ref.float()).abs() <= tol).all())
    # into a channel slice of the branches' concatenation
    cat = torch.zeros((4, 1280, hw, hw), dtype=torch.bfloat16,
                      device=cuda).to(memory_format=torch.channels_last)
    KDC.deform_conv(*ops, relu=True, out=cat[:, 256:512])
    assert torch.equal(cat[:, 256:512], got)
    assert not bool(cat[:, :256].any()) and not bool(cat[:, 512:].any())


@pytest.mark.parametrize("what", ["x_float32", "weight_float32",
                                  "x_not_channels_last", "in_channels_32"])
def test_deform_conv_kernel_refuses_card_inputs_it_does_not_take(cuda, what):
    """A CUDA input the kernel does not take raises: no plain gather runs
    on the card, and nothing is launched."""
    from image_segmenter_tpu_torch.kernels import deform_conv as KDC

    x, off, mask, wt, bias = _deform_operands(cuda, 32, 3, seed=5)
    if what == "x_float32":
        x = x.float().contiguous(memory_format=torch.channels_last)
    elif what == "weight_float32":
        wt = wt.float()
    elif what == "x_not_channels_last":
        x = x.contiguous()
    else:
        x, wt = x[:, :32].contiguous(memory_format=torch.channels_last), \
            wt[..., :32].contiguous()
    before = KDC.LAUNCHES
    with pytest.raises(ValueError):
        KDC.deform_conv(x, off, mask, wt, bias, relu=True)
    assert KDC.LAUNCHES == before


def test_birefnet_float32_network_raises_on_the_card(cuda):
    """half=False is float32 op for op, which the window attention and
    deformable kernels do not take: on the card its first Swin block
    raises."""
    from image_segmenter_tpu_torch.models import birefnet as BRN

    cfg = BRN.BiRefNetConfig(embed_dim=24, depths=(2, 2, 2, 2),
                             num_heads=(1, 2, 4, 8))
    net = BRN.BiRefNet(cfg, half=False).to(cuda)
    BRN.seeded_init(net, torch.Generator(device=cuda).manual_seed(3))
    with pytest.raises(ValueError), torch.no_grad():
        net(torch.randn(1, 3, 160, 160, device=cuda))


def test_birefnet_pipeline_runs_on_the_card(cuda):
    """Pipeline(model="birefnet-general").run once at 4 x 2160 x 3840,
    compiled: 20 deformable launches, 48 window-attention launches (one a
    Swin block, 24 at each of two scales) and 4 frames a replayed call,
    the outputs' shapes, a replay bit-identical."""
    from image_segmenter_tpu_torch.kernels import deform_conv as KDC
    from image_segmenter_tpu_torch.models import birefnet as BRN
    from image_segmenter_tpu_torch.pipeline.segment import Pipeline

    rng = np.random.default_rng(26)
    x = rng.integers(0, 256, (4, 2160, 3840, 3), dtype=np.uint8)
    pipe = Pipeline(model="birefnet-general", k=16, device="cuda")
    first = pipe.run(x)
    n0, s0, f0 = KDC.LAUNCHES, KSW.LAUNCHES, BRN.FRAMES
    out = pipe.run(x)
    torch.cuda.synchronize()
    assert KDC.LAUNCHES - n0 == 20 and BRN.FRAMES - f0 == 4
    assert KSW.LAUNCHES - s0 == 48
    assert out.rgba.shape == (4, 2160, 3840, 4)
    assert out.palettes.shape == (4, 16, 3)
    assert all(torch.equal(a, b) for a, b in zip(first, out))


# ---------------------------------------------------------------------------
# BiRefNet's window attention (kernels/swin_attention, csrc/swin_attention.cu)
# ---------------------------------------------------------------------------

# (grid side, heads) of Swin-L's stages in a BiRefNet call at 1024 x 1024
# and at its half-size copy; the sides pad to 264, 132, 72, 36 and 24
SWIN_GRIDS = [(256, 6), (128, 6), (128, 12), (64, 12), (64, 24), (32, 24),
              (32, 48), (16, 48)]


def _swin_operands(dev, b, h, w, heads, shift, seed):
    """A block's qkv projection (b, h, w, 3C) bfloat16 and its bias, N(0, 1);
    a N(0, 1) table (as seeded_init draws it) in a WindowAttention, whose
    mask the plain version takes; the scale."""
    from image_segmenter_tpu_torch.models import birefnet as BRN

    g = _gen(dev, seed)
    c = heads * KSW.HEAD_DIM
    qkv = torch.randn(b, h, w, 3 * c, generator=g, device=dev).to(
        torch.bfloat16)
    bias = torch.randn(3 * c, generator=g, device=dev).to(torch.bfloat16)
    attn = BRN.WindowAttention(c, KSW.WINDOW, heads).to(dev)
    with torch.no_grad():
        attn.relative_position_bias_table.normal_(generator=g)
    ws = KSW.WINDOW
    mask = attn.mask(-(-h // ws) * ws, -(-w // ws) * ws, shift,
                     torch.bfloat16, dev)
    return qkv, bias, attn.relative_position_bias_table.detach(), mask, \
        attn.scale


def _assert_swin_close(got, qkv, bias, mask, shift, scale):
    """Within one bfloat16 unit of the plain version: 2^-7 of the row's
    probability-weighted |v| (each side rounds its unnormalised
    probabilities to bfloat16, SDPA against its running maximum) and of
    |ref| (each rounds the output). Returns the plain output."""
    ref = KSW.attention_plain(qkv, bias, mask, shift, scale)
    c = qkv.shape[-1] // 3
    qa, ba = qkv.clone(), bias.clone()
    qa[..., 2 * c:] = qa[..., 2 * c:].abs()
    ba[2 * c:] = ba[2 * c:].abs()
    wv = KSW.attention_plain(qa, ba, mask, shift, scale)
    tol = 2 ** -7 * (wv.float() + ref.float().abs())
    assert bool(((got.float() - ref.float()).abs() <= tol).all())
    return ref


@pytest.mark.parametrize("shift", [0, 6])
@pytest.mark.parametrize("side,heads", SWIN_GRIDS)
def test_swin_attention_kernel_matches_its_plain_version(cuda, side, heads,
                                                         shift):
    """Every grid of Swin-L's stages, batch 4, unshifted and shifted: one
    launch a call, within one bfloat16 unit of the plain version (the
    windows, the mask and SDPA materialised); a zeroed table moves the
    output far outside that."""
    qkv, bias, table, mask, scale = _swin_operands(
        cuda, 4, side, side, heads, shift, seed=side + heads + shift)
    before = KSW.LAUNCHES
    got = KSW.attention(qkv, bias, table, shift, scale)
    assert KSW.LAUNCHES == before + 1
    assert got.shape == (4, side, side, heads * KSW.HEAD_DIM)
    assert got.dtype == torch.bfloat16
    _assert_swin_close(got, qkv, bias, mask, shift, scale)
    moved = KSW.attention(qkv, bias, torch.zeros_like(table), shift, scale)
    assert float((moved.float() - got.float()).abs().max()) > 0.1


@pytest.mark.parametrize("shift", [0, 6])
@pytest.mark.parametrize("h,w", [(13, 25), (3, 5), (24, 12), (1, 1)])
def test_swin_attention_kernel_at_ragged_grids(cuda, h, w, shift):
    """Grids that pad on one side or both, one smaller than a window (all
    four regions of the roll in one window), one that pads on neither
    and a single token, two frames, a qkv read as a slice of a wider
    projection; and inside a CUDA graph, whose replay gives the eager
    bits."""
    qkv, bias, table, mask, scale = _swin_operands(cuda, 2, h, w, 2, shift,
                                                   seed=h * w + shift)
    wide = torch.zeros(2, h, w, qkv.shape[-1] + 8, dtype=qkv.dtype,
                       device=cuda)
    wide[..., 8:] = qkv
    got = KSW.attention(wide[..., 8:], bias, table, shift, scale)
    _assert_swin_close(got, qkv, bias, mask, shift, scale)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.cuda.graph(graph, stream=side):
        out = KSW.attention(qkv, bias, table, shift, scale)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, KSW.attention(qkv, bias, table, shift, scale))


def test_swin_attention_refuses_card_inputs_it_does_not_take(cuda):
    """float32, a head dim of 24, an odd shift, a last stride other than 1:
    each raises before a launch; there is no fallback."""
    qkv, bias, table, _, scale = _swin_operands(cuda, 1, 24, 24, 2, 6, seed=1)
    before = KSW.LAUNCHES
    with pytest.raises(ValueError, match="bfloat16"):
        KSW.attention(qkv.float(), bias.float(), table, 6, scale)
    with pytest.raises(ValueError, match="head dim"):
        KSW.attention(qkv[..., :144], bias[:144], table, 6, scale)
    with pytest.raises(ValueError, match="shift"):
        KSW.attention(qkv, bias, table, 5, scale)
    t = qkv.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="strides"):
        KSW.attention(t, bias, table, 6, scale)
    assert KSW.LAUNCHES == before


def test_birefnet_load_state_dict_remakes_the_derived_copies_on_the_card(
        cuda):
    """tests/test_torch_birefnet.py's test on the card, with heads of 32
    (embed 32) for the kernel: after a load the network gives the logits
    of the state it came from, one window-attention launch a Swin block
    (16 with these depths at two scales), and the kernel reads the loaded
    table itself: a change to one table after the load moves the
    logits."""
    from image_segmenter_tpu_torch.models import birefnet as BRN

    cfg = BRN.BiRefNetConfig(embed_dim=32, depths=(2, 2, 2, 2),
                             num_heads=(1, 2, 4, 8))
    a = BRN.BiRefNet(cfg, half=True).to(cuda)
    BRN.seeded_init(a, torch.Generator(device=cuda).manual_seed(1))
    b = BRN.BiRefNet(cfg, half=True).to(cuda)
    BRN.seeded_init(b, torch.Generator(device=cuda).manual_seed(2))
    x = torch.randn(1, 3, 160, 160, device=cuda)
    with torch.no_grad():
        la, lb = a(x)[0], b(x)[0]
        b.load_state_dict(a.state_dict())
        before = KSW.LAUNCHES
        assert torch.equal(b(x)[0], la)
        assert KSW.LAUNCHES - before == 16
        table = b.bb.layers[0].blocks[1].attn.relative_position_bias_table
        table.normal_(generator=torch.Generator(device=cuda).manual_seed(3))
        assert not torch.equal(b(x)[0], la)
    assert not torch.equal(la, lb)
