"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without an NVIDIA GPU. This
file imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from image_segmenter_tpu_torch.kernels import histogram as KH
from image_segmenter_tpu_torch.kernels import matting as K6
from image_segmenter_tpu_torch.kernels import matvec as KMV
from image_segmenter_tpu_torch.kernels import precompute as KP
from image_segmenter_tpu_torch.kernels import quantize as KQ

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


@pytest.mark.parametrize("shape", [(2, 3, 37, 53), (1, 3, 33, 130),
                                   (2, 3, 64, 96)])
def test_precompute_kernel_matches_plain(cuda, shape):
    """Same order of operations, no FMA contraction: within 1e-4 (abs or
    rel), in practice bit for bit."""
    img = torch.rand(shape, generator=_gen(cuda, 2), device=cuda)
    got = KP.precompute_planes(img, 1e-7)
    ref = KP.precompute_planes_plain(img, 1e-7)
    err = (got - ref).abs()
    rel = err / ref.abs().clamp_min(1e-30)
    assert float(torch.minimum(err, rel).max()) < 1e-4


@pytest.mark.parametrize("bhw", [(2, 37, 53), (1, 33, 130), (3, 64, 96)])
def test_matvec_kernel_matches_plain(cuda, bhw):
    g = _gen(cuda, 3)
    b, h, w = bhw
    img = torch.rand((b, 3, h, w), generator=g, device=cuda)
    planes = KP.precompute_planes(img, 1e-7)
    p = torch.randn((b, h, w), generator=g, device=cuda)
    got = KMV.matvec_planes(planes, img, p)
    ref = KMV.matvec_planes_plain(planes, img, p)
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5


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
    """K6 within 1e-5 of max|ref| of its plain version over its whole
    output (the partial sums next to the image included), and of K3's
    matvec inside the image."""
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
    k3 = KMV.matvec_planes(planes, img, p)
    assert float((got[:, :h, :w] - k3).abs().max()) / scale < 1e-5
    one = K6.matvec_planes(p_pad[0], static[0])  # the unbatched form
    assert torch.equal(one, got[0])


@pytest.mark.parametrize("bhw,k_real", [((2, 37, 53), 11), ((1, 128, 200), 16)])
def test_quantize_kernel_bit_exact(cuda, bhw, k_real):
    g = _gen(cuda, 4)
    rgb = torch.randint(0, 256, (*bhw, 3), generator=g, device=cuda,
                        dtype=torch.uint8)
    alpha = torch.rand(bhw, generator=g, device=cuda) > 0.3
    pal = torch.randint(0, 256, (bhw[0], 16, 3), generator=g,
                        device=cuda).float()
    pal[:, 4] = pal[:, 1]
    thr = torch.full((bhw[0],), 30.0, device=cuda)
    got = KQ.quantize_map(rgb, alpha, pal, k_real, thr)
    assert torch.equal(got, KQ.quantize_map_plain(rgb, alpha, pal, k_real, thr))


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
