"""The frozen reference against the port's plain (CPU) path, at tiny
sizes: each stage the same bits, and the whole reference, with the CNN at
the configuration's bfloat16 arithmetic, the same bytes as
`Pipeline.run` on the CPU."""

import numpy as np
import pytest
import torch

from benchmark.reference import nets, plain
from benchmark.reference.pipeline_run import Reference, judge
from benchmark.yardstick import weights

RNG = np.random.default_rng(11)


def _img(b=2, h=37, w=53):
    return torch.from_numpy(RNG.integers(0, 256, (b, h, w, 3), np.uint8))


@pytest.mark.parametrize("method", [plain.AREA, plain.LINEAR,
                                    plain.LANCZOS_PIL])
def test_resize(method):
    from image_segmenter_tpu_torch.ops import resize as RZ

    x = _img()
    for hw in ((20, 31), (64, 80)):
        assert torch.equal(plain.resize_u8(x, hw, method),
                           RZ.resize_u8(x, hw, method))


def test_histogram_otsu_trimap_and_morphology():
    from image_segmenter_tpu_torch.ops import histogram as HG
    from image_segmenter_tpu_torch.pipeline import segment as S

    a = _img()[..., 0]
    assert torch.equal(plain.histogram_u8(a), HG.histogram_u8(a))
    assert torch.equal(plain.otsu_threshold(a), HG.otsu_threshold(a))
    assert torch.equal(plain.trimap(a), S._trimap_device(a))
    assert torch.equal(plain.sharp_alpha(a), S._sharp_alpha(a))


def test_window_planes_matvec_and_cg():
    from image_segmenter_tpu_torch.kernels.matvec import matvec_planes_plain
    from image_segmenter_tpu_torch.kernels.precompute import \
        precompute_planes_plain
    from image_segmenter_tpu_torch.pipeline import segment as S

    rgb = _img(2, 29, 41)
    img = plain.true_div(rgb.to(torch.float32), 255.0).permute(0, 3, 1, 2) \
        .contiguous()
    planes = plain.window_planes(img, 1e-7)
    assert torch.equal(planes, precompute_planes_plain(img, 1e-7))
    p = torch.from_numpy(RNG.random((2, 29, 41), np.float32))
    assert torch.equal(
        plain.laplacian_matvec(img, planes[:, 7], planes[:, 8:11],
                               planes[:, 0:6], p),
        matvec_planes_plain(planes, img, p))
    a_s = _img(2, 29, 41)[..., 1]
    tri = plain.trimap(a_s)
    x0 = plain.true_div(a_s.to(torch.float32), 255.0)
    alpha, it = plain.cg_solve(plain.true_div(rgb.to(torch.float32), 255.0),
                               tri, x0, rtol=1e-4, max_iter=50, lowp=False)
    want, want_it = S.matting_solve_u8(rgb, tri, a_s, 50)
    got = torch.clamp(torch.floor(alpha * 255.0 + 0.5), 0, 255) \
        .to(torch.uint8)
    assert torch.equal(got, want) and torch.equal(it, want_it)


def test_quantize_stage():
    from image_segmenter_tpu_torch.pipeline import segment as S

    rgb = _img(2, 48, 64)
    sharp = torch.from_numpy(RNG.random((2, 48, 64)) > 0.3)
    got_rgb, got_pal = plain.quantize(rgb, sharp, 16, False)
    want_rgb, want_pal = S.drive(S._kmeans16_quantize_program(rgb, sharp, 16))
    assert torch.equal(got_rgb, want_rgb) and torch.equal(got_pal, want_pal)


@pytest.mark.parametrize("arch,size", [("u2netp", 64), ("isnet", 64)])
def test_nets_match_the_ports(arch, size):
    from image_segmenter_tpu_torch.models.u2net import ISNet, U2NET

    state = weights.make_state(arch, 3, "cpu")
    x = torch.from_numpy(RNG.standard_normal((1, 3, size, size),
                                             np.float32))
    for prec, half in (("f32", False), ("bf16", True)):
        ours = nets.build(arch, prec)
        ours.load_state_dict(state, assign=True)
        port = U2NET(small=True, half=half) if arch == "u2netp" \
            else ISNet(half=half)
        port.load_state_dict(state)
        with torch.no_grad():
            assert torch.equal(ours(x), port.eval()(x)[0])


def test_reference_is_the_ports_cpu_run_at_the_configurations_precision():
    from image_segmenter_tpu_torch.pipeline.segment import Pipeline

    cfg = {"arch": "u2netp", "input_size": [320, 320],
           "mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225],
           "k": 16, "cg_iters": 40, "matting_dim": 64}
    state = weights.make_state("u2netp", 5, "cpu")
    batch = _img(2, 60, 90).numpy()
    pipe = Pipeline(model="u2netp", k=16, matting_dim=64, cg_iters=40,
                    device="cpu")
    pipe.session.load_state_dict(state)
    out = {k: t.numpy() for k, t in zip(("rgba", "alpha", "palettes"),
                                         pipe.run(batch))}
    witness = Reference(cfg, state, "cpu", cnn="bf16")(batch)
    for k in out:
        assert np.array_equal(out[k], witness[k]), k
    got = judge(batch, out, Reference(cfg, state, "cpu"))
    assert got["rgba_mismatch"] == 0 and got["palette_mismatch"] == 0
    assert 0 <= got["alpha_mad"] < 4.0
