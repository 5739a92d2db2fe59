"""BiRefNet in the PyTorch port (models/birefnet.py, kernels/deform_conv.py)
against the plain reference (benchmark/reference/birefnet_plain.py), on
the CPU.

The JAX package has no BiRefNet, so the port is held to a plain PyTorch
forward written from the official code, on seeded random weights at a
small size: embed 24, depths (2, 2, 2, 2), heads (1, 2, 4, 8), the
published window 12 and decoder widths, image 160. Its token grids, 40,
20, 10 and 5 at 160 and 20, 10, 5 and 3 at the half-size copy, are no
multiples of 12, so every stage pads and every shifted block masks.
Published widths are checked by names, shapes and parameter counts only.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import birefnet_plain as BP
from image_segmenter_tpu_torch.kernels import deform_conv as KDC
from image_segmenter_tpu_torch.models import birefnet as B
from image_segmenter_tpu_torch.models import registry as TR
from image_segmenter_tpu_torch.pipeline import segment as TS
from image_segmenter_tpu_torch.utils.loops import Cut

torch.set_num_threads(2)

TINY = dict(embed_dim=24, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8))
SIZE = 160
# the port's bfloat16 network against the float32 reference: bfloat16
# operands in every linear and convolution and bfloat16 activations
# between the decoder's operations read 0.0075 here; four times that
BF16_REL = 0.03


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def nets():
    """The port's float32 and bfloat16 modules and the reference, on one
    seeded state, and two normalised frames."""
    f32 = B.BiRefNet(B.BiRefNetConfig(**TINY), half=False)
    B.seeded_init(f32, torch.Generator().manual_seed(7))
    half = B.BiRefNet(B.BiRefNetConfig(**TINY), half=True)
    half.load_state_dict(f32.state_dict(), strict=True)
    ref = BP.BiRefNetPlain(**TINY)
    ref.load_state_dict(f32.state_dict(), strict=True)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 3, SIZE, SIZE)).astype(np.float32))
    with torch.no_grad():
        port = f32(x)[0]
        want = torch.cat([ref(x[i:i + 1]) for i in range(len(x))])
    return {"f32": f32, "half": half, "ref": ref, "x": x, "port": port,
            "want": want}


def _ref_logits(ref, x, prec="f32", faults=()):
    ref.set(prec, faults)
    try:
        with torch.no_grad():
            return torch.cat([ref(x[i:i + 1]) for i in range(len(x))])
    finally:
        ref.set("f32")


def test_f32_logits_match_the_plain_reference(nets):
    """float32 on both sides, the same operations in another grouping
    (windows of all frames as one batch, SDPA, conv_out1 before its
    resize): 1e-4 relative (reads about 1e-6)."""
    assert nets["port"].shape == (2, 1, SIZE, SIZE)
    assert _rel(nets["port"], nets["want"]) <= 1e-4


def test_bf16_logits_are_within_the_stated_tolerance(nets):
    with torch.no_grad():
        got = nets["half"](nets["x"])[0]
    assert got.dtype == torch.float32
    assert _rel(got, nets["want"]) <= BF16_REL


@pytest.mark.parametrize("fault", ["table", "shift", "offsets", "modulator",
                                   "half_scale", "align_corners"])
def test_each_fault_fails_the_comparison(nets, fault):
    """A reference with the fault lies beyond both tolerances from the
    port on the first frame (each reads 0.07 or more)."""
    bad = _ref_logits(nets["ref"], nets["x"][:1], faults={fault})
    assert _rel(nets["port"][:1], bad) > BF16_REL


def test_the_float8_control_lies_beyond_the_bf16_tolerance(nets):
    ctrl = _ref_logits(nets["ref"], nets["x"][:1], "fp8")
    witness = _ref_logits(nets["ref"], nets["x"][:1], "bf16")
    assert _rel(ctrl, nets["want"][:1]) > BF16_REL
    assert _rel(witness, nets["want"][:1]) <= BF16_REL


def _gather_f64(x, off, mask, k):
    """Modulated bilinear samples, one position at a time in float64:
    torchvision's bilinear_interpolate, written as loops."""
    b, c, h, w = x.shape
    p = k // 2
    out = np.zeros((b, c, k * k, h, w))
    for n in range(b):
        for t in range(k * k):
            i, j = divmod(t, k)
            for yy in range(h):
                for xx in range(w):
                    y = yy - p + i + off[n, 2 * t, yy, xx]
                    xf = xx - p + j + off[n, 2 * t + 1, yy, xx]
                    if y <= -1 or y >= h or xf <= -1 or xf >= w:
                        continue
                    y0, x0 = int(np.floor(y)), int(np.floor(xf))
                    ly, lx = y - y0, xf - x0
                    val = np.zeros(c)
                    for dy, dx, wt in ((0, 0, (1 - ly) * (1 - lx)),
                                       (0, 1, (1 - ly) * lx),
                                       (1, 0, ly * (1 - lx)),
                                       (1, 1, ly * lx)):
                        yy2, xx2 = y0 + dy, x0 + dx
                        if 0 <= yy2 < h and 0 <= xx2 < w:
                            val += wt * x[n, :, yy2, xx2]
                    out[n, :, t, yy, xx] = mask[n, t, yy, xx] * val
    return out


@pytest.mark.parametrize("k", [1, 3])
def test_deform_conv_plain_matches_a_float64_gather(k):
    """At random offsets of up to 4 pixels on a 5 x 6 image (many taps
    fall partly or wholly outside it) and modulators in (0, 2): the
    samples and the convolution within float32's rounding."""
    rng = np.random.default_rng(k)
    b, c, h, w, n = 2, 3, 5, 6, 4
    x = rng.standard_normal((b, c, h, w))
    off = rng.uniform(-4, 4, (b, 2 * k * k, h, w))
    mask = rng.uniform(0, 2, (b, k * k, h, w))
    wt = rng.standard_normal((n, k, k, c))
    want = _gather_f64(x, off, mask, k)
    assert (want == 0).all(axis=1).any()  # some taps land wholly outside
    tx, toff, tm = (torch.from_numpy(a).float() for a in (x, off, mask))
    got = KDC.sample_taps(tx, toff, tm, k).double().numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    conv = np.einsum("bctyx,ntc->bnyx", want, wt.reshape(n, k * k, c))
    out = KDC.deform_conv_plain(tx, toff, tm, torch.from_numpy(wt).float(),
                                rows=2)
    assert np.abs(out.double().numpy() - conv).max() \
        <= 1e-5 * np.abs(conv).max()
    # into a channel slice, with a bias and a ReLU
    cat = torch.zeros(b, n + 3, h, w)
    bias = torch.arange(n, dtype=torch.float32) - 1.5
    KDC.deform_conv(tx, toff, tm, torch.from_numpy(wt).float(), bias,
                    relu=True, out=cat[:, 1:1 + n])
    exp = np.maximum(conv + bias.numpy()[None, :, None, None], 0)
    assert np.abs(cat[:, 1:1 + n].double().numpy() - exp).max() \
        <= 1e-5 * np.abs(conv).max()
    assert not cat[:, 0].any() and not cat[:, 1 + n:].any()


def test_the_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    """The checks run before a launch (any device): 64 in, 256 out,
    channels-last operands, a 16-byte-row output."""
    cl = torch.channels_last
    x = torch.zeros(1, 64, 4, 4, dtype=torch.bfloat16).to(memory_format=cl)
    off = torch.zeros(1, 18, 4, 4).to(memory_format=cl)
    m = torch.zeros(1, 9, 4, 4).to(memory_format=cl)
    w = torch.zeros(256, 3, 3, 64, dtype=torch.bfloat16)
    assert KDC._check(x, off, m, w, None, None) == 3
    with pytest.raises(ValueError):
        KDC._check(x, off, m, w[:128], None, None)
    with pytest.raises(ValueError):
        KDC._check(x.contiguous(), off, m, w, None, None)
    with pytest.raises(ValueError):
        KDC._check(x, off.to(torch.bfloat16), m, w, None, None)
    out = torch.zeros(1, 300, 4, 4, dtype=torch.bfloat16).to(
        memory_format=cl)
    with pytest.raises(ValueError):  # pixels 300 elements apart
        KDC._check(x, off, m, w, None, out[:, :256])


def test_shift_mask_separates_the_rolled_regions():
    m = B.shift_mask(24, 24, 12, 6)
    assert m.shape == (4, 144, 144)
    assert (m[0] == 0).all()            # a window inside one region
    assert (m == m.transpose(1, 2)).all()
    assert set(m.unique().tolist()) == {-100.0, 0.0}
    # the last window holds four regions of 36 positions each
    assert int((m[3] == 0).sum()) == 4 * 36 * 36


def test_published_names_shapes_and_counts():
    """The module names of the official state dict at published widths,
    the same keys in the port and the reference, Swin-L's 195 M
    backbone parameters."""
    with torch.device("meta"):
        port = B.BiRefNet(B.SWIN_L)
        ref = BP.BiRefNetPlain()
    sd, rd = port.state_dict(), ref.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} \
        == {k: tuple(v.shape) for k, v in rd.items()}
    shapes = {
        "bb.patch_embed.proj.weight": (192, 3, 4, 4),
        "bb.layers.2.blocks.17.attn.relative_position_bias_table": (529, 24),
        "bb.layers.2.blocks.17.attn.relative_position_index": (144, 144),
        "bb.layers.2.downsample.reduction.weight": (1536, 3072),
        "bb.norm3.weight": (1536,),
        "squeeze_module.0.conv_in.weight": (64, 5760, 3, 3),
        "squeeze_module.0.dec_att.aspp_deforms.2.atrous_conv.offset_conv"
        ".weight": (98, 64, 7, 7),
        "squeeze_module.0.dec_att.aspp1.atrous_conv.regular_conv.weight":
            (256, 64, 1, 1),
        "squeeze_module.0.dec_att.conv1.weight": (64, 1280, 1, 1),
        "decoder.ipt_blk5.conv1.weight": (64, 3072, 3, 3),
        "decoder.decoder_block1.conv_out.weight": (192, 64, 3, 3),
        "decoder.conv_out1.0.weight": (1, 240, 1, 1),
        "decoder.gdt_convs_attn_2.0.weight": (1, 16, 1, 1),
        "decoder.lateral_block4.conv.weight": (1536, 1536, 1, 1),
    }
    for name, shape in shapes.items():
        assert tuple(sd[name].shape) == shape, name
    counts = B.parameter_counts(port)
    assert counts["backbone"] == 195_201_204
    with open(Path(__file__).resolve().parents[1] / "benchmark" / "configs"
              / "birefnet_swinl_k16.json") as f:
        assert json.load(f)["parameters"] == counts


def test_registry_spec_and_sigmoid_before_the_min_max():
    spec = TR.SPECS["birefnet-general"]
    assert spec.arch == "birefnet_swin_l" and spec.post == "sigmoid"
    assert spec.size == (1024, 1024) and not spec.prompted
    assert spec.seeded_on_device and spec.own_graph
    assert all(s.post == "identity" for k, s in TR.SPECS.items()
               if k != "birefnet-general")
    # only SAM and BiRefNet are seeded on the device and cut
    assert {k for k, s in TR.SPECS.items() if s.seeded_on_device} \
        == {k for k, s in TR.SPECS.items() if s.own_graph} \
        == {"sam_vit_h", "sam", "birefnet-general"}

    class Net(torch.nn.Module):
        def forward(self, x):
            return [x[:, :1] * 3.0]

    small = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 8, 8, 3), dtype=np.uint8))
    mean, std = torch.zeros(3), torch.ones(3)
    got = TS.saliency_u8(Net(), small, mean, std, "sigmoid")
    x = small.float() / small.float().amax(dim=(1, 2, 3), keepdim=True)
    d = torch.sigmoid(3.0 * x[..., 0])
    mi = d.amin(dim=(1, 2), keepdim=True)
    ma = d.amax(dim=(1, 2), keepdim=True)
    want = torch.floor((d - mi) / (ma - mi) * 255 + 0.5).to(torch.uint8)
    assert torch.equal(got, want)
    assert not torch.equal(TS.saliency_u8(Net(), small, mean, std), want)


@pytest.fixture
def tiny_session(monkeypatch):
    """`birefnet-general` with the tiny widths at 160 x 160."""
    monkeypatch.setitem(B.CONFIGS, "birefnet_swin_l", B.BiRefNetConfig(**TINY))
    spec = TR.SPECS["birefnet-general"]
    monkeypatch.setitem(TR.SPECS, "birefnet-general",
                        dataclasses.replace(spec, size=(SIZE, SIZE)))
    monkeypatch.setattr(TR, "_sessions", {})


def test_pipeline_runs_birefnet_with_its_network_stage_cut(tiny_session):
    """Pipeline.run on the CPU (the eager stages): outputs of the right
    shapes, the same bytes as run_eager, the network stage a graph of its
    own labelled with the model, FRAMES counted; predict_mask takes the
    sigmoid before the min-max."""
    imgs = np.random.default_rng(3).integers(0, 256, (1, 90, 120, 3),
                                             dtype=np.uint8)
    pipe = TS.Pipeline(model="birefnet-general", k=4, device="cpu")
    f0 = B.FRAMES
    out = pipe.run(imgs)
    assert B.FRAMES - f0 == 1
    assert out.rgba.shape == (1, 90, 120, 4) and out.palettes.shape == \
        (1, 4, 3)
    again = pipe.run_eager(imgs)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    prog = TS.batch_program(pipe.stages, pipe.session.module,
                            torch.from_numpy(imgs))
    first = next(prog)
    assert isinstance(first, Cut) and first.label == "birefnet-general"
    sess = pipe.session
    mask = sess.predict_mask(imgs[0])
    with torch.no_grad():
        d0 = sess._forward(imgs[0])[0]
    s = torch.sigmoid(d0)
    m01 = (s - s.min()) / (s.max() - s.min())
    m_u8 = torch.clamp(torch.floor(m01 * 255 + 0.5), 0, 255).to(torch.uint8)
    from image_segmenter_tpu_torch.ops import resize as RZ
    assert np.array_equal(mask, RZ.resize_u8(m_u8[None], (90, 120),
                                             RZ.LANCZOS_PIL)[0].numpy())


def test_load_state_dict_remakes_the_derived_copies(tiny_session):
    """The bfloat16 copies and the attention masks follow a loaded state:
    a new state changes the logits, and the same state gives the same."""
    cfg = B.BiRefNetConfig(**TINY)
    a = B.BiRefNet(cfg, half=True)
    B.seeded_init(a, torch.Generator().manual_seed(1))
    b = B.BiRefNet(cfg, half=True)
    B.seeded_init(b, torch.Generator().manual_seed(2))
    x = torch.randn(1, 3, SIZE, SIZE)
    with torch.no_grad():
        la, lb = a(x)[0], b(x)[0]
        b.load_state_dict(a.state_dict())
        assert torch.equal(b(x)[0], la)
    assert not torch.equal(la, lb)
