"""Segment Anything in the PyTorch port (models/sam.py) against the plain
reference (benchmark/reference/sam_plain.py), on the CPU.

The JAX package has no SAM, so the port is held to a plain PyTorch
forward written from the official code, on seeded random weights at a
tiny size: width 32, 4 blocks with global attention in blocks 1 and 3,
2 heads, window 4 on a 10 x 10 token grid (so that windows pad to 12 x
12), image 160. Published widths are checked by parameter counts only.
"""

import numpy as np
import pytest
import torch

from benchmark.reference import sam_plain as SP
from image_segmenter_tpu_torch.models import registry as TR
from image_segmenter_tpu_torch.models import sam as S
from image_segmenter_tpu_torch.pipeline import compiled as TCOMP
from image_segmenter_tpu_torch.pipeline import segment as TS
from image_segmenter_tpu_torch.utils import profiling as P
from image_segmenter_tpu_torch.utils.loops import Cut, drive

torch.set_num_threads(2)

TINY = dict(embed_dim=32, depth=4, num_heads=2, global_attn_indexes=(1, 3),
            window_size=4, patch_size=16, img_size=160, prompt_dim=32,
            decoder_mlp=64, decoder_heads=2, iou_head_hidden=32)
MEAN = torch.tensor(S.PIXEL_MEAN)
STD = torch.tensor(S.PIXEL_STD)


def _tiny(half: bool, seed: int = 3) -> S.Sam:
    m = S.Sam(S.SamConfig(**TINY), half=half)
    S.seeded_init(m, torch.Generator().manual_seed(seed))
    return m


def _plain(state, prec="f32") -> SP.SamPlain:
    ref = SP.SamPlain("tiny", prec, **TINY)
    ref.load_state_dict(state, strict=True)
    return ref


def _inputs(b=2, h=90, w=120, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    box = np.array([[10, 5, 80, 70], [3, 20, 110, 88], [40, 0, 119, 89]],
                   np.float32)[:b]
    return img, box


def _port(model, img, box):
    return S.prompted_logits(model, torch.from_numpy(img),
                             torch.from_numpy(box), MEAN, STD)


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def f32_model():
    return _tiny(half=False)


def test_f32_logits_and_iou_match_the_plain_reference(f32_model):
    """float32 on both sides, the same operations in another grouping
    (windows as a batch, heads fused): 1e-5 relative; the full-size alpha0
    equal."""
    img, box = _inputs()
    a0, low, iou = _port(f32_model, img, box)
    ref = _plain(f32_model.state_dict())
    for i in range(len(img)):
        full, rlow, riou = SP.predict(ref, torch.from_numpy(img[i]), box[i])
        assert _rel(low[i], rlow[0]) <= 1e-5
        assert _rel(iou[i], riou[0]) <= 1e-5
        assert torch.equal(a0[i], (full > 0).to(torch.uint8) * 255)
    assert low.shape == (2, 1, 40, 40) and iou.shape == (2, 1)


def test_bf16_path_is_within_its_precision(f32_model):
    """The encoder's operands in bfloat16 (8 bits of mantissa, a relative
    step of 2^-8 a rounding) through 4 blocks and the neck: the logits
    move by about 0.6 % here (0.56 % when written); 3 % is five times
    that, and a fault below moves them by more."""
    img, box = _inputs()
    _, low, iou = _port(f32_model, img, box)
    half = S.Sam(S.SamConfig(**TINY), half=True)
    half.load_state_dict(f32_model.state_dict())
    _, hlow, hiou = _port(half, img, box)
    assert 0 < _rel(hlow, low) <= 0.03
    assert (hiou - iou).abs().max() <= 0.03 * iou.abs().max()


def test_bf16_copies_follow_load_state_dict(f32_model):
    half = _tiny(half=True, seed=9)
    half.load_state_dict(f32_model.state_dict())
    blk = half.image_encoder.blocks[0]
    assert torch.equal(blk.attn.qkv.weight_low,
                       f32_model.image_encoder.blocks[0].attn.qkv.weight
                       .to(torch.bfloat16))
    rh, _ = f32_model.image_encoder.blocks[0].attn.tables()
    assert torch.equal(blk.attn.rh_low, rh.to(torch.bfloat16))
    assert f32_model.image_encoder.blocks[0].attn.qkv.weight_low is None


def test_box_transform_preprocess_and_postprocess_are_exact():
    rng = np.random.default_rng(1)
    for h, w in ((90, 120), (2160, 3840), (1000, 667)):
        box = (rng.random((3, 4)) * [w, h, w, h]).astype(np.float32)
        got = S.transform_boxes(torch.from_numpy(box), (h, w), 1024)
        want = torch.as_tensor(SP.transform_box(box, (h, w), 1024),
                               dtype=torch.float)
        assert torch.equal(got, want)
        assert S.preprocess_shape(h, w, 1024) == \
            SP.preprocess_shape(h, w, 1024)
    low = torch.randn(2, 1, 40, 40)
    for hw in ((90, 120), (121, 77)):
        got = S.postprocess(low, hw, 160)
        for i in range(2):
            assert torch.equal(got[i], SP.postprocess(low[i:i + 1], hw, 160)[0])
    img, _ = _inputs(h=71, w=133)
    x = S.preprocess(torch.from_numpy(img), 160, MEAN, STD)
    nh, nw = S.preprocess_shape(71, 133, 160)
    small = SP.resize_bilinear_pil(torch.from_numpy(img[:1]), (nh, nw))
    want = (small.permute(0, 3, 1, 2) - MEAN[:, None, None]) \
        / STD[:, None, None]
    assert torch.equal(x[:1, :, :nh, :nw], want)
    assert x.shape == (2, 3, 160, 160) and not x[:, :, nh:].any() \
        and not x[:, :, :, nw:].any()


def test_resize_matches_the_ports_pil_bilinear():
    from image_segmenter_tpu_torch.ops import resize as RZ

    img, _ = _inputs(b=1, h=75, w=101)
    x = torch.from_numpy(img)
    assert torch.equal(SP.resize_bilinear_pil(x, (30, 41)),
                       RZ.resize_u8(x, (30, 41), RZ.BILINEAR_PIL))


@pytest.mark.parametrize("fault", ["rel_pos_zeroed", "windows_unpadded",
                                   "boxes_not_rescaled", "mask_1"])
def test_a_fault_moves_the_output_past_the_tolerance(f32_model, fault):
    """Each fault the benchmark's judge must see changes the logits by
    far more than the 1e-5 the f32 comparison allows."""
    img, box = _inputs()
    _, low, _ = _port(f32_model, img, box)
    state = f32_model.state_dict()
    kw = {}
    if fault == "rel_pos_zeroed":
        state = {k: torch.zeros_like(v) if "rel_pos" in k else v
                 for k, v in state.items()}
    ref = _plain(state)
    if fault == "windows_unpadded":
        for blk in ref.image_encoder.blocks:
            blk.pad_windows = False
    elif fault == "boxes_not_rescaled":
        kw = {"scale_boxes": False}
    elif fault == "mask_1":
        kw = {"mask_index": 1}
    worst = max(_rel(low[i], SP.predict(ref, torch.from_numpy(img[i]),
                                        box[i], **kw)[1][0])
                for i in range(len(img)))
    assert worst > 1e-3


def test_seeded_init_covers_every_tensor_and_follows_the_seed():
    a, b, c = _tiny(False, 5), _tiny(False, 5), _tiny(False, 6)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["image_encoder.blocks.0.attn.qkv.weight"],
                           sc["image_encoder.blocks.0.attn.qkv.weight"])
    assert torch.all(sa["image_encoder.blocks.0.norm1.weight"] == 1)
    assert not sa["image_encoder.blocks.0.attn.qkv.bias"].any()
    w = sa["image_encoder.blocks.1.mlp.lin1.weight"]
    assert w.abs().max() * 32 ** 0.5 <= 2.0 / 0.87962566103423978 + 1e-5
    assert sa["image_encoder.blocks.1.attn.rel_pos_h"].std() < 0.05
    assert sa["mask_decoder.mask_tokens.weight"].std() > 0.5
    m = S.Sam(S.SamConfig(**TINY), half=False)
    with pytest.raises(RuntimeError, match="left"):
        S.seeded_init(_Unseeded(m), torch.Generator())


class _Unseeded(S.Sam):
    """A SAM with one more parameter that no rule seeds."""

    def __init__(self, base):
        torch.nn.Module.__init__(self)
        self.__dict__.update(base.__dict__)
        self.extra = torch.nn.Parameter(torch.zeros(3))


@pytest.mark.parametrize("arch", ["sam_vit_h", "sam_vit_b"])
def test_published_widths_have_the_references_parameters(arch):
    with torch.device("meta"):
        port = S.build(arch)
        ref = SP.SamPlain(arch)
    ps, rs = port.state_dict(), ref.state_dict()
    assert {k: tuple(v.shape) for k, v in ps.items()} == \
        {k: tuple(v.shape) for k, v in rs.items()}
    n = sum(p.numel() for p in port.parameters())
    assert n == sum(p.numel() for p in ref.parameters())
    assert n == {"sam_vit_h": 641090608, "sam_vit_b": 93735472}[arch]
    enc = port.image_encoder
    assert sum(not b.window_size for b in enc.blocks) == 4
    assert enc.blocks[0].attn.rel_pos_h.shape[0] == 27
    assert [i for i, b in enumerate(enc.blocks) if not b.window_size] == \
        list(S.CONFIGS[arch].global_attn_indexes)


@pytest.fixture
def tiny_registry(monkeypatch):
    monkeypatch.setitem(S.CONFIGS, "sam_vit_h", S.SamConfig(**TINY))
    monkeypatch.setattr(TR, "_sessions", {})


def test_pipeline_run_equals_run_from_mask_on_the_references_alpha0(
        tiny_registry):
    """The network stage's full-size alpha enters the matting where the
    CNN's upsampled mask does: on the CPU, in float32, the whole run
    equals the stages after the mask fed the reference's alpha0, and its
    logits and IoU are the reference's."""
    pipe = TS.Pipeline(model="sam_vit_h", k=8, matting_dim=64, cg_iters=30,
                       device="cpu")
    pipe.session.module.half = False
    img, box = _inputs(b=3)
    out = pipe.run(img, box)
    ref = _plain(pipe.session.module.state_dict())
    alpha0, lows = [], []
    for i in range(3):
        full, low, _ = SP.predict(ref, torch.from_numpy(img[i]), box[i])
        alpha0.append((full > 0).to(torch.uint8) * 255)
        lows.append(low[0])
    want = pipe.run_from_mask(img, torch.stack(alpha0))
    for a, b in zip(out, want):
        assert torch.equal(a, b)
    assert len(tuple(out)) == 3 and want.logits is None
    assert out.logits.shape == (3, 1, 40, 40) and out.iou.shape == (3, 1)
    assert _rel(out.logits, torch.stack(lows)) <= 1e-5
    assert torch.equal(pipe.run_eager(img, box).alpha, out.alpha)


def test_boxes_are_required_for_sam_and_refused_elsewhere(tiny_registry):
    img, box = _inputs()
    sam = TS.Pipeline(model="sam_vit_h", k=8, matting_dim=64, cg_iters=5,
                      device="cpu")
    with pytest.raises(ValueError, match="one box a frame"):
        sam.run(img)
    with pytest.raises(ValueError, match=r"\(2, 4\) float32"):
        sam.run(img, box[:1])
    with pytest.raises(ValueError, match="takes no boxes"):
        TS.Pipeline(model="u2netp", k=8, device="cpu").run(img, box)
    with pytest.raises(ValueError, match="takes a box"):
        sam.session.predict_mask(img[0])


def test_the_network_stage_counts_frames_and_prompts_and_is_cut(
        tiny_registry):
    pipe = TS.Pipeline(model="sam_vit_h", k=8, matting_dim=64, cg_iters=5,
                       device="cpu")
    img, box = _inputs()
    f0, p0 = S.FRAMES, S.PROMPTS
    prog = TS.batch_program(pipe.stages, pipe.session.module,
                            torch.from_numpy(img), torch.from_numpy(box))
    first = next(prog)
    assert isinstance(first, Cut) and first.label == "sam_vit_h"
    assert (S.FRAMES - f0, S.PROMPTS - p0) == (2, 2)
    loops = []
    out = drive(prog, loops)
    assert len(out) == 5 and all(not isinstance(lp, Cut) for lp in loops)
    assert (S, "FRAMES") in P.replayed_counters()


def test_a_cut_labels_its_graphs_segment_spans():
    class _Graph:
        def replay(self):
            pass

    zeros = [0] * len(P.replayed_counters())
    seg = TCOMP._Graph(_Graph(), 0, zeros, label="sam_vit_h")
    plain = TCOMP._Graph(_Graph(), 1, zeros)

    def call():
        with P.span("pipeline.run"):
            seg.replay()
            plain.replay()

    P.clear()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        call()
    (c,) = P.record().calls
    assert [(s.name, s.attrs) for s in c.spans] == [
        ("pipeline.run", ()), ("compiled.segment", (0, "sam_vit_h")),
        ("compiled.segment", (1,))]
    P.clear()


def test_sam_has_no_staged_run_and_no_checkpoint_discovery():
    from image_segmenter_tpu_torch.pipeline.staged import StagedPipeline

    with pytest.raises(ValueError, match="takes a box"):
        StagedPipeline(model="sam")
    with pytest.raises(ValueError, match="state dict"):
        TR.Session("sam", device="cpu", ckpt_path="x.onnx")
    assert TR.SPECS["sam"].arch == "sam_vit_b" and TR.SPECS["sam"].prompted
    assert not TR.SPECS["u2netp"].prompted


@pytest.mark.cuda
def test_on_the_card_the_compiled_run_is_the_eager_run(tiny_registry):
    """The network stage captured as the program's first graph, labelled
    with the model; replays give the eager run's bytes and count the
    frames and prompts."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the compiled run is CUDA graphs")
    pipe = TS.Pipeline(model="sam_vit_h", k=8, matting_dim=64, cg_iters=30,
                       device="cuda")
    img, box = _inputs(b=3)
    first = pipe.run(img, box)
    f0 = S.FRAMES
    out = pipe.run(img, box)
    assert S.FRAMES - f0 == 3
    eager = pipe.run_eager(img, box)
    for a, b in zip((*out, out.logits, out.iou),
                    (*eager, eager.logits, eager.iou)):
        assert torch.equal(a, b)
    assert torch.equal(first.alpha, out.alpha)
    (prog,) = pipe.programs.values()
    assert prog._graphs[0].segment_attrs == (0, "sam_vit_h")
    assert prog._graphs[0].flag is None and prog.graphs() >= 5


@pytest.mark.cuda
def test_on_the_card_each_resize_launches_the_resample_kernel_once(
        tiny_registry):
    """A replayed SAM run carries kernels/resample's counter: four launches
    a call (the encoder's BILINEAR_PIL input, the matting's two AREA
    shrinks and its LINEAR alpha back), as the eager run."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the resample kernel has no CPU "
                    "mode")
    from image_segmenter_tpu_torch.kernels import resample as RS

    pipe = TS.Pipeline(model="sam_vit_h", k=8, matting_dim=64, cg_iters=30,
                       device="cuda")
    img, box = _inputs(b=3)
    pipe.run(img, box)
    for run in (pipe.run, pipe.run_eager):
        before = RS.LAUNCHES
        run(img, box)
        assert RS.LAUNCHES - before == 4


@pytest.mark.cuda
def test_on_the_card_each_block_launches_the_attention_kernel_once(
        tiny_registry, monkeypatch):
    """The compiled run's replays carry kernels/sam_attention's launch
    counter: a call adds one launch a block (4), as the eager run does,
    and nothing calls F.scaled_dot_product_attention."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the attention kernel has no CPU "
                    "mode")
    import torch.nn.functional as F

    from image_segmenter_tpu_torch.kernels import sam_attention as SA

    def refuse(*args, **kwargs):
        raise AssertionError("the encoder called SDPA")

    monkeypatch.setattr(F, "scaled_dot_product_attention", refuse)
    pipe = TS.Pipeline(model="sam_vit_h", k=8, matting_dim=64, cg_iters=30,
                       device="cuda")
    img, box = _inputs(b=3)
    pipe.run(img, box)
    for run in (pipe.run, pipe.run_eager):
        before = SA.LAUNCHES
        run(img, box)
        assert SA.LAUNCHES - before == TINY["depth"]
