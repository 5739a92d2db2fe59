"""The prompted cell's pieces on the CPU: `correct` comes out false for the
control and for each fault in the program's place, the FLOP count
against a dispatch count, the boxes of the traffic, and the three
readers on synthetic timelines.

The runs here are the cell's, cut to a tiny SAM (width 32, 4 blocks,
global attention in blocks 1 and 3, window 4 on a 10 x 10 grid, image
160) and two frames of 270 x 480, against the cell's own limits."""

import json
import time

import numpy as np
import pytest
import torch

from benchmark import run as R
from benchmark.generators import photo_mosaic_box
from benchmark.metrics import sam_attn_ms, sam_encoder_mfu
from benchmark.reference import pipeline_run_prompted as REF
from benchmark.reference import sam_plain
from benchmark.yardstick import sam_flops, sam_weights
from benchmark.yardstick.timeline import Timeline

CELL = "sam_vith_photo_4k_b4_box"
TINY = dict(embed_dim=32, depth=4, num_heads=2, global_attn_indexes=[1, 3],
            window_size=4, img_size=160, prompt_dim=32, decoder_mlp=64,
            decoder_heads=2, iou_head_hidden=32)
SEED = 2**31 + 17


@pytest.fixture
def plan(monkeypatch):
    from image_segmenter_tpu_torch.models import registry as TR
    from image_segmenter_tpu_torch.models import sam as S

    plan = R.Plan(R.load_manifest(), CELL, False)
    widths = dict(plan.config["widths"], **TINY)
    plan.config = dict(plan.config, widths=widths)
    plan.traffic = dict(plan.traffic, frames=2, height=270, width=480,
                        tile=270, box_jitter=13, check_calls=2,
                        trace_calls=1)
    cfg = {k: tuple(v) if isinstance(v, list) else v
           for k, v in widths.items()}
    monkeypatch.setitem(S.CONFIGS, "sam_vit_h", S.SamConfig(**cfg))
    monkeypatch.setattr(TR, "_sessions", {})
    return plan


def _run(plan):
    return R.run_cell(plan, seed=SEED, seconds=0.01, trace=False,
                      devices=["cpu"], t0=time.perf_counter())


def _in_programs_place(monkeypatch, plan, ref):
    monkeypatch.setattr(plan.entry.Entry, "__call__",
                        lambda self, request: ref(request))


def _ref(plan, state=None, **kw):
    cfg = plan.config
    if state is None:
        state = sam_weights.make_state(cfg, cfg["weight_seed"], "cpu")
    return REF.Reference(cfg, state, "cpu", **kw)


def test_a_sound_run_is_correct(plan):
    res = _run(plan)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"logit_rel", "iou_abs", "alpha_mad",
                                  "rgba_mismatch", "palette_mismatch"}
    assert set(res["metrics"]) == {"mp_per_s", "latency_ms_p95", "setup_s"}


def test_the_control_in_the_programs_place_is_not_correct(plan,
                                                          monkeypatch):
    _in_programs_place(monkeypatch, plan, _ref(plan, control=True))
    res = _run(plan)
    assert not res["correct"], res["checks"]


def _zero_rel_pos(plan):
    cfg = plan.config
    state = sam_weights.make_state(cfg, cfg["weight_seed"], "cpu")
    return _ref(plan, {k: torch.zeros_like(v) if "rel_pos" in k else v
                       for k, v in state.items()})


def _unpadded(plan):
    ref = _ref(plan)
    for blk in ref.net.image_encoder.blocks:
        blk.pad_windows = False
    return ref


def _switched(plan, **kw):
    ref = _ref(plan)
    ref.predict_kw = kw
    return ref


FAULTS = {
    "rel_pos_zeroed": _zero_rel_pos,
    "window_padding_masked_out": _unpadded,
    "boxes_not_rescaled": lambda p: _switched(p, scale_boxes=False),
    "multimask_output_picked": lambda p: _switched(p, mask_index=2),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_in_the_programs_place_is_caught(plan, monkeypatch, fault):
    _in_programs_place(monkeypatch, plan, FAULTS[fault](plan))
    res = _run(plan)
    assert not res["correct"], res["checks"]
    assert res["checks"]["logit_rel"]["value"] > \
        res["checks"]["logit_rel"]["limit"]


@pytest.mark.parametrize("trace", [False, True])
def test_every_item_of_the_cell_is_found_by_name(trace):
    """`test_bench_manifest`'s check of a cell, for the prompted entry and
    its five limits."""
    p = R.Plan(R.load_manifest(), CELL, trace)
    assert p.config["entry"] == "pipeline_run_prompted"
    assert p.traffic["generator"] == "photo_mosaic_box"
    assert set(p.limits) == {"logit_rel", "iou_abs", "alpha_mad",
                             "rgba_mismatch", "palette_mismatch"}
    names = [m["name"] for m, _ in p.metrics]
    assert all(callable(r.read) for _, r in p.metrics)
    assert names == (["sam_encoder_mfu", "sam_attn_ms", "step_mfu.sam"]
                     if trace else ["mp_per_s", "latency_ms_p95", "setup_s"])


def test_encoder_flops_match_a_dispatch_count():
    w = sam_plain.widths("tiny", **TINY)
    net = sam_plain.SamPlain("tiny", **TINY)
    with torch.no_grad(), sam_flops.MatmulCount() as count:
        net.image_encoder(torch.randn(1, 3, 160, 160))
    assert count.flops == sam_flops.encoder_flops(w, 1)
    assert sam_flops.encoder_flops(w, 3) == 3 * count.flops
    full = sam_plain.widths("sam_vit_h")
    assert 23.8e12 < sam_flops.encoder_flops(full, 4) < 23.9e12
    assert 0 < sam_flops.decoder_flops("sam_vit_h", full, 4) < 1e-3 * \
        sam_flops.encoder_flops(full, 4)


def test_boxes_follow_the_seed_and_lie_in_the_frame():
    with open(R.ROOT / "benchmark/traffic/photo_4k_b4_box.json") as f:
        tr = json.load(f)
    a = photo_mosaic_box.boxes(tr, SEED, 14)
    assert np.array_equal(a, photo_mosaic_box.boxes(tr, SEED, 14))
    assert not np.array_equal(a, photo_mosaic_box.boxes(tr, SEED + 1, 14))
    assert a.shape == (14, 4, 4) and a.dtype == np.float32
    assert (a >= 0).all() and (a[..., 0::2] <= 3839).all() \
        and (a[..., 1::2] <= 2159).all()
    assert (a[..., 2] - a[..., 0] >= 1080 - 108 - 1).all()
    tiles = {(int(round(b[0] / 1080)), int(round(b[1] / 1080)))
             for b in a.reshape(-1, 4)}
    assert tiles <= {(c, r) for c in range(3) for r in range(2)}
    small = dict(tr, frames=2, height=270, width=480, tile=270)
    reqs = photo_mosaic_box.make(small, SEED, [torch.device("cpu")])
    assert len(reqs) == 14
    assert reqs[0][0].shape == (2, 270, 480, 3) and reqs[0][1].shape == (2, 4)
    with pytest.raises(ValueError, match="box_jitter"):
        photo_mosaic_box.check({k: v for k, v in tr.items()
                                if k != "box_jitter"})


def _timeline(calls):
    """A traced window of `calls` calls, each: a float64 resize GEMM, the
    encoder (cast, two blocks of GEMM, einsum, bias add, memset,
    attention, then the neck's bf16 conv), the float32 decoder and the
    matting."""
    device, spans, t = [], [], 0.0

    def op(name, us):
        nonlocal t
        device.append((name, t, t + us))
        t += us

    for _ in range(calls):
        spans.append(("bench.pipeline.run", t, t + 1000.0))
        op("sm90_xmma_gemm_f64f64_f64f64_f64_nn", 50.0)
        op("vectorized_elementwise_kernel<8, bfloat16_copy_kernel_cuda>", 5.0)
        for _ in range(2):
            op("nvjet_tst_192x176_64x4_1x2_h_bz_coopB_bias_TNT", 100.0)
            op("cutlass_80_wmma_tensorop_bf16_s161616gemm_bf16", 10.0)
            op("elementwise_kernel<128, 4, gpu_kernel_impl_nocast<"
               "CUDAFunctor_add<c10::BFloat16> >>", 20.0)
            op("Memset (Unknown)", 1.0)
            op("cudnn_generated_fort_native_sdpa_sm90_flash_fprop", 30.0)
            op("vectorized_layer_norm_kernel<float, float, false>", 4.0)
        op("cutlass_tensorop_bf16_s16816fprop_optimized_bf16", 25.0)
        op("sgemm_largek_lds64", 40.0)
        op("matvec_kernel<true>", 80.0)
        t += 1000.0 - 571.0 + 400.0
    return Timeline(device, spans)


def _run_record(calls=3):
    with open(R.ROOT / "benchmark/configs/sam_vith_box_k16.json") as f:
        cfg = json.load(f)
    return {"timeline": _timeline(calls), "config": cfg, "frames": 4,
            "traced_calls": calls}


def test_encoder_mfu_reads_the_bfloat16_stretch_of_each_call():
    run = _run_record()
    enc_s = (5.0 + 2 * 165.0 + 25.0) / 1e6
    w = sam_plain.widths("sam_vit_h")
    want = 100.0 * sam_flops.encoder_flops(w, 4) / 989e12 / enc_s
    assert sam_encoder_mfu.read(run) == pytest.approx(want)
    assert sam_encoder_mfu.read({"timeline": None}) is None
    bare = _run_record()
    bare["timeline"] = Timeline([(n, s, e) for n, s, e in
                                 bare["timeline"].device
                                 if not sam_encoder_mfu.BF16.search(n)],
                                bare["timeline"].spans)
    assert sam_encoder_mfu.read(bare) is None


def test_attention_ms_reads_the_kernels_and_their_bias_adds():
    assert sam_attn_ms.read(_run_record()) == pytest.approx(2 * 50.0 / 1e3)
    no_attn = _run_record()
    no_attn["timeline"] = Timeline(
        [op for op in no_attn["timeline"].device if "sdpa" not in op[0]],
        no_attn["timeline"].spans)
    assert sam_attn_ms.read(no_attn) is None


def test_step_mfu_sam_counts_the_encoder_at_bf16_and_the_rest_at_f32():
    step = R.module("metrics", "step_mfu.sam")
    run = _run_record(2)
    run.update(traced_info=[[[5, 5, 6, 5], [3, 4, 3, 3]]] * 2,
               traced_counters={"matvec": 2 * 7}, pixels=4 * 2160 * 3840,
               matting_hw=(576, 1024), traced_window_s=0.3)
    f = sam_flops.call_flops(run["config"], 4, (576, 1024), 4 * 2160 * 3840,
                             7, 13)
    want = 100.0 * (f["bf16"] / 989e12 + f["f32"] / 67e12) / 0.15
    assert step.read(run) == pytest.approx(want)
    assert step.read(dict(run, timeline=None)) is None
