"""The BiRefNet cell's pieces on the CPU: `correct` comes out false for the
control and for each fault in the program's place, the FLOP counts
against a dispatch count, and the three readers on synthetic timelines.

The runs here are the cell's, cut to a tiny BiRefNet (embed 24, depths
(2, 2, 2, 2), heads (1, 2, 4, 8), the published window and decoder
widths) at 160 x 160 and two frames of 270 x 480, against the cell's
own limits."""

import dataclasses
import json
import time

import pytest
import torch

from benchmark import run as R
from benchmark.metrics import deform_ms, deform_roofline, swin_attn_ms
from benchmark.reference import birefnet_plain as BP
from benchmark.reference import pipeline_run_birefnet as REF
from benchmark.yardstick import birefnet_flops, birefnet_weights
from benchmark.yardstick.sam_flops import MatmulCount
from benchmark.yardstick.timeline import Timeline

CELL = "birefnet_photo_4k_b4"
TINY = dict(embed_dim=24, depths=[2, 2, 2, 2], num_heads=[1, 2, 4, 8])
SIZE = 160
SEED = 2**31 + 29


@pytest.fixture
def plan(monkeypatch):
    from image_segmenter_tpu_torch.models import birefnet as B
    from image_segmenter_tpu_torch.models import registry as TR

    plan = R.Plan(R.load_manifest(), CELL, False)
    widths = dict(plan.config["widths"], **TINY)
    plan.config = dict(plan.config, widths=widths, input_size=[SIZE, SIZE])
    plan.traffic = dict(plan.traffic, frames=2, height=270, width=480,
                        tile=270, check_calls=2, trace_calls=1)
    monkeypatch.setitem(B.CONFIGS, "birefnet_swin_l", B.BiRefNetConfig(
        **{k: tuple(v) if isinstance(v, list) else v
           for k, v in widths.items()}))
    spec = TR.SPECS["birefnet-general"]
    monkeypatch.setitem(TR.SPECS, "birefnet-general",
                        dataclasses.replace(spec, size=(SIZE, SIZE)))
    monkeypatch.setattr(TR, "_sessions", {})
    return plan


def _run(plan):
    return R.run_cell(plan, seed=SEED, seconds=0.01, trace=False,
                      devices=["cpu"], t0=time.perf_counter())


def _ref(plan, state=None, **kw):
    cfg = plan.config
    if state is None:
        state = birefnet_weights.make_state(cfg, cfg["weight_seed"], "cpu")
    return REF.Reference(cfg, state, "cpu", **kw)


def test_a_sound_run_is_correct(plan):
    res = _run(plan)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"alpha_mad", "rgba_mismatch",
                                  "palette_mismatch"}
    assert set(res["metrics"]) == {"mp_per_s", "latency_ms_p95", "setup_s"}


def _offsets_zeroed(plan):
    ref = _ref(plan)
    ref.net.net.set("f32", {"offsets"})
    return ref


FAULTS = {
    "control": lambda p: _ref(p, control=True),
    "offsets_zeroed": _offsets_zeroed,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_in_the_programs_place_is_not_correct(plan, monkeypatch,
                                                      fault):
    ref = FAULTS[fault](plan)
    monkeypatch.setattr(plan.entry.Entry, "__call__",
                        lambda self, batch: ref(batch))
    res = _run(plan)
    assert not res["correct"], res["checks"]
    assert res["checks"]["alpha_mad"]["value"] > \
        res["checks"]["alpha_mad"]["limit"]


@pytest.mark.parametrize("trace", [False, True])
def test_every_item_of_the_cell_is_found_by_name(trace):
    p = R.Plan(R.load_manifest(), CELL, trace)
    assert p.config["entry"] == "pipeline_run_birefnet"
    assert p.traffic["generator"] == "photo_mosaic"
    assert set(p.limits) == {"alpha_mad", "rgba_mismatch",
                             "palette_mismatch"}
    names = [m["name"] for m, _ in p.metrics]
    assert all(callable(r.read) for _, r in p.metrics)
    assert names == (["h2d_ms", "device_idle_share", "cg_matvecs_per_batch",
                      "k3_roofline", "flag_reads_per_call",
                      "loop_turn_idle_ms", "segment_idle_ms", "capture_s",
                      "pipeline_init_s", "cg_fused_share", "resize_ms",
                      "step_mfu.birefnet", "deform_ms", "deform_roofline",
                      "swin_attn_ms"]
                     if trace else ["mp_per_s", "latency_ms_p95", "setup_s"])


def test_the_weights_load_strictly_into_the_port():
    from image_segmenter_tpu_torch.models import birefnet as B

    cfg = {"widths": TINY}
    state = birefnet_weights.make_state(cfg, 3, "cpu")
    net = B.BiRefNet(B.BiRefNetConfig(**{
        k: tuple(v) if isinstance(v, list) else v for k, v in TINY.items()}))
    net.load_state_dict(state, strict=True)
    assert torch.equal(state["bb.layers.0.blocks.0.attn."
                             "relative_position_index"],
                       B.relative_position_index(12))
    again = birefnet_weights.make_state(cfg, 3, "cpu")
    assert all(torch.equal(state[k], again[k]) for k in state)


def test_flops_match_a_dispatch_count():
    w = BP.widths(**TINY)
    net = BP.BiRefNetPlain(**TINY)
    with torch.no_grad(), MatmulCount() as count:
        net(torch.randn(1, 3, SIZE, SIZE))
    assert birefnet_flops.network_flops(w, (SIZE, SIZE), 2) == \
        2 * count.flops
    full = BP.widths()
    net_flops = birefnet_flops.network_flops(full, (1024, 1024), 4)
    assert 10.0e12 < net_flops < 10.3e12
    deform = sum(birefnet_flops.deform_flops(*s) for s in
                 birefnet_flops.deform_launches((1024, 1024), 4))
    assert 0.6e12 < deform < 0.8e12
    assert len(birefnet_flops.deform_launches((1024, 1024), 4)) == 20
    # the 7 x 7 branch at 4 x 256 x 256 is bound by its operations
    b = birefnet_flops.deform_bound_s(4, 256, 256, 7)
    assert b == pytest.approx(birefnet_flops.deform_flops(4, 256, 256, 7)
                              / 989e12)


def _timeline(calls):
    """A traced window of `calls` calls: a resize, the backbone's GEMM,
    a copy and two attention kernels, 20 deformable launches of 10 us,
    the matting."""
    device, spans, t = [], [], 0.0

    def op(name, us):
        nonlocal t
        device.append((name, t, t + us))
        t += us

    for _ in range(calls):
        spans.append(("bench.pipeline.run", t, t + 2000.0))
        op("resample_kernel", 30.0)
        for _ in range(2):
            op("nvjet_tst_192x176_64x4_1x2_h_bz_coopB_bias_TNT", 100.0)
            op("elementwise_kernel<128, 4, direct_copy_kernel_cuda>", 20.0)
            op("fmha_cutlassF_bf16_aligned_64x64_rf_sm80", 40.0)
        for _ in range(20):
            op("void (anonymous namespace)::deform_conv_kernel<2>("
               "(anonymous namespace)::Params)", 10.0)
            op("cutlass_tensorop_bf16_s16816fprop_optimized_bf16", 5.0)
        op("matvec_kernel<true>", 80.0)
        t += 2000.0 - 670.0
    return Timeline(device, spans)


def _run_record(calls=3):
    with open(R.ROOT / "benchmark/configs/birefnet_swinl_k16.json") as f:
        cfg = json.load(f)
    return {"timeline": _timeline(calls), "config": cfg, "frames": 4,
            "traced_calls": calls}


def test_deform_readers_read_the_kernel_by_name():
    run = _run_record()
    assert deform_ms.read(run) == pytest.approx(20 * 10.0 / 1e3)
    shapes = birefnet_flops.deform_launches((1024, 1024), 4)
    bound = sum(birefnet_flops.deform_bound_s(*s) for s in shapes)
    assert deform_roofline.read(run) == pytest.approx(
        100.0 * bound / (20 * 10e-6))
    bare = _run_record()
    bare["timeline"] = Timeline([op for op in bare["timeline"].device
                                 if "deform" not in op[0]],
                                bare["timeline"].spans)
    assert deform_ms.read(bare) is None and deform_roofline.read(bare) \
        is None


def test_swin_attn_ms_reads_the_attention_kernels():
    assert swin_attn_ms.read(_run_record()) == pytest.approx(2 * 40.0 / 1e3)
    bare = _run_record()
    bare["timeline"] = Timeline([op for op in bare["timeline"].device
                                 if "fmha" not in op[0]],
                                bare["timeline"].spans)
    assert swin_attn_ms.read(bare) is None


def test_step_mfu_birefnet_counts_the_network_at_bf16():
    step = R.module("metrics", "step_mfu.birefnet")
    run = _run_record(2)
    run.update(traced_info=[[[5, 5, 6, 5], [3, 4, 3, 3]]] * 2,
               traced_counters={"matvec": 2 * 7}, pixels=4 * 2160 * 3840,
               matting_hw=(576, 1024), traced_window_s=0.3)
    f = birefnet_flops.call_flops(run["config"], 4, (576, 1024),
                                  4 * 2160 * 3840, 7, 13)
    want = 100.0 * (f["bf16"] / 989e12 + f["f32"] / 67e12) / 0.15
    assert step.read(run) == pytest.approx(want)
    assert step.read(dict(run, timeline=None)) is None
