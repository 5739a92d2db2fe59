"""The frozen copies and the arithmetic of the metrics, on the CPU."""

import hashlib

import numpy as np
import pytest
import torch

from benchmark.metrics import cnn_conv_ms, device_idle_share, \
    k3_roofline, latency_ms_p95, mp_per_s, step_mfu
from benchmark.reference import nets
from benchmark.generators import photo_mosaic
from benchmark.yardstick import corpus, flops, guard, stats, timeline, \
    weights
from benchmark.yardstick.timeline import Timeline


def test_png_decoder_reads_every_corpus_photo_to_its_sha256():
    for e in corpus.manifest():
        rgb = corpus.read_photo(e)
        assert list(rgb.shape) == e["shape"]
        assert hashlib.sha256(rgb.tobytes()).hexdigest() == e["sha256"]


def test_png_decoder_matches_the_ports():
    from image_segmenter_tpu_torch.cli import _png_decode

    data = (corpus.CORPUS / "flower.png").read_bytes()
    assert np.array_equal(corpus.png_decode(data), _png_decode(data))


def test_int32_bilinear_matches_the_ports_int64():
    from image_segmenter_tpu_torch.bench.corpus import pil_bilinear_u8

    rng = np.random.default_rng(3)
    for shape, size in (((57, 91, 3), (80, 33)), ((40, 40), 97)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        assert np.array_equal(corpus.pil_bilinear_u8(img, size),
                              pil_bilinear_u8(img, size))


def test_mosaic_is_the_ports_photo_batch_at_offset_0():
    from image_segmenter_tpu_torch.bench.bench import photo_batch

    tiles = corpus.load_tiles(1080)
    assert np.array_equal(corpus.mosaic(tiles, 0, 3, 90, 2300),
                          photo_batch(3, 90, 2300))


def test_batches_are_the_mosaic_at_each_offset():
    tr = {"generator": "photo_mosaic", "frames": 3, "height": 40,
          "width": 150, "tile": 64, "host_memory": "page_locked",
          "check_calls": 1, "trace_calls": 1}
    bs = photo_mosaic.batches(tr)
    tiles = corpus.load_tiles(64)
    assert len(bs) == len(tiles) == 14
    for o in (0, 5, 13):
        assert np.array_equal(bs[o], corpus.mosaic(tiles, o, 3, 40, 150))
    seed = 2**31 + 3
    assert photo_mosaic.first_offset(seed, 14) == seed % 14
    calls = photo_mosaic.make(tr, seed, [torch.device("cpu")])
    assert len(calls) == 14
    for j in (0, 1, 13):
        assert np.array_equal(calls[j], bs[(seed + j) % 14])
    with pytest.raises(ValueError, match="host_memory"):
        photo_mosaic.check(dict(tr, host_memory="mapped"))


def test_window_ends_at_the_last_completed_call():
    calls = [(1.0, 1.5), (1.5, 2.25), (2.25, 3.0)]
    assert stats.window_s(calls) == 2.0
    assert stats.rate(calls, [4.0, 4.0, 4.0]) == 6.0
    run = {"calls": calls, "work": [4.0, 4.0, 4.0]}
    assert mp_per_s.read(run) == 6.0
    lat = [500.0, 750.0, 750.0]
    assert latency_ms_p95.read(run) == pytest.approx(
        float(np.percentile(lat, 95)))


def test_percentile_is_numpys():
    rng = np.random.default_rng(0)
    v = list(rng.normal(100, 5, 201))
    for q in (50, 95, 99):
        assert stats.percentile(v, q) == pytest.approx(np.percentile(v, q))
    assert stats.percentile([7.0], 95) == 7.0


def test_busy_is_the_union_and_gaps_lie_between():
    ops = [("a", 0.0, 10.0), ("b", 5.0, 12.0), ("c", 20.0, 25.0),
           ("d", 21.0, 22.0), ("e", 30.0, 31.0)]
    assert timeline.busy_us([(s, e) for _, s, e in ops]) == 18.0
    gaps = timeline.idle_gaps(ops)
    assert [(a, b) for a, b, _ in gaps] == [(12.0, 20.0), (25.0, 30.0)]
    assert gaps[0][2] == "b"
    spans = [("bench.pipeline.run", 0.0, 26.0),
             ("bench.outputs.to_host", 26.0, 32.0)]
    assert timeline.span_at(spans, 16.0) == "pipeline.run"
    assert timeline.span_at(spans, 28.0) == "outputs.to_host"
    assert timeline.span_at(spans, 40.0) == "harness"
    run = {"timeline": Timeline(ops, spans), "traced_window_s": 40e-6}
    assert device_idle_share.read(run) == pytest.approx(55.0)


def test_busy_is_averaged_over_the_devices_that_ran():
    ops = [("a", 0.0, 10.0), ("b", 0.0, 4.0), ("c", 5.0, 9.0)]
    one = Timeline(ops, [])
    assert timeline.busy_s_per_device(one) == pytest.approx(10e-6)
    two = Timeline(ops, [], {0: [(0.0, 10.0)], 1: [(0.0, 4.0), (5.0, 9.0)]})
    assert timeline.busy_s_per_device(two) == pytest.approx(9e-6)
    run = {"timeline": two, "traced_window_s": 20e-6}
    assert device_idle_share.read(run) == pytest.approx(55.0)


def test_short_names_keep_what_tells_kernels_apart():
    name = ("void at::native::elementwise_kernel<128, 2, at::native::"
            "gpu_kernel_impl_nocast<at::native::(anonymous namespace)::"
            "where_kernel_impl(at::TensorIterator&)::{lambda()#1}>(int)")
    short = timeline.short_name(name)
    assert short.startswith("elementwise_kernel<128, 2, gpu_kernel_impl_")
    assert "where_kernel_impl" in short and len(short) <= 120
    assert timeline.short_name("Memcpy HtoD (Pinned -> Device)") == \
        "Memcpy HtoD (Pinned -> Device)"


def test_readers_say_nothing_without_a_trace():
    run = {"timeline": Timeline([], []), "traced_calls": 1,
           "traced_info": [[]], "traced_counters": {"matvec": 0}}
    for reader in (device_idle_share, step_mfu, k3_roofline, cnn_conv_ms):
        assert reader.read(run) is None


def test_k3_bytes_and_roofline():
    assert flops.k3_bytes((576, 1024), 4) == 141_557_760
    assert flops.matting_hw(2160, 3840, 1024) == (576, 1024)
    assert flops.matting_hw(500, 700, 1024) == (500, 700)
    # 100 launches at the bound take 100 x 141.56 MB / 3.35 TB/s
    t_us = 100 * 141_557_760 / 3.35e12 * 1e6
    ops = [("void (anonymous namespace)::matvec_kernel<true>(float const*)",
            0.0, 2 * t_us), ("void matvec_stack_kernel()", 0.0, 5.0)]
    run = {"timeline": Timeline(ops, []), "traced_counters": {"matvec": 100},
           "matting_hw": (576, 1024), "frames": 4}
    assert k3_roofline.read(run) == pytest.approx(50.0)


def test_step_mfu_from_counts():
    cfg = {"arch": "u2netp", "input_size": [320, 320], "k": 16}
    f = flops.call_flops(cfg, 4, (576, 1024), 4 * 2160 * 3840, 201, 20)
    least = f["bf16"] / 989e12 + f["f32"] / 67e12
    run = {"timeline": Timeline([("k", 0.0, 1.0)], []), "config": cfg,
           "frames": 4, "pixels": 4 * 2160 * 3840, "traced_calls": 2,
           "matting_hw": (576, 1024), "traced_counters": {"matvec": 402},
           "traced_info": [[[1] * 4, [5] * 4], [[1] * 4, [5] * 4]],
           "traced_window_s": 0.2}
    assert step_mfu.read(run) == pytest.approx(100 * least / 0.1)
    assert 0 < step_mfu.read(run) < 100


def test_cnn_flops_split_by_precision():
    f = flops.cnn_flops("u2netp", (320, 320), 4)
    assert f["bf16"] > 50 * f["f32"] > 0
    assert flops.cnn_flops("u2netp", (320, 320), 1)["bf16"] * 4 == f["bf16"]
    assert flops.cnn_flops("isnet", (64, 64), 1)["bf16"] > 0


@pytest.mark.parametrize("name,conv", [
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
     "tilesize256x64x32_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__"
     "5x_cudnn", True),
    ("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_"
     "tilesize64x32x8_stage3_warpsize1x2x1_g1_ffma_aligna4_alignc4_execute_"
     "kernel__5x_cudnn", True),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16>", True),
    ("void implicit_convolve_sgemm<__nv_bfloat16, __nv_bfloat16, 1024>", True),
    ("void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_"
     "optimized_bf16_64x64_32x10_nhwc_align8>", True),
    ("sm90_xmma_gemm_f64f64_f64f64_f64_nn_n_tilesize64x64x16_stage4_"
     "warpsize2x2x1_tensor16x8x8_execute_kernel__5x_cublas", False),
    ("void (anonymous namespace)::matvec_kernel<true>(float const*)", False),
    ("Memcpy HtoD (Pinned -> Device)", False),
])
def test_conv_patterns(name, conv):
    assert cnn_conv_ms.is_conv(name) is conv


def test_import_guard_compares_whole_top_level_names():
    assert guard.forbidden_modules({"image_segmenter_tpu_torch": 1,
                                    "image_segmenter_tpu_torch.ops": 1,
                                    "jaxtyping": 1, "numpy": 1}) == []
    assert guard.forbidden_modules({"jax": 1, "jax.numpy": 1,
                                    "image_segmenter_tpu.ops": 1,
                                    "flax": 1, "numpy": 1}) == [
        "flax", "image_segmenter_tpu.ops", "jax", "jax.numpy"]


def test_this_process_loads_no_jax():
    assert guard.forbidden_modules() == []


def test_weights_are_seeded_and_load_into_the_port():
    from image_segmenter_tpu_torch.models.u2net import U2NET

    a = weights.make_state("u2netp", 7, "cpu")
    b = weights.make_state("u2netp", 7, "cpu")
    c = weights.make_state("u2netp", 8, "cpu")
    k = "stage1.rebnconvin.conv_s1.weight"
    assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
    assert float(a[k].abs().max()) <= 2 / 0.8796 / 27 ** 0.5 + 1e-6
    U2NET(small=True).load_state_dict(a, strict=True)
    net = nets.build("u2netp")
    net.load_state_dict(a, assign=True)
    assert net.stage1.rebnconvin.conv_s1.weight.data_ptr() == a[k].data_ptr()


def test_reservoir_keeps_a_seeded_sample():
    from benchmark.run import _reservoir

    def sample(seed, n, m):
        keep = _reservoir(np.random.default_rng(seed), m)
        slots = [None] * m
        for j in range(n):
            s = keep(j)
            if s is not None:
                slots[s] = j
        return slots

    assert sample(5, 100, 3) == sample(5, 100, 3)
    assert sample(5, 2, 3) == [0, 1, None]
    assert len(set(sample(5, 100, 3))) == 3
