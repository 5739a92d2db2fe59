"""The reader of `resize_ms`, on the CPU."""

import pytest

from benchmark.metrics import resize_ms
from benchmark.yardstick.timeline import Timeline


@pytest.mark.parametrize("name,resize", [
    ("void (anonymous namespace)::resample_kernel((anonymous namespace)::"
     "Args)", True),
    ("sm90_xmma_gemm_f64f64_f64f64_f64_nn_n_tilesize64x64x16_stage4_"
     "warpsize2x2x1_tensor16x8x8_execute_kernel__5x_cublas", True),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
     "tilesize256x64x32_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__"
     "5x_cudnn", False),
    ("void at::native::(anonymous namespace)::upsample_bilinear2d_out_frame"
     "<float, float>", False),
    ("void (anonymous namespace)::matvec_kernel<true>(float const*)", False),
])
def test_resize_patterns(name, resize):
    assert resize_ms.is_resize(name) is resize


def test_resize_ms_a_call():
    ops = [("void (anonymous namespace)::resample_kernel(Args)", 0.0, 300.0),
           ("sm90_xmma_gemm_f64f64_f64f64_f64_tn_n_cublas", 400.0, 500.0),
           ("void matvec_kernel<true>()", 500.0, 900.0)]
    run = {"timeline": Timeline(ops, []), "traced_calls": 2}
    assert resize_ms.read(run) == pytest.approx(0.2)
    assert resize_ms.read({"timeline": Timeline(ops[2:], []),
                           "traced_calls": 1}) is None
    assert resize_ms.read({"traced_calls": 1}) is None
