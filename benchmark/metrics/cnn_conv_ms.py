"""Device time a call of the CNN's convolution kernels, by name from the
traced window's device timeline: cuDNN's forward convolutions
(`sm90_xmma_fprop_implicit_gemm_bf16...`, `sm80_xmma_fprop_implicit_gemm_
f32...`, `cutlass_tensorop_bf16_s16816fprop...`, `implicit_convolve_sgemm`)
and the layout transforms cuDNN runs around them
(`cudnn::engines_precompiled::nchwToNhwcKernel`, `nhwcToNchwKernel`), as
an H100 with PyTorch 2.11 and CUDA 12.8 names them. The float64 GEMMs of
the resizes (`ops/resize`, `sm90_xmma_gemm_f64f64..._cublas`) do not
match."""

import re

CONV = re.compile(r"fprop|cudnn|convolve")


def is_conv(name: str) -> bool:
    return bool(CONV.search(name))


def read(run):
    tl = run.get("timeline")
    if tl is None:
        return None
    ms = sum(e - s for name, s, e in tl.device if is_conv(name)) / 1e3
    return ms / run["traced_calls"] if ms > 0 else None
