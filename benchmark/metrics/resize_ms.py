"""Device time a call, in ms, of the resizes (ops/resize.resize_u8), by
name from the traced window's device timeline: the banded kernel
(`resample_kernel`, csrc/resample.cu) and the dense float64 GEMMs that ran
the resizes before it (`sm90_xmma_gemm_f64f64_..._cublas`, as an H100
with PyTorch 2.11 and CUDA 12.8 names them). The float64 casts,
transposes and roundings around those GEMMs are not counted. None where
a traced call ran neither."""

import re

RESIZE = re.compile(r"resample_kernel|gemm_f64")


def is_resize(name: str) -> bool:
    return bool(RESIZE.search(name))


def read(run):
    tl = run.get("timeline")
    if tl is None:
        return None
    ms = sum(e - s for name, s, e in tl.device if is_resize(name)) / 1e3
    return ms / run["traced_calls"] if ms > 0 else None
