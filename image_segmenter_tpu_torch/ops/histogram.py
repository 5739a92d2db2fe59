"""256-bin histograms, u8 quantiles and Otsu thresholding, batched.

Counterpart of image_segmenter_tpu/ops/histogram.py. Every function takes
a leading batch axis and returns one result per image. The histogram is
kernel K1 (kernels/histogram.hist256) on a CUDA tensor and its plain
compare-reduce on a CPU tensor. The JAX package sends only inputs of at
least 2^18 elements to its kernel; that size gate is a TPU heuristic, so
here every CUDA input takes the kernel.
"""

from __future__ import annotations

import torch

from image_segmenter_tpu_torch.kernels.histogram import hist256
from image_segmenter_tpu_torch.ops.scan import cumsum


def histogram_u8(x: torch.Tensor) -> torch.Tensor:
    """(B, ...) uint8 -> (B, 256) float32 counts per image."""
    return hist256(x.reshape(x.shape[0], -1).contiguous())


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 if none), like
    jnp.argmax on a bool array."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def u8_quantile(x: torch.Tensor, q) -> torch.Tensor:
    """np.percentile(x, q*100) per image for uint8 data, from the
    histogram: linear interpolation at rank q*(N-1) on the cumulative
    counts. (B,) float32 for one q; for a tuple or list of q, (len(q), B),
    all from one histogram (one launch of K1)."""
    hist = histogram_u8(x)
    if isinstance(q, (tuple, list)):
        return torch.stack([_quantile_of_hist(hist, qi) for qi in q])
    return _quantile_of_hist(hist, q)


def _quantile_of_hist(hist: torch.Tensor, q: float) -> torch.Tensor:
    n = hist.sum(dim=-1)
    cum = cumsum(hist)  # cum[v] = # of elements <= v
    rank = q * (n - 1.0)
    lo_r = torch.floor(rank)
    frac = rank - lo_r
    # value at sorted position p = smallest v with cum[v] > p
    v_lo = _first_true(cum > lo_r[:, None])
    v_hi = _first_true(cum > (lo_r + 1.0)[:, None])
    v_hi = torch.where(cum[:, -1] > lo_r + 1.0, v_hi, v_lo)
    return v_lo.to(torch.float32) + frac * (v_hi - v_lo).to(torch.float32)


def otsu_threshold(x: torch.Tensor) -> torch.Tensor:
    """Otsu's threshold per image, cv2-compatible (class 0 is <= t; ties to
    the smallest t). (B,) float32."""
    hist = histogram_u8(x)
    total = hist.sum(dim=-1, keepdim=True)
    bins = torch.arange(256, dtype=torch.float32, device=x.device)
    w0 = cumsum(hist)                        # count of values <= t
    sum0 = cumsum(hist * bins)               # sum of values <= t
    sum_all = sum0[:, -1:]
    w1 = total - w0
    mu0 = torch.where(w0 > 0, sum0 / torch.clamp_min(w0, 1.0), 0.0)
    mu1 = torch.where(w1 > 0, (sum_all - sum0) / torch.clamp_min(w1, 1.0),
                      0.0)
    dmu = mu0 - mu1
    sigma_b = w0 * w1 * (dmu * dmu)
    valid = (w0 > 0) & (w1 > 0)
    sigma_b = torch.where(valid, sigma_b, -1.0)
    return torch.argmax(sigma_b, dim=-1).to(torch.float32)  # first max


def otsu_binarize(x: torch.Tensor) -> torch.Tensor:
    """cv2.threshold(x, 0, 255, THRESH_BINARY | THRESH_OTSU) per image ->
    uint8 {0, 255}, same shape as x."""
    t = otsu_threshold(x).reshape(-1, *([1] * (x.dim() - 1)))
    return torch.where(x.to(torch.float32) > t, 255, 0).to(torch.uint8)
