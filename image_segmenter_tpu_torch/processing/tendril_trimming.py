"""Reference-compatible tendril_trimming module (PyTorch port)."""

from image_segmenter_tpu_torch.compat.tendril_trimming import (  # noqa: F401
    TendrilTrimmer,
    trim_tendrils,
)
