"""Reference-compatible grabcut module (PyTorch port)."""

from image_segmenter_tpu_torch.compat.grabcut import apply_grabcut  # noqa: F401
