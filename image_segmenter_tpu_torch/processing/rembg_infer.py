"""Reference-compatible rembg_infer module (PyTorch port)."""

from image_segmenter_tpu_torch.compat.rembg_infer import (  # noqa: F401
    rembg_remove_bgr_to_rgba,
    remove,
    _get_session,
    _ensure_rgba,
    _resize_rgba,
    _make_alpha_sharp,
)
