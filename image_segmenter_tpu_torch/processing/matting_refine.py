"""Reference-compatible matting_refine module (PyTorch port)."""

from image_segmenter_tpu_torch.compat.matting_refine import (  # noqa: F401
    build_trimap_from_alpha_and_strokes,
    simple_alpha_refine,
    refine_alpha_portrait,
    refine_alpha_portrait_small,
    refine_alpha_portrait_full_res,
    estimate_alpha_cf,
)
