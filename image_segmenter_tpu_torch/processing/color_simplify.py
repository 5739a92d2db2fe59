"""Reference-compatible color_simplify module (PyTorch port).

Mirrors the reference's app/processing/color_simplify.py's public surface.
"""

from image_segmenter_tpu_torch.compat.color_simplify import (  # noqa: F401
    simplify_colors_kmeans,
    simplify_colors_median_cut,
    simplify_colors_octree,
    simplify_colors_threshold,
    simplify_colors_adaptive,
    simplify_colors_perceptual,
    simplify_colors_perceptual_fast,
    simplify_colors_adaptive_distance,
    simplify_colors_hsv_clustering,
    simplify_colors_custom_palette,
    get_color_statistics,
    create_palette_from_colors,
    check_gpu_availability,
    get_recommended_algorithm,
)
