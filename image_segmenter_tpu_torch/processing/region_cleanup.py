"""Reference-compatible region_cleanup module (PyTorch port).

Mirrors the reference's app/processing/region_cleanup.py's public surface.
"""

from image_segmenter_tpu_torch.compat.region_cleanup import (  # noqa: F401
    analyze_regions,
    find_neighboring_colors_for_component,
    find_neighboring_colors,
    calculate_merge_score,
    color_distance,
    merge_small_regions,
    flood_fill_region,
    _manual_flood_fill,
    get_component_bounding_box,
    get_region_boundaries,
    smooth_region_boundaries,
)
