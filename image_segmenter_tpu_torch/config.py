"""The reference app's widget defaults, copied from image_segmenter_tpu/config.py.

The reference app has no config system; its widget defaults are hardcoded.
Every field of the JAX package's `Defaults` is here but `matting_dd`
(float64 emulated in float32 pairs on the TPU; CUDA has native float64).

- brush size 24, range 3-100 ............ app/ui/bg_tools_panel.py:53-56
- AI opacity threshold 128, 0-255 ....... app/ui/bg_tools_panel.py:63-66
- rembg default model ................... app/ui/main_window.py:460, bg_tools_panel.py:153
- num_colors 8, range 2-256 ............. app/ui/color_processing_panel.py:110-113
- min region size 100, range 10-1000 .... app/ui/region_cleanup_panel.py:189-196
- auto-merge threshold 70% .............. app/ui/region_cleanup_panel.py:207-218
- connectivity 8 (combo 8/4) ............ app/ui/region_cleanup_panel.py:226-230
- smoothing strength 50% ................ app/ui/region_cleanup_panel.py:297-337
- matting max dim 1024 .................. app/processing/matting_refine.py:105
- trimap thresholds 220 / 20 ............ app/processing/matting_refine.py:14-20
- kmeans random_state=42, n_init=10 ..... app/processing/color_simplify.py:79-81
- perceptual sample cap 10000 ........... app/processing/color_simplify.py:393
- perceptual_fast max dim 512 / 5000 .... app/processing/color_simplify.py:608,632
- grabcut iterations 10 ................. app/ui/main_window.py:300,318,363,365
- region-merge pass cap 20 .............. app/processing/region_cleanup.py:368
- tendril threshold 2 / iter cap 30 ..... app/test_smoothing_algorithms.py:455-457,
                                          app/processing/tendril_trimming.py:33
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Defaults:
    # Brush / UI-facing
    brush_size: int = 24
    opacity_threshold: int = 128
    rembg_model: str = "isnet-general-use"
    # Matting
    matting_max_dim: int = 1024
    matting_fg_threshold: int = 220
    matting_bg_threshold: int = 20
    # float64 CG polish of certified float32 matting solves (warm-started
    # at the float32 alpha; closes the gap to pymatting's exact eps and
    # rtol 1e-7 at the cost of a few iterations). pymatting is always
    # float64, so True is the reference-faithful default. The JAX package's
    # `matting_dd` switch (float64 emulated in float32 pairs on the TPU) has
    # no counterpart: CUDA has native float64.
    matting_f64_polish: bool = True
    # Color simplification
    num_colors: int = 8
    kmeans_seed: int = 42
    kmeans_n_init: int = 10
    perceptual_max_samples: int = 10000
    perceptual_fast_max_dim: int = 512
    perceptual_fast_max_samples: int = 5000
    # GrabCut
    grabcut_iterations: int = 10
    grabcut_gmm_components: int = 5
    # After the EM alternations, propose GMM split-merge moves and keep the
    # best mask under the standardized energy (solvers/grabcut.py
    # _splitmerge_polish): it escapes the EM local optima cv.grabCut is
    # stuck in on quantized or few-colour images. False reproduces the
    # plain alternation (one deterministic cv2-style run).
    grabcut_splitmerge: bool = True
    # Above this max dim the polish's candidate search runs on an
    # AREA-downscaled image (the GMM candidates live in colour space); only
    # the winner is continued and accepted at full resolution.
    grabcut_polish_search_dim: int = 256
    # When the alternation collapses to an (almost) empty foreground,
    # re-run it with a core of the init-FG region clamped to hard FG, then
    # release the clamp, and keep whichever mask has the lower
    # standardized energy: all-BG is an absorbing EM state on
    # statistically homogeneous scenes.
    grabcut_collapse_restart: bool = True
    # Reproduce the reference's bugs instead of fixing them: the kmeans
    # chained-fancy-index no-op that leaves the output RGB black
    # (color_simplify.py:90) and perceptual's map of LAB pixels against RGB
    # centres (color_simplify.py:544).
    bug_compat: bool = False
    # Region cleanup: the most merge passes merge_small_regions makes
    merge_max_passes: int = 20
    min_region_size: int = 100
    auto_merge_threshold: float = 0.7
    connectivity: int = 8
    smoothing_strength: float = 0.5
    # Tendril trimming
    tendril_threshold: int = 2
    tendril_max_iterations: int = 30


DEFAULTS = Defaults()

# rembg model ids the reference UI exposes (app/ui/bg_tools_panel.py:142-149)
REMBG_MODELS = (
    "isnet-general-use",
    "u2net",
    "u2netp",
    "u2net_human_seg",
    "u2net_cloth_seg",
    "isnet-anime",
    "silueta",
)
