"""The defaults the port reads, copied from image_segmenter_tpu/config.py.

The reference app has no config system; its widget defaults are hardcoded.
Only the fields this port's code reads are copied here.

- matting max dim 1024 .................. app/processing/matting_refine.py:105
- trimap thresholds 220 / 20 ............ app/processing/matting_refine.py:14-20
- kmeans random_state=42, n_init=10 ..... app/processing/color_simplify.py:79-81
- perceptual_fast max dim 512 / 5000 .... app/processing/color_simplify.py:608,632
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Defaults:
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
    kmeans_seed: int = 42
    kmeans_n_init: int = 10
    perceptual_fast_max_dim: int = 512
    perceptual_fast_max_samples: int = 5000
    # Reproduce the reference's bugs instead of fixing them: the kmeans
    # chained-fancy-index no-op that leaves the output RGB black
    # (color_simplify.py:90) and perceptual's map of LAB pixels against RGB
    # centres (color_simplify.py:544).
    bug_compat: bool = False


DEFAULTS = Defaults()
