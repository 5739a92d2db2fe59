"""The import guard: nothing a run loads may be JAX or the JAX package."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "image_segmenter_tpu")


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name (the part before the first
    dot) is, whole, one of FORBIDDEN: `image_segmenter_tpu_torch` is not
    `image_segmenter_tpu`."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)
