"""The reference's flat `processing` import surface, on the PyTorch port.

The reference app does `from processing.color_simplify import ...` with
`app/` on sys.path (see the reference's app/ui/main_window.py:32-36).
Counterpart of the repository's root `processing` package, which re-exports
the JAX package: each module here re-exports the same names from
image_segmenter_tpu_torch.compat. A function's signature is the
JAX package's with `device` (the card unless the caller asks for the CPU)
appended last.
"""
