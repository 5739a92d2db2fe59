"""PyTorch + CUDA port of image_segmenter_tpu for NVIDIA Hopper (sm_90a).

The package mirrors the JAX package's layout and names. It imports torch
and never jax: the JAX package stays the reference that the tests hold
this port against. Plain tensor code is PyTorch; the four Pallas kernels of
the main path (`pipeline.segment.Pipeline.run`) are hand-written CUDA C++
under `kernels/csrc/`, built with nvcc at first use (`kernels/_build.py`).

Routing rule (utils/backend.targets_cuda): a CUDA tensor goes to the
kernel, a CPU tensor to the kernel's plain PyTorch version. Nothing falls
back from one to the other.
"""

__version__ = "0.1.0"

from image_segmenter_tpu_torch.config import Defaults  # noqa: E402,F401
