"""Multi-device parallelism: mesh construction, sharding specs, halo exchange.

Counterpart of image_segmenter_tpu/parallel. The reference is a
single-process desktop app with no distributed backend; this layer is new
design. Scaling axes, as in the JAX package:

- data: the batch of images splits across devices; independent until the
  outputs are gathered.
- space: the H axis of the pixel grid splits across devices; stencils see
  ghost rows from their neighbours (halo.py) and the matting solve's sums
  add per-device partials (solvers/matting.py).

PyTorch has no single-program partitioner, so within one process a single
controller drives a grid of device slots (mesh.py): it splits tensors by
hand, copies halo rows between slots and adds reduction partials on a
group's first slot. A slot is a `torch.device`, and a mesh may name one
device several times. Across processes the data axis is a
`torch.distributed` process group (distributed.py).
"""
