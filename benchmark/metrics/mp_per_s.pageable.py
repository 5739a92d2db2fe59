"""`mp_per_s` in the cells whose client holds plain pageable memory
(`host_memory` "pageable"): the same reading, under a name of its own
so that its bound or the end-to-end metric it moves is the pageable
client's, not the page-locked one's."""

from benchmark.metrics.mp_per_s import read  # noqa: F401
