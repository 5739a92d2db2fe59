"""`device_idle_share` in the cells whose client holds plain pageable memory
(`host_memory` "pageable"): the same reading, under a name of its own
so that its bound or the end-to-end metric it moves is the pageable
client's, not the page-locked one's."""

from benchmark.metrics.device_idle_share import read  # noqa: F401
