"""BiRefNet's deformable convolutions against their roofline, in %: the
least time of a call's 20 launches (`yardstick/birefnet_flops`: each
launch's 2 B H W 64 256 k^2 operations at the bf16 peak, 989 TFLOP/s, or
its input, offsets, modulators, weight and output once at 3.35 TB/s,
whichever is larger) over their device time in the traced window
(`deform_ms`). Where the profiler dropped a launch's record, the bound
counts the launches recorded at the call's mean bound a launch. None
where a traced call ran no such kernel."""

from benchmark.metrics.deform_ms import launches
from benchmark.yardstick import birefnet_flops


def read(run):
    got = launches(run)
    if not got:
        return None
    shapes = birefnet_flops.deform_launches(run["config"]["input_size"],
                                            run["frames"])
    per_launch = sum(birefnet_flops.deform_bound_s(*s)
                     for s in shapes) / len(shapes)
    busy_s = sum(e - s for s, e in got) / 1e6
    return 100.0 * per_launch * len(got) / busy_s
