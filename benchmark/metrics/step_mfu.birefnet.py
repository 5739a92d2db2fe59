"""The whole call's share of the card's published peaks, in %, for
BiRefNet: `step_mfu` with BiRefNet's FLOPs in place of the CNN's
(`yardstick/birefnet_flops.call_flops`: the network at bf16, conv_out1
and the matting, k-means and palette-map arithmetic at float32), each
part over the peak of its own precision, summed, over the traced
window's time a call."""

from benchmark.yardstick import birefnet_flops
from benchmark.yardstick.peaks import PEAK_FLOPS


def read(run):
    tl = run.get("timeline")
    if tl is None or not tl.device or not all(run["traced_info"]):
        return None
    n = run["traced_calls"]
    lloyd = sum(sum(it[1]) for it in run["traced_info"]) / n
    f = birefnet_flops.call_flops(run["config"], run["frames"],
                                  run["matting_hw"], run["pixels"],
                                  run["traced_counters"]["matvec"] / n, lloyd)
    least_s = sum(f[k] / PEAK_FLOPS[k] for k in f)
    return 100.0 * least_s / (run["traced_window_s"] / n)
