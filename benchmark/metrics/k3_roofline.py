"""K3's share of its roofline, in %: its launches' bytes at the cell's
matting shape (`yardstick/flops.k3_bytes`: each input once, the output
once) over the published 3.35 TB/s, against the device time of the
operations named as K3 in the traced window's timeline. K3 is bound by
its bytes: its operations over 67 TFLOP/s take less."""

import re

from benchmark.yardstick import flops
from benchmark.yardstick.peaks import PEAK_HBM_BYTES_S

K3_NAME = re.compile(r"(^|\W)matvec_kernel\b")


def read(run):
    tl = run.get("timeline")
    if tl is None:
        return None
    t_s = sum(e - s for name, s, e in tl.device if K3_NAME.search(name)) / 1e6
    launches = run["traced_counters"]["matvec"]
    if t_s <= 0 or launches == 0:
        return None
    least = launches * flops.k3_bytes(run["matting_hw"], run["frames"]) \
        / PEAK_HBM_BYTES_S
    return 100.0 * least / t_s
