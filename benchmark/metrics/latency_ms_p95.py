"""The 95th percentile, over every call in the window, of one call's time
from handing host numpy to the entry until its outputs are on the host."""

from benchmark.yardstick import stats


def read(run):
    return stats.percentile([(e - s) * 1e3 for s, e in run["calls"]], 95)
