"""Input megapixels whose outputs reached the host, over the whole window
(from the first call's start to the end of the last completed call)."""

from benchmark.yardstick import stats


def read(run):
    return stats.rate(run["calls"], run["work"])
