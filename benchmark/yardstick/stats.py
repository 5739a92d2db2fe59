"""The arithmetic of the end-to-end metrics.

A window runs from the first call's start to the end of the last call
that completed; the rate is the work of every completed call over the
whole window, and the tail is taken over every call's time.
"""

from __future__ import annotations


def window_s(calls: list) -> float:
    """calls: [(start_s, end_s)] in the order made. The window's length,
    from the first start to the last end."""
    if not calls:
        raise ValueError("no call completed in the window")
    return calls[-1][1] - calls[0][0]


def rate(calls: list, work: list) -> float:
    """The work of every completed call (`work`, a number a call) over
    the whole window."""
    return sum(work) / window_s(calls)


def percentile(values: list, q: float) -> float:
    """The q-th percentile (0 < q < 100) by linear interpolation between
    the closest ranks (numpy's default, `statistics.quantiles`'
    "inclusive" method)."""
    if len(values) == 1:
        return float(values[0])
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)

