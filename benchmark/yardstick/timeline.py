"""The device timeline of a traced window: a frozen copy of the port's
`utils/profiling.capture_device_timeline` and `busy_us`, which also keeps
each device operation's name and the benchmark's own host spans.

`capture(fn)` runs fn() under torch.profiler, the card's activity and the
host's, synchronises, and returns a `Timeline`: every operation that ran
on a CUDA device as (name, start_us, end_us), and the host spans that the
benchmark opened with `torch.profiler.record_function` (names that begin
with `SPAN_PREFIX`), both on the profiler's clock. The profiler can drop
a record, never add one. The traced window's length is taken by the
caller, inside fn, so that the profiler's own reading of its records
stays out of it.
"""

from __future__ import annotations

import re
from typing import NamedTuple

import torch

SPAN_PREFIX = "bench."


class Timeline(NamedTuple):
    device: list   # [(name, start_us, end_us)] of device operations
    spans: list    # [(name, start_us, end_us)] of the benchmark's spans
    index: dict = None  # {device index: [(start_us, end_us)]}


def capture(fn) -> Timeline:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize()
    device, spans, index = [], [], {}
    for e in prof.events():
        start, end = float(e.time_range.start), float(e.time_range.end)
        if e.name.startswith(SPAN_PREFIX):
            # the profiler also puts a span's annotation on the device's
            # rows; only the host's is a span, and neither is an operation
            if e.device_type != DeviceType.CUDA:
                spans.append((e.name, start, end))
        elif e.device_type == DeviceType.CUDA:
            device.append((e.name, start, end))
            index.setdefault(e.device_index, []).append((start, end))
    device.sort(key=lambda x: x[1])
    spans.sort(key=lambda x: x[1])
    return Timeline(device, spans, index)


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals: the time at least
    one device operation ran. A sum would count twice what overlaps."""
    total = 0.0
    end = float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def busy_s_per_device(tl: Timeline) -> float:
    """Seconds in which an operation ran on a device, averaged over the
    devices that ran one."""
    by = tl.index or {0: [(s, e) for _, s, e in tl.device]}
    return sum(busy_us(v) for v in by.values()) / len(by) / 1e6


def idle_gaps(device: list) -> list:
    """[(start_us, end_us, name of the operation before)] of the times in
    which no device operation ran, between the first start and the last
    end, longest first."""
    gaps = []
    end, last = None, None
    for name, s, e in sorted(device, key=lambda x: x[1]):
        if end is not None and s > end:
            gaps.append((end, s, last))
        if end is None or e > end:
            end, last = e, name
    return sorted(gaps, key=lambda g: g[0] - g[1])


_NOISE = re.compile(r"^void |at::native::|\(anonymous namespace\)::|c10::|"
                    r"at::|std::|cuda::")


def short_name(name: str, width: int = 120) -> str:
    """A device operation's name without the namespaces that every
    PyTorch kernel carries, cut to `width`: what tells kernels apart."""
    return _NOISE.sub("", name)[:width]


def span_at(spans: list, t: float) -> str:
    """The innermost benchmark span open at time t, or "harness"."""
    best = None
    for name, s, e in spans:
        if s <= t <= e and (best is None or s >= best[1]):
            best = (name, s)
    return best[0][len(SPAN_PREFIX):] if best else "harness"
