"""Structured throughput/quality instrumentation.

Counterpart of image_segmenter_tpu/utils/profiling.py on torch.profiler.
Every pipeline stage can be annotated for the profiler and reported as
MP/sec, plus the mask-IoU metric BASELINE.json scores against.
`capture_device_trace` reports device time only: on a run that put nothing
on a card it returns an empty list, never the host's operations.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace_stage(name: str):
    """torch.profiler annotation + wall-clock for one pipeline stage.

    The wall clock spans the block as the host runs it and does not
    synchronise: work the block queued on a card may still be running."""
    with torch.profiler.record_function(name):
        t0 = time.time()
        yield
        _last_times[name] = time.time() - t0


_last_times: dict = {}


def mp_per_sec(num_pixels: int, seconds: float) -> float:
    return num_pixels / 1e6 / max(seconds, 1e-12)


def mask_iou(a: np.ndarray, b: np.ndarray) -> float:
    """IoU of two binary masks — the BASELINE acceptance metric."""
    a = np.asarray(a) > 0
    b = np.asarray(b) > 0
    union = (a | b).sum()
    if union == 0:
        return 1.0
    return float((a & b).sum() / union)


def log_metric(metric: str, value: float, unit: str,
               extra: Optional[dict] = None, stream=None) -> dict:
    """One structured JSON metric line (the bench.py contract shape)."""
    rec = {"metric": metric, "value": round(float(value), 4), "unit": unit}
    if extra:
        rec.update(extra)
    print(json.dumps(rec), file=stream or sys.stderr)
    return rec


def stage_report() -> dict:
    """Wall-clock of stages traced since process start (name -> seconds)."""
    return dict(_last_times)


def capture_device_trace(fn, outdir: str):
    """Run fn() under torch.profiler and return the DEVICE-side op timings.

    Writes the Chrome trace to `outdir/trace.json`. Returns a list of
    (op_name, total_us, count) over the kernels, memsets and copies that
    ran on a CUDA device, sorted by total time; [] when fn put nothing on
    a card. The profiler can drop a record, never add one, so a count is
    a lower bound. With a card only the device is traced: the host's
    operations, which nothing here reads, made the trace of a training
    step with 40,000 device operations take 40 s to read back instead of
    12 (same device time and count, H100).
    """
    return capture_device_timeline(fn, outdir)[0]


def capture_device_timeline(fn, outdir: Optional[str] = None):
    """`capture_device_trace`, and also every device operation's interval:
    (ops, [(start_us, end_us), ...]). The Chrome trace is written only
    where `outdir` is given."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA if torch.cuda.is_available()
                  else ProfilerActivity.CPU]
    with profile(activities=activities) as prof:
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    if outdir is not None:
        os.makedirs(outdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(outdir, "trace.json"))

    agg = {}
    intervals = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        tot, cnt = agg.get(e.name, (0.0, 0))
        agg[e.name] = (tot + float(e.time_range.elapsed_us()), cnt + 1)
        intervals.append((float(e.time_range.start), float(e.time_range.end)))
    ops = sorted(((n, t, c) for n, (t, c) in agg.items()), key=lambda x: -x[1])
    return ops, intervals


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
