"""Structured throughput/quality instrumentation, and the program's spans.

Counterpart of image_segmenter_tpu/utils/profiling.py on torch.profiler:
MP/sec, the mask-IoU metric BASELINE.json scores against, and the device
timeline of a traced function. `capture_device_trace` reports device time
only: on a run that put nothing on a card it returns an empty list, never
the host's operations.

Spans and counters. Tracing is on exactly while a torch.profiler records
(PyTorch's own flag, `torch.autograd.profiler._is_profiler_enabled`);
nothing else turns it on. Off, a span site costs a call, that one
attribute read and a branch. On, `span(name, *attrs)` opens a range of
the profiler's (the fast form of `torch.profiler.record_function`, which
skips the dispatcher: about a fifth of its host time), so the span sits
on the profiler's clock beside the device's operations in every trace
that records the host, and also joins an in-memory record: the
outermost span open in a thread begins a call (`pipeline.run` is the
root of a `Pipeline.run` call), and every span opened inside it joins
that call with its parent. The record keeps the last `CALLS` calls in a
preallocated ring whose span slots are reused. `setup_span` is for work
done once a shape or once an object, off the hot path: it is recorded
whether or not tracing is on, in a list of its own (the last
`SETUP_SPANS`), and joins the open call as well while tracing. While
tracing, each run of Python's collector is a `host.gc` span, so that a
collector pause is never taken for the span it interrupts. `record()`
returns what is kept, with each call's counters (flag reads, graph
replays, chunks a loop class) counted from its spans; `clear()` empties
it.

The spans of the program, by name:

- `pipeline.run` (pipeline/segment.Pipeline.run, every path): a call's
  root;
- `compiled.ingest`, attrs (program,): pipeline/compiled.Compiled's copy
  of the caller's tensors into its static inputs, which blocks the host;
- `compiled.segment`, attrs (graph index,): the replay of one graph of
  straight code; (graph index, model id) for a prompted model's network
  stage (models/sam.py), a graph of its own;
- `loop.flag`, attrs (loop class,): the host's read of a loop's stop flag,
  between a loop's graph replays and in utils/loops.Loop.run;
- `loop.step`, attrs (loop class, graph index): the replay of a loop's
  chunk; attrs (loop class,) for an eager `step()` in Loop.run; a loop
  with an `update` path (solvers/matting.CGLoop: "fused" or "plain")
  adds it as a third attr, after None in Loop.run;
- `compiled.outputs`: the clones of a program's outputs;
- `host.gc`, attrs (generation,): a run of the collector;
- `compiled.capture`, attrs (program,) (a setup span): a program's first
  call, its warm-up, its captures and their first replays;
- `pipeline.init`, attrs (model,) (a setup span): `Pipeline()`, its
  session with seeded weights and its stage functions;
- `sam.encoder`, `sam.prompt`, `sam.decoder` (setup spans):
  models/sam.Sam's image encoder, prompt encoder and mask decoder, each
  time Python runs them: at a program's warm-up and capture on the card,
  at every eager call.

Counters: besides each call's counters above, the kernels' wrappers
count their launches (`LAUNCHES`, kernels/*.py) and SAM's network stage
its frames and box prompts (`models.sam.FRAMES`, `PROMPTS`), each a
module-level int bumped in Python. A graph's replay runs no Python, so
each such counter is declared through `replayed_counter`, which
registers it, and pipeline/compiled.py takes back what a capture
counted of every registered counter and adds it at each replay.

A program is numbered in the order programs were made, so a call's
`compiled.ingest` names the `compiled.capture` of the program it
replayed.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import itertools
import json
import os
import sys
import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _AP


# calls the record keeps, and setup spans
CALLS = 64
SETUP_SPANS = 256


class Span(NamedTuple):
    """A span of the record. `call`: the id of its call (0 for a setup
    span recorded with no call open); `parent`: the index of its parent
    in the call's spans, -1 for the root (and for a setup span in
    `Record.setup`); `start`, `end`: `time.perf_counter_ns()`, `end` None
    while it is open; `attrs`: what the site gave."""
    name: str
    call: int
    parent: int
    start: int
    end: Optional[int]
    attrs: tuple


class Call(NamedTuple):
    """One call: its spans in the order they opened (the root first) and
    its counters, counted from them: `flag_reads` the `loop.flag` spans,
    `graph_replays` the `compiled.segment` spans and the `loop.step`
    spans replayed from a graph, `chunks` the `loop.step` spans of each
    loop class, `fused_chunks` the `loop.step` spans whose update path
    is "fused"."""
    id: int
    spans: list
    flag_reads: int
    graph_replays: int
    chunks: dict
    fused_chunks: int = 0


class Record(NamedTuple):
    calls: list   # [Call] of the last CALLS calls recorded, oldest first
    setup: list   # [Span] of the setup spans, oldest first


class _Slot:
    """A reusable span slot of a call in the ring."""
    __slots__ = ("name", "parent", "start", "end", "attrs")


class _Call:
    """A call in the ring: `n` of its slots in use, `top` the innermost
    open span, `done` once its root has closed."""
    __slots__ = ("id", "slots", "n", "top", "done")

    def __init__(self):
        self.id, self.slots, self.n, self.top, self.done = 0, [], 0, -1, False


class _Thread(threading.local):
    call = None  # the call open in this thread
    gc = None    # the `host.gc` span open in this thread


_ring = [_Call() for _ in range(CALLS)]
_ids = itertools.count(1)
_setup: collections.deque = collections.deque(maxlen=SETUP_SPANS)
_thread = _Thread()
_OFF = contextlib.nullcontext()


class _Traced:
    """A span opened while tracing. The collector may run at any
    allocation and record a `host.gc` span into the same call, so
    `__enter__` makes every object it needs before it claims a slot."""
    __slots__ = ("name", "attrs", "rf", "call", "i")

    def __init__(self, name: str, attrs: tuple):
        self.name, self.attrs = name, attrs
        self.rf = _RecordFunctionFast(name)

    def __enter__(self):
        c = _thread.call
        if c is None:  # the outermost span: a new call
            cid = next(_ids)
            c = _ring[cid % CALLS]
            c.id, c.n, c.top, c.done = cid, 0, -1, False
            _thread.call = c
        slots = c.slots
        while c.n >= len(slots):
            slots.append(_Slot())
        i = c.n
        c.n = i + 1
        s = slots[i]
        s.name, s.parent, s.attrs, s.end = self.name, c.top, self.attrs, None
        c.top = i
        self.call, self.i = c, i
        s.start = time.perf_counter_ns()
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        c = self.call
        s = c.slots[self.i]
        s.end = time.perf_counter_ns()
        c.top = s.parent
        if s.parent < 0:  # the root closed: the call is whole
            c.done = True
            _thread.call = None
        return False


def span(name: str, *attrs):
    """A span around a `with` block, recorded while tracing; a no-op
    context otherwise."""
    if _AP._is_profiler_enabled:
        return _Traced(name, attrs)
    return _OFF


@contextlib.contextmanager
def setup_span(name: str, *attrs):
    """A span around work done once a shape or once an object: recorded
    in `Record.setup` whether or not tracing is on, and in the open call
    as any span while tracing."""
    c = _thread.call
    t0 = time.perf_counter_ns()
    try:
        with span(name, *attrs):
            yield
    finally:
        _setup.append(Span(name, 0 if c is None else c.id, -1, t0,
                           time.perf_counter_ns(), attrs))


def _on_gc(phase: str, info: dict) -> None:
    if phase == "start":
        if _AP._is_profiler_enabled:
            g = _Traced("host.gc", (info["generation"],))
            g.__enter__()
            _thread.gc = g
    elif _thread.gc is not None:
        g, _thread.gc = _thread.gc, None
        g.__exit__(None, None, None)


gc.callbacks.append(_on_gc)


def _snapshot(c: _Call) -> Call:
    spans = [Span(s.name, c.id, s.parent, s.start, s.end, s.attrs)
             for s in c.slots[:c.n]]
    chunks: dict = {}
    flags = replays = fused = 0
    for s in spans:
        if s.name == "loop.flag":
            flags += 1
        elif s.name == "loop.step":
            chunks[s.attrs[0]] = chunks.get(s.attrs[0], 0) + 1
            replays += len(s.attrs) > 1 and s.attrs[1] is not None
            fused += s.attrs[2:] == ("fused",)
        elif s.name == "compiled.segment":
            replays += 1
    return Call(c.id, spans, flags, replays, chunks, fused)


def record() -> Record:
    """The calls recorded (the last `CALLS` whose root has closed) and
    the setup spans."""
    done = sorted((c for c in _ring if c.done), key=lambda c: c.id)
    return Record([_snapshot(c) for c in done], list(_setup))


def clear() -> None:
    """Empty the record; call it between calls."""
    for c in _ring:
        c.id, c.n, c.top, c.done = 0, 0, -1, False
    _setup.clear()


# the counters a graph's replay adds to: (module, attribute name)
_REPLAYED: list = []


def replayed_counter(module: str, attr: str) -> int:
    """Register the module-level int `attr` of the module named `module`
    (its `__name__`) as a counter of work done in Python, and return its
    start, 0: a module declares such a counter as `LAUNCHES =
    replayed_counter(__name__, "LAUNCHES")`. pipeline/compiled.Compiled
    adds at each replay of a graph what the graph's capture added to
    it."""
    entry = (sys.modules[module], attr)
    if entry not in _REPLAYED:
        _REPLAYED.append(entry)
    return 0


def replayed_counters() -> tuple:
    """The registered counters, (module, attribute name), in the order
    they were registered."""
    return tuple(_REPLAYED)


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
