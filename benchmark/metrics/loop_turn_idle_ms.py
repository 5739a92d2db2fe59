"""Device idle a call, in ms, while the host is inside a loop's turn: the
read of its stop flag (`loop.flag`) or the launch of its chunk
(`loop.step`), spans of the program's own record
(`image_segmenter_tpu_torch.utils.profiling.record()`).

This module also holds what the readers of the program's record share.
The record's clock is the host's `time.perf_counter_ns()`, the
timeline's the profiler's. The k-th traced call's root, `pipeline.run`,
is aligned to the k-th `bench.pipeline.run` span of the timeline, which
opens before it: that delay (tens of microseconds on an H100's host) is
the error of this first alignment, and a bound on the clocks' offset
from below. Where the call's flag reads (`loop.flag`) and the
device-to-host copies inside its benchmark span are as many, each read
waits on the copy of the same rank and ends after it, so each copy's end
less its read's end is another such bound; the largest is taken (16-48
us below the profiler's own placing of the spans, on an H100's host).
Device idle inside a `bench.pipeline.run` span is its part of the
timeline's idle gaps (`yardstick/timeline.idle_gaps`), and each stretch
of it goes to the innermost program span open then: a span of the call,
or a `host.gc` span recorded outside it, between the program's root and
the benchmark's span; "outside" where the host is in no program span. A
run whose program keeps no record (a program without these spans), or
whose timeline holds no device operation, gives None."""

from benchmark.yardstick.timeline import idle_gaps

BENCH_SPAN = "bench.pipeline.run"
ROOT = "pipeline.run"
LOOP = ("loop.flag", "loop.step")


def program_record():
    """The program's record, or None where the program keeps none."""
    from image_segmenter_tpu_torch.utils import profiling

    record = getattr(profiling, "record", None)
    return None if record is None else record()


def traced_calls(run, rec=None):
    """The traced calls' program records ([Call], oldest first), or None
    where the program recorded fewer than the run traced."""
    rec = program_record() if rec is None else rec
    n = run.get("traced_calls")
    if rec is None or not n:
        return None
    calls = [c for c in rec.calls if c.spans and c.spans[0].name == ROOT]
    return calls[-n:] if len(calls) >= n else None


def _aligned(run, rec):
    """Per traced call: (its benchmark span (start_us, end_us), its
    program spans as (name, start_us, end_us, depth) on the profiler's
    clock), or None."""
    tl = run.get("timeline")
    calls = traced_calls(run, rec)
    if tl is None or not tl.device or calls is None:
        return None
    bench = sorted((s, e) for name, s, e in tl.spans if name == BENCH_SPAN)
    if len(bench) != len(calls):
        return None
    gcs = [c.spans[0] for c in rec.calls
           if c.spans and c.spans[0].name == "host.gc" and c.spans[0].end]
    out = []
    for (b0, b1), call in zip(bench, calls):
        off = clock_offset(call, b0, b1, tl.device)
        depth, spans = [], []
        for s in call.spans:
            depth.append(0 if s.parent < 0 else depth[s.parent] + 1)
            if s.end is not None:
                spans.append((s.name, s.start / 1e3 + off,
                              s.end / 1e3 + off, depth[-1]))
        for g in gcs:
            s, e = g.start / 1e3 + off, g.end / 1e3 + off
            if b0 <= s and e <= b1:
                spans.append((g.name, s, e, 0))
        out.append(((b0, b1), spans))
    return out


def clock_offset(call, b0, b1, device):
    """The timeline's clock less the record's, in us, for one call whose
    benchmark span is (b0, b1): the larger of two bounds from below, its
    root's start at b0 and, where each of its flag reads has its
    device-to-host copy, the copies' ends at the reads' ends."""
    at_root = b0 - call.spans[0].start / 1e3
    flags = [s for s in call.spans if s.name == "loop.flag" and s.end]
    copies = sorted(e for name, s, e in device
                    if "DtoH" in name and b0 <= s and e <= b1)
    if not flags or len(flags) != len(copies):
        return at_root
    return max(at_root, max(e - f.end / 1e3 for f, e in zip(flags, copies)))


def _innermost(spans, t):
    best = None
    for name, s, e, d in spans:
        if s <= t <= e and (best is None or (s, d) >= best[1:]):
            best = (name, s, d)
    return best[0] if best else "outside"


def idle_by_span(run, rec=None):
    """Per traced call, {innermost program span name (or "outside"): device
    idle in us} inside its `bench.pipeline.run` span, or None."""
    rec = program_record() if rec is None else rec
    aligned = _aligned(run, rec)
    if aligned is None:
        return None
    gaps = idle_gaps(run["timeline"].device)
    out = []
    for (b0, b1), spans in aligned:
        got = {}
        for g0, g1, _ in gaps:
            a, b = max(g0, b0), min(g1, b1)
            if a >= b:
                continue
            cuts = sorted({a, b} | {t for _, s, e, _ in spans
                                    for t in (s, e) if a < t < b})
            for u, v in zip(cuts, cuts[1:]):
                name = _innermost(spans, (u + v) / 2)
                got[name] = got.get(name, 0.0) + (v - u)
        out.append(got)
    return out


def idle_ms(run, names):
    """Device idle a call, in ms, under the program spans `names`."""
    per_call = idle_by_span(run)
    if per_call is None:
        return None
    return sum(sum(c.get(n, 0.0) for n in names)
               for c in per_call) / len(per_call) / 1e3


def read(run):
    return idle_ms(run, LOOP)
