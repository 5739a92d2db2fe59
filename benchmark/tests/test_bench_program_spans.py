"""The readers of the program's own record (`flag_reads_per_call`,
`loop_turn_idle_ms`, `segment_idle_ms`, `capture_s`, `pipeline_init_s`)
on a synthetic timeline and record with known idle gaps, on the CPU.

Times are in us on the profiler's clock. The program's clock is another
(ns, shifted by BASE_US), and each program root opens 5 us after its
`bench.pipeline.run` span, so a span read on the timeline's clock lies 5
us before where it was: the expected values below are those of the
spans so shifted."""

import pytest

from benchmark.metrics import capture_s, flag_reads_per_call, \
    loop_turn_idle_ms, pipeline_init_s, segment_idle_ms
from benchmark.yardstick.timeline import Timeline, idle_gaps
from image_segmenter_tpu_torch.utils import profiling as P

BASE_US = 500_000
READERS = (flag_reads_per_call, loop_turn_idle_ms, segment_idle_ms,
           capture_s, pipeline_init_s)


def _ns(t_us):
    return (t_us + BASE_US) * 1000


def _call(cid, spans):
    """spans: [(name, parent, start_us, end_us, attrs)] -> a Call."""
    got = [P.Span(n, cid, p, _ns(s), _ns(e), a) for n, p, s, e, a in spans]
    flags = sum(s.name == "loop.flag" for s in got)
    steps = sum(s.name == "loop.step" for s in got)
    return P.Call(cid, got, flags, steps, {"CGLoop": steps} if steps else {})


def _setup(name, seconds, attrs):
    return P.Span(name, 0, -1, _ns(0), _ns(seconds * 1e6), attrs)


# an older call, then the two traced calls and a collector run between the
# second call's root and the end of its benchmark span
RECORD = P.Record(
    calls=[
        _call(1, [("pipeline.run", -1, 100, 900, ()),
                  ("loop.flag", 0, 200, 300, ("CGLoop",))]),
        _call(2, [("pipeline.run", -1, 1005, 1990, ()),
                  ("compiled.ingest", 0, 1010, 1100, (2,)),
                  ("compiled.segment", 0, 1100, 1150, (0,)),
                  ("loop.flag", 0, 1400, 1500, ("CGLoop",)),
                  ("loop.step", 0, 1500, 1520, ("CGLoop", 1)),
                  ("loop.flag", 0, 1700, 1800, ("CGLoop",)),
                  ("host.gc", 5, 1720, 1760, (0,)),
                  ("compiled.outputs", 0, 1900, 1950, ())]),
        _call(3, [("pipeline.run", -1, 3005, 3400, ()),
                  ("compiled.ingest", 0, 3005, 3050, (2,)),
                  ("loop.flag", 0, 3100, 3300, ("CGLoop",)),
                  ("compiled.outputs", 0, 3350, 3390, ())]),
        _call(4, [("host.gc", -1, 3450, 3480, (2,))]),
    ],
    setup=[_setup("pipeline.init", 0.75, ("u2netp",)),
           _setup("compiled.capture", 1.5, (1,)),
           _setup("compiled.capture", 2.25, (2,))])

DEVICE = [("k", s, e) for s, e in ((990, 1000), (1050, 1120), (1160, 1400),
                                   (1430, 1600), (1800, 1880), (1960, 2010),
                                   (3020, 3040), (3200, 3210), (3490, 3600))]
BENCH_SPANS = [("bench.pipeline.run", 1000, 2000),
               ("bench.outputs.to_host", 2000, 2010),
               ("bench.pipeline.run", 3000, 3500)]
RUN = {"timeline": Timeline(DEVICE, BENCH_SPANS), "traced_calls": 2}

# us of device idle a traced call, by the innermost span (as shifted)
WANT = [
    {"compiled.ingest": 45, "compiled.segment": 25, "loop.flag": 30 + 20 + 40,
     "host.gc": 40, "compiled.outputs": 50,
     "pipeline.run": 5 + 15 + 95 + 5 + 15 + 15},
    {"compiled.ingest": 20 + 5, "loop.flag": 105 + 85, "compiled.outputs": 40,
     "pipeline.run": 50 + 50 + 10, "outside": 50 + 15, "host.gc": 30},
]


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(P, "record", lambda: RECORD)


def test_idle_goes_to_the_innermost_span(recorded):
    got = loop_turn_idle_ms.idle_by_span(RUN)
    assert got == [pytest.approx(w, abs=1e-9) for w in WANT]


def test_the_readers_values(recorded):
    assert flag_reads_per_call.read(RUN) == 1.5
    assert loop_turn_idle_ms.read(RUN) == pytest.approx((90 + 190) / 2e3,
                                                        abs=1e-12)
    assert segment_idle_ms.read(RUN) == pytest.approx((120 + 65) / 2e3,
                                                      abs=1e-12)
    assert capture_s.read(RUN) == pytest.approx(2.25, abs=1e-9)
    assert pipeline_init_s.read(RUN) == pytest.approx(0.75, abs=1e-9)


def test_the_parts_add_up_to_the_idle_inside_the_benchmark_span(recorded):
    """loop turns + segments + collector + the rest (the root alone, or no
    program span) = the device idle inside each `bench.pipeline.run`."""
    loop = loop_turn_idle_ms.LOOP
    seg = segment_idle_ms.SEGMENT
    bench = [(s, e) for n, s, e in BENCH_SPANS if n == "bench.pipeline.run"]
    for got, (b0, b1) in zip(loop_turn_idle_ms.idle_by_span(RUN), bench):
        idle = sum(max(0.0, min(e, b1) - max(s, b0))
                   for s, e, _ in idle_gaps(DEVICE))
        parts = (sum(got.get(n, 0.0) for n in loop),
                 sum(got.get(n, 0.0) for n in seg), got.get("host.gc", 0.0),
                 sum(v for n, v in got.items()
                     if n not in loop + seg + ("host.gc",)))
        assert sum(parts) == pytest.approx(idle, abs=1e-9)
        assert all(p > 0 for p in parts)
    assert [sum(c.values()) for c in WANT] == [400, 460]


def test_nothing_recorded_reads_none(monkeypatch):
    monkeypatch.delattr(P, "record")  # a program without the record
    for reader in READERS:
        assert reader.read(RUN) is None
    monkeypatch.setattr(P, "record", lambda: P.Record([], []),
                        raising=False)
    for reader in READERS:
        assert reader.read(RUN) is None


def test_an_untraced_run_or_a_short_record_reads_none(monkeypatch):
    monkeypatch.setattr(P, "record", lambda: RECORD)
    untraced = {"traced_calls": None}
    for reader in (flag_reads_per_call, loop_turn_idle_ms, segment_idle_ms,
                   capture_s):
        assert reader.read(untraced) is None
    short = dict(RUN, traced_calls=4)  # more traced than recorded
    for reader in (flag_reads_per_call, loop_turn_idle_ms, segment_idle_ms,
                   capture_s):
        assert reader.read(short) is None
    no_device = dict(RUN, timeline=Timeline([], BENCH_SPANS))
    for reader in (loop_turn_idle_ms, segment_idle_ms):
        assert reader.read(no_device) is None
    assert pipeline_init_s.read(untraced) == pytest.approx(0.75, abs=1e-9)


def test_flag_reads_bound_the_clocks_offset():
    """A root that opens 20 us after its benchmark span, and two flag
    reads that wait on device-to-host copies, the second read returning
    as its copy ends: the copies give the offset exactly; the root's
    start alone, 20 us off, where a copy is missing or the copies' bound
    is the looser."""
    call = _call(9, [("pipeline.run", -1, 20, 900, ()),
                     ("loop.flag", 0, 100, 200, ("CGLoop",)),
                     ("loop.flag", 0, 500, 600, ("CGLoop",))])
    dtoh = "Memcpy DtoH (Device -> Pageable)"
    copies = [(dtoh, 110, 190), (dtoh, 520, 600), ("k", 300, 400)]
    true = -BASE_US
    off = loop_turn_idle_ms.clock_offset
    assert off(call, 0, 1000, copies) == true
    assert off(call, 0, 1000, copies[1:]) == true - 20
    late = [(dtoh, 110, 150), (dtoh, 520, 560)]
    assert off(call, 0, 1000, late) == true - 20
