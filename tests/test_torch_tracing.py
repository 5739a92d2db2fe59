"""The port's spans and counters (utils/profiling.py), on the CPU.

Tracing is on exactly while a torch.profiler records. Then each span is a
`record_function` range and joins the in-memory record: one tree of
spans a call under its root, with the call's counters. Outside a
profiler only the setup spans are kept. The compiled run's graph replays
are checked here with a stand-in for the CUDA graph, and on the card in
tests/test_torch_cuda.py.
"""

import gc

import pytest
import torch

from image_segmenter_tpu_torch.pipeline import compiled as TCOMP
from image_segmenter_tpu_torch.pipeline import segment as TS
from image_segmenter_tpu_torch.solvers.kmeans import LLOYD_CHUNK
from image_segmenter_tpu_torch.solvers.matting import CG_CHUNK
from image_segmenter_tpu_torch.utils import profiling as P
from image_segmenter_tpu_torch.utils.loops import Loop, drive
from test_torch_cuda import _photo_like

# pytest runs several worker processes on the same cores: keep torch's
# CPU thread pool small so they do not oversubscribe them
torch.set_num_threads(2)

CHUNKS = {"CGLoop": CG_CHUNK, "LloydLoop": LLOYD_CHUNK}
NAMES = ("pipeline.run", "loop.flag", "loop.step", "host.gc")


@pytest.fixture(autouse=True)
def collector_runs_only_when_called():
    """The collector's own runs would add `host.gc` spans wherever an
    allocation starts one; the tests call it where they want one."""
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


@pytest.fixture(scope="module")
def untraced():
    """A CPU pipeline made and run once outside a profiler: (pipeline,
    batch, outputs, the record after the construction, the record after
    the run)."""
    P.clear()
    pipe = TS.Pipeline(model="u2netp", k=8, cg_iters=30, device="cpu")
    after_init = P.record()
    x = _photo_like(2, 64, 80, 1)  # the Lloyd loop runs two chunks
    out = pipe.run(x)
    return pipe, x, out, after_init, P.record()


def _traced(fn):
    """fn() under torch.profiler from an empty record: (its result, the
    profiler, the record)."""
    P.clear()
    with torch.profiler.profile() as prof:
        got = fn()
    return got, prof, P.record()


def _pipeline_calls(rec):
    return [c for c in rec.calls if c.spans[0].name == "pipeline.run"]


def test_tracing_is_off_outside_a_profiler(untraced):
    _, _, _, after_init, after_run = untraced
    assert not torch.autograd.profiler._is_profiler_enabled
    assert after_run.calls == []
    (init,) = [s for s in after_run.setup if s.name == "pipeline.init"]
    assert init == after_init.setup[-1]
    assert init.attrs == ("u2netp",) and init.call == 0
    assert init.end > init.start
    assert P.span("pipeline.run") is P.span("loop.flag", "CGLoop")


def test_traced_outputs_are_the_untraced_outputs(untraced):
    pipe, x, out, _, _ = untraced
    got, _, rec = _traced(lambda: pipe.run(x))
    assert all(torch.equal(a, b) for a, b in zip(got, out))
    assert len(_pipeline_calls(rec)) == 1


def test_each_call_is_one_tree_under_its_root(untraced):
    pipe, x, _, _, _ = untraced
    _, _, rec = _traced(lambda: [pipe.run(x), pipe.run(x[:1])])
    calls = _pipeline_calls(rec)
    assert len(calls) == 2 and calls[0].id < calls[1].id
    for c in calls:
        roots = [s for s in c.spans if s.parent < 0]
        assert roots == [c.spans[0]] and roots[0].name == "pipeline.run"
        for i, s in enumerate(c.spans):
            assert s.call == c.id and s.end is not None
            if s.parent >= 0:
                up = c.spans[s.parent]
                assert s.parent < i
                assert up.start <= s.start <= s.end <= up.end


def test_loop_turns_follow_the_iterations(untraced):
    """Per loop, ceil(max it / chunk) + 1 flag reads and ceil(max it /
    chunk) steps, against the iterations of the same program driven
    outside a profiler."""
    pipe, x, _, _, _ = untraced
    _, _, rec = _traced(lambda: pipe.run(x))
    (call,) = _pipeline_calls(rec)
    loops = []
    drive(TS.batch_program(pipe.stages, pipe.session.module,
                           torch.as_tensor(x)), loops)
    want = {type(lp).__name__: -(-int(lp.it.max()) // CHUNKS[
        type(lp).__name__]) for lp in loops}
    assert sorted(want) == ["CGLoop", "LloydLoop"]
    assert max(want.values()) >= 2
    flags = {}
    for s in call.spans:
        if s.name == "loop.flag":
            flags[s.attrs[0]] = flags.get(s.attrs[0], 0) + 1
    assert call.chunks == want
    assert flags == {name: n + 1 for name, n in want.items()}
    assert call.flag_reads == sum(want.values()) + len(want)
    assert call.graph_replays == 0  # the CPU runs eagerly


def test_spans_are_the_profilers_events(untraced):
    pipe, x, _, _, _ = untraced

    def two_calls():
        pipe.run(x)
        gc.collect()
        pipe.run(x)

    _, prof, rec = _traced(two_calls)
    kept = {}
    for c in rec.calls:
        for s in c.spans:
            kept[s.name] = kept.get(s.name, 0) + 1
    seen = {}
    for e in prof.events():
        if e.name in NAMES:
            seen[e.name] = seen.get(e.name, 0) + 1
    assert kept == seen
    assert seen["pipeline.run"] == 2 and seen["host.gc"] >= 1


def test_a_collector_run_is_a_span():
    def collect():
        with P.span("pipeline.run"):
            gc.collect()
        gc.collect()

    _, _, rec = _traced(collect)
    inside, outside = rec.calls
    assert [s.name for s in inside.spans] == ["pipeline.run", "host.gc"]
    assert inside.spans[1].parent == 0 and inside.spans[1].attrs == (2,)
    assert [(s.name, s.parent) for s in outside.spans] == [("host.gc", -1)]
    P.clear()
    gc.collect()
    assert P.record().calls == []


def test_record_keeps_the_last_calls():
    def calls():
        for i in range(P.CALLS + 6):
            with P.span("pipeline.run", i):
                pass

    _, _, rec = _traced(calls)
    roots = [c.spans[0] for c in rec.calls if c.spans[0].name != "host.gc"]
    assert len(rec.calls) == P.CALLS
    assert [s.attrs for s in roots] == [(i,) for i in range(
        6 + len(rec.calls) - len(roots), P.CALLS + 6)]
    P.clear()
    assert P.record() == P.Record([], [])


def test_setup_spans_are_kept_with_tracing_on_and_off():
    P.clear()
    with P.setup_span("compiled.capture", 7):
        pass
    with torch.profiler.profile():
        with P.span("pipeline.run"):
            with P.setup_span("compiled.capture", 8):
                pass
    rec = P.record()
    off, on = rec.setup
    assert (off.name, off.attrs, off.call) == ("compiled.capture", (7,), 0)
    (call,) = rec.calls
    assert on.attrs == (8,) and on.call == call.id
    assert [(s.name, s.parent) for s in call.spans] == [
        ("pipeline.run", -1), ("compiled.capture", 0)]


class _FakeGraph:
    """Stands in for a CUDA graph: each replay runs a chunk of a loop
    that stops after `chunks` replays."""

    def __init__(self, loop=None, chunks=0):
        self.loop, self.left, self.replays = loop, chunks, 0

    def replay(self):
        self.replays += 1
        if self.loop is not None:
            self.left -= 1
            self.loop.flag.fill_(self.left > 0)


class _FakeLoop:
    def __init__(self):
        self.flag = torch.tensor(True)
        self.it = torch.zeros(2, dtype=torch.int32)


def test_graph_replays_are_spans():
    """A compiled program's replays: `compiled.segment` for straight code,
    `loop.flag` and `loop.step` for a loop's chunks, with their counters;
    no span without a profiler."""
    loop = _FakeLoop()
    seg = TCOMP._Graph(_FakeGraph(), 0, [0, 0, 0, 0])
    step = TCOMP._Graph(_FakeGraph(loop, 3), 1, [0, 0, 0, 0], loop)

    def call():
        with P.span("pipeline.run"):
            seg.replay()
            step.replay()

    _, _, rec = _traced(call)
    (c,) = rec.calls
    assert [(s.name, s.attrs) for s in c.spans] == [
        ("pipeline.run", ()), ("compiled.segment", (0,))] \
        + [("loop.flag", ("_FakeLoop",)),
           ("loop.step", ("_FakeLoop", 1))] * 3 \
        + [("loop.flag", ("_FakeLoop",))]
    assert (c.flag_reads, c.graph_replays, c.chunks) == (4, 4,
                                                         {"_FakeLoop": 3})
    assert step.graph.replays == 3 and seg.graph.replays == 1
    P.clear()
    loop.flag.fill_(True)
    step.graph.left = 2
    step.replay()
    assert step.graph.replays == 5 and P.record().calls == []


@pytest.mark.parametrize("update", ["fused", "plain"])
def test_loop_steps_carry_the_update_path(update):
    """A loop with an `update` path (solvers/matting.CGLoop) adds it to
    its `loop.step` spans: (class, graph index, path) replayed from a
    graph, (class, None, path) stepped eagerly. `fused_chunks` counts the
    fused ones; `graph_replays` and `chunks` count as without the path."""
    loop = _FakeLoop()
    loop.update = update
    seg = TCOMP._Graph(_FakeGraph(), 0, [0] * len(TCOMP.COUNTERS))
    step = TCOMP._Graph(_FakeGraph(loop, 3), 1, [0] * len(TCOMP.COUNTERS),
                        loop)

    def call():
        with P.span("pipeline.run"):
            seg.replay()
            step.replay()

    _, _, rec = _traced(call)
    (c,) = rec.calls
    steps = [s.attrs for s in c.spans if s.name == "loop.step"]
    assert steps == [("_FakeLoop", 1, update)] * 3
    assert (c.flag_reads, c.graph_replays, c.chunks) == (4, 4,
                                                         {"_FakeLoop": 3})
    assert c.fused_chunks == (3 if update == "fused" else 0)


class _EagerLoop(Loop):
    """A loop stepped eagerly by `Loop.run`, `chunks` steps long."""

    def __init__(self, chunks, update=None):
        self.flag, self.left = torch.tensor(True), chunks
        if update is not None:
            self.update = update

    def step(self):
        self.left -= 1
        self.flag.fill_(self.left > 0)


@pytest.mark.parametrize("update", ["fused", "plain", None])
def test_an_eager_loop_run_carries_its_update_path(update):
    """`Loop.run`: every chunk a `loop.step` span, (class, None, path)
    where the loop has an update path, (class,) where it has none; none
    of them a graph replay; `fused_chunks` counts the fused ones."""
    loop = _EagerLoop(3, update)

    def call():
        with P.span("pipeline.run"):
            loop.run()

    _, _, rec = _traced(call)
    (c,) = rec.calls
    steps = [s.attrs for s in c.spans if s.name == "loop.step"]
    want = ("_EagerLoop",) if update is None else ("_EagerLoop", None, update)
    assert steps == [want] * 3
    assert (c.flag_reads, c.graph_replays, c.chunks) == (4, 0,
                                                         {"_EagerLoop": 3})
    assert c.fused_chunks == (3 if update == "fused" else 0)


def test_an_eager_cg_run_counts_its_fused_chunks():
    """`Loop.run` of a CGLoop on the CPU: every chunk a `loop.step` span
    (CGLoop, None, "plain"), none of them a graph replay or fused."""
    from test_torch_cg_update import _inputs

    from image_segmenter_tpu_torch.solvers.matting import CGLoop

    img, tri, x0 = _inputs(2)
    loop = CGLoop(img, tri, rtol=1e-4, max_iter=50, x0=x0, half_stats=True)

    def call():
        with P.span("pipeline.run"):
            loop.run()

    _, _, rec = _traced(call)
    (c,) = rec.calls
    chunks = -(-int(loop.it.max()) // CG_CHUNK)
    steps = [s.attrs for s in c.spans if s.name == "loop.step"]
    assert steps == [("CGLoop", None, "plain")] * chunks and chunks >= 2
    assert c.chunks == {"CGLoop": chunks} and c.graph_replays == 0
    assert c.fused_chunks == 0
