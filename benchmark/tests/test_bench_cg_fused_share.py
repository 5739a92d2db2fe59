"""The reader of `cg_fused_share` on synthetic records of the program, on
the CPU: the share of the traced calls' CG chunks whose `loop.step` spans
name the fused update."""

from types import SimpleNamespace

import pytest

from benchmark.metrics import cg_fused_share
from image_segmenter_tpu_torch.utils import profiling as P

ROOT = P.Span("pipeline.run", 0, -1, 0, 100, ())


def _call(cid, steps, path):
    """A traced call of `steps` CG chunks replayed from a graph, their
    `loop.step` spans naming the update path `path`, and a Lloyd chunk."""
    spans = [ROOT] + [P.Span("loop.step", cid, 0, i, i + 1,
                             ("CGLoop", 1, path)) for i in range(steps)]
    spans.append(P.Span("loop.step", cid, 0, 50, 51, ("LloydLoop", 3)))
    return P.Call(cid, spans, steps + 2, steps + 1,
                  {"CGLoop": steps, "LloydLoop": 1},
                  steps if path == "fused" else 0)


def _record(monkeypatch, calls):
    monkeypatch.setattr(P, "record", lambda: P.Record(calls, []))


@pytest.mark.parametrize("path,want", [("fused", 100.0), ("plain", 0.0)])
def test_the_share_of_fused_chunks(monkeypatch, path, want):
    """Over the last `traced_calls` calls of the record."""
    _record(monkeypatch, [_call(1, 4, "plain" if path == "fused" else
                                "fused"), _call(2, 7, path), _call(3, 2, path)])
    assert cg_fused_share.read({"traced_calls": 2}) == want


def test_a_mixed_record_reads_the_fused_share(monkeypatch):
    _record(monkeypatch, [_call(1, 3, "plain"), _call(2, 1, "fused")])
    assert cg_fused_share.read({"traced_calls": 2}) == pytest.approx(25.0)


def test_no_traced_call_or_no_cg_chunk_reads_none(monkeypatch):
    _record(monkeypatch, [_call(1, 4, "fused")])
    assert cg_fused_share.read({"traced_calls": None}) is None
    assert cg_fused_share.read({}) is None
    assert cg_fused_share.read({"traced_calls": 2}) is None  # too few
    _record(monkeypatch, [_call(1, 0, "fused")])
    assert cg_fused_share.read({"traced_calls": 1}) is None


def test_a_program_without_the_counter_reads_none(monkeypatch):
    """A program whose calls count no `fused_chunks` (one without the
    fused update) or keep no record gives no reading: the result line
    leaves the metric out."""
    legacy = SimpleNamespace(id=1, spans=[ROOT], flag_reads=3,
                             graph_replays=3, chunks={"CGLoop": 2})
    _record(monkeypatch, [legacy])
    assert cg_fused_share.read({"traced_calls": 1}) is None
    monkeypatch.delattr(P, "record")
    assert cg_fused_share.read({"traced_calls": 1}) is None
