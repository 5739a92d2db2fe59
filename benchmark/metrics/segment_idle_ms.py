"""Device idle a call, in ms, while the host is inside the compiled run's
straight code: the copy in (`compiled.ingest`), the launch of a graph of
straight code (`compiled.segment`) or the clones of the outputs
(`compiled.outputs`). Read as `loop_turn_idle_ms` says."""

from benchmark.metrics.loop_turn_idle_ms import idle_ms

SEGMENT = ("compiled.ingest", "compiled.segment", "compiled.outputs")


def read(run):
    return idle_ms(run, SEGMENT)
