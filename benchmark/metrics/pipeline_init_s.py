"""The construction of the entry's `Pipeline`: its session with seeded
weights and its stage functions (the program's setup span
`pipeline.init`), in s."""

from benchmark.metrics.loop_turn_idle_ms import program_record


def read(run):
    rec = program_record()
    got = [] if rec is None else [s for s in rec.setup
                                  if s.name == "pipeline.init"]
    return (got[-1].end - got[-1].start) / 1e9 if got else None
