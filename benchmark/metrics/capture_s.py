"""The first call of the shape the traced calls replayed: its warm-up,
its captures as CUDA graphs and their first replays (the program's setup
span `compiled.capture` of the program named by the traced calls'
`compiled.ingest`), in s."""

from benchmark.metrics.loop_turn_idle_ms import program_record, \
    traced_calls


def read(run):
    rec = program_record()
    calls = traced_calls(run, rec)
    if not calls:
        return None
    ingest = [s.attrs for s in calls[-1].spans if s.name == "compiled.ingest"]
    if not ingest:
        return None
    got = [s for s in rec.setup
           if s.name == "compiled.capture" and s.attrs == ingest[0]]
    return (got[-1].end - got[-1].start) / 1e9 if got else None
