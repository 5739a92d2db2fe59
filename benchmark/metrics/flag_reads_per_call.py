"""The host's reads of a loop's stop flag a traced call (`loop.flag`
spans, counted in each call's record by the program:
`image_segmenter_tpu_torch.utils.profiling.record()`): a loop's chunks
plus one, summed over the matting CG and the Lloyd loop."""

from benchmark.metrics.loop_turn_idle_ms import traced_calls


def read(run):
    calls = traced_calls(run)
    if not calls:
        return None
    return sum(c.flag_reads for c in calls) / len(calls)
