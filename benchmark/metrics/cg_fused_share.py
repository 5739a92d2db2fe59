"""The share, in %, of a traced call's matting CG chunks that ran on the
fused update (kernels/cg_update.py): `loop.step` spans of `CGLoop` whose
update path, their third attr, is "fused", counted by the program in each
call's record as `fused_chunks`
(`image_segmenter_tpu_torch.utils.profiling.record()`), over the CG's
chunks. None where the program counts no `fused_chunks` or the traced
calls ran no CG chunk."""

from benchmark.metrics.loop_turn_idle_ms import traced_calls


def read(run):
    calls = traced_calls(run)
    if not calls or not hasattr(calls[0], "fused_chunks"):
        return None
    chunks = sum(c.chunks.get("CGLoop", 0) for c in calls)
    if not chunks:
        return None
    return 100.0 * sum(c.fused_chunks for c in calls) / chunks
