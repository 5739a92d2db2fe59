"""Device time a call, in ms, of Segment Anything's encoder attention:
its attention kernels (`scaled_dot_product_attention`'s cuDNN, flash or
memory-efficient kernels, or a fused kernel whose name says attention),
each with the bfloat16 broadcast add that forms the decomposed
relative-position bias it is given (the last operation before it other
than memsets, where that is an add of bfloat16). The two einsums that
make the bias's terms are GEMMs of a few microseconds, left to the
encoder's share. None where a traced call ran no attention kernel."""

import re

from benchmark.metrics.sam_encoder_mfu import BF16, calls, encoder_ops

ATTENTION = re.compile(r"sdpa|fmha|flash|attention|attn", re.IGNORECASE)
ADD = re.compile(r"add", re.IGNORECASE)


def attention_us(ops) -> float:
    """The attention kernels' and their bias adds' device time in one
    call's encoder operations."""
    total = 0.0
    for i, (name, s, e) in enumerate(ops):
        if not ATTENTION.search(name):
            continue
        total += e - s
        j = i - 1
        while j >= 0 and ops[j][0].startswith("Memset"):
            j -= 1
        if j >= 0 and ADD.search(ops[j][0]) and BF16.search(ops[j][0]):
            total += ops[j][2] - ops[j][1]
    return total


def read(run):
    per_call = calls(run)
    if not per_call:
        return None
    got = []
    for ops in per_call:
        enc = encoder_ops(ops)
        us = attention_us(enc) if enc else 0.0
        if us <= 0:
            return None
        got.append(us)
    return sum(got) / len(got) / 1e3
