"""Device time a call, in ms, of BiRefNet's window attention: the
attention kernels (`scaled_dot_product_attention`'s cuDNN, flash or
memory-efficient kernels, or a fused kernel whose name says attention)
by name, each with the bfloat16 add before it where there is one
(`sam_attn_ms.attention_us`; the port makes its masks once a block, so
there is none on its path). The rolls, partitions and reverses around
them and the qkv and proj GEMMs are not counted. None where a traced
call ran no attention kernel."""

from benchmark.metrics.sam_attn_ms import attention_us
from benchmark.metrics.sam_encoder_mfu import calls


def read(run):
    per_call = calls(run)
    if not per_call:
        return None
    got = [attention_us(ops) for ops in per_call]
    if min(got) <= 0:
        return None
    return sum(got) / len(got) / 1e3
