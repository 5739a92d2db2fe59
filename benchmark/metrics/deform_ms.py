"""Device time a call, in ms, of BiRefNet's deformable convolutions: the
hand-written kernel (`deform_conv_kernel`, kernels/csrc/deform_conv.cu) by
name from the traced window's device timeline. Their offset and
modulator convolutions, the sigmoid and the casts around them are not
counted. None where a traced call ran no such kernel (a program without
it)."""

import re

DEFORM = re.compile(r"deform_conv_kernel")


def launches(run) -> list:
    """[(start_us, end_us)] of the kernel's launches in the traced window."""
    tl = run.get("timeline")
    if tl is None:
        return []
    return [(s, e) for name, s, e in tl.device if DEFORM.search(name)]


def read(run):
    got = launches(run)
    if not got:
        return None
    return sum(e - s for s, e in got) / 1e3 / run["traced_calls"]
