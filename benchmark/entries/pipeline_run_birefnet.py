"""The entry the window drives for BiRefNet: `Pipeline.run` of
image_segmenter_tpu_torch with `birefnet-general`.

What a run needs of an entry module is `pipeline_run`'s (see its
docstring); this one reuses its `Entry` and changes:
- `weights(config, devices)`: BiRefNet's state on the card from the
  configuration's weight seed (`yardstick/birefnet_weights.py`);
- `counters()`: `pipeline_run`'s launches, and the frames the network ran
  (`models/birefnet.FRAMES`) and the deformable convolutions it launched
  (`kernels/deform_conv.LAUNCHES`).
A request, a call's outputs and the client's buffers are
`pipeline_run`'s.
"""

from __future__ import annotations

from benchmark.entries import pipeline_run


def weights(config: dict, devices: list) -> dict:
    from benchmark.yardstick.birefnet_weights import make_state

    return make_state(config, config["weight_seed"], devices[0])


class Entry(pipeline_run.Entry):
    def counters(self) -> dict:
        from image_segmenter_tpu_torch.kernels import deform_conv
        from image_segmenter_tpu_torch.models import birefnet

        return super().counters() | {"birefnet_frames": birefnet.FRAMES,
                                     "deform_conv": deform_conv.LAUNCHES}
