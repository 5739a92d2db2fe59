"""The generator of photo-mosaic traffic with one box a frame: it reads a
mix's parameters from `benchmark/traffic/<name>.json` (one that names
`"generator": "photo_mosaic_box"`) and makes the requests its calls hand
to the entry.

A request is (frames, boxes): the (frames, height, width, 3) u8 batch
that `photo_mosaic` makes at the same offset, and (frames, 4) float32
boxes x0, y0, x1, y1 in the frame's pixels, one a frame. A frame's box
is a whole `tile` x `tile` tile of its mosaic (a cell of the tiling that
the frame's edge does not cut), chosen by the seed, with each of its
four edges moved by a whole number in [-box_jitter, box_jitter], also
chosen by the seed, and clipped to the frame: the rectangle a user
drags around a subject, or a detector's box. The same seed gives the
same requests.
"""

from __future__ import annotations

import numpy as np

from benchmark.generators import photo_mosaic

KEYS = photo_mosaic.KEYS | {"box_jitter"}


def check(traffic: dict) -> None:
    if set(traffic) - {"why"} != KEYS:
        raise ValueError(f"a photo_mosaic_box mix has the keys "
                         f"{sorted(KEYS)}; got {sorted(traffic)}")
    photo_mosaic.check(_mosaic_mix(traffic))


def _mosaic_mix(traffic: dict) -> dict:
    return {k: v for k, v in traffic.items() if k != "box_jitter"}


def boxes(traffic: dict, seed: int, n: int) -> np.ndarray:
    """(n, frames, 4) float32: the boxes of n requests, from the seed."""
    t, h, w = traffic["tile"], traffic["height"], traffic["width"]
    rows, cols = h // t, w // t
    if rows < 1 or cols < 1:
        raise ValueError("the frame holds no whole tile")
    rng = np.random.default_rng(int(seed))
    b, j = traffic["frames"], traffic["box_jitter"]
    cell = rng.integers(0, rows * cols, size=(n, b))
    move = rng.integers(-j, j + 1, size=(n, b, 4))
    r, c = cell // cols, cell % cols
    out = np.stack([c * t, r * t, (c + 1) * t, (r + 1) * t], -1) + move
    out[..., 0::2] = np.clip(out[..., 0::2], 0, w - 1)
    out[..., 1::2] = np.clip(out[..., 1::2], 0, h - 1)
    return out.astype(np.float32)


def make(traffic: dict, seed: int, devices: list) -> list:
    """The distinct requests in the order a run's calls take them, over
    and over: photo_mosaic's batches from the seed's first offset, each
    with its boxes."""
    check(traffic)
    frames = photo_mosaic.make(_mosaic_mix(traffic), seed, devices)
    return list(zip(frames, boxes(traffic, seed, len(frames))))
