"""The generator of photo-mosaic traffic: it reads a mix's parameters from
`benchmark/traffic/<name>.json` (one that names `"generator":
"photo_mosaic"`) and makes the requests its calls hand to the entry.

A request is a (frames, height, width, 3) u8 batch, host numpy: `frames`
a call of `height` x `width`, tiled from the corpus at `tile` x `tile` by
the mosaic rule (`corpus.mosaic`). There are as many distinct batches as
photos: the one at offset o holds the frames at offsets o, o + 1, ...,
each frame a mosaic whose first tile is photo o. `make` returns them in
the order the calls take them, from a first offset drawn from the seed,
one further a call, so every seed sends the same set of batches in
another order.

`host_memory` says where the client holds them: "page_locked" (a client
that streams frames to the card from pinned buffers, as a DataLoader with
`pin_memory=True` does) or "pageable" (plain numpy from a decoder). On a
host with no card both are pageable.
"""

from __future__ import annotations

import numpy as np

from benchmark.yardstick import corpus

KEYS = {"generator", "frames", "height", "width", "tile", "host_memory",
        "check_calls", "trace_calls"}


def check(traffic: dict) -> None:
    if set(traffic) - {"why"} != KEYS:
        raise ValueError(f"a photo_mosaic mix has the keys {sorted(KEYS)}; "
                         f"got {sorted(traffic)}")
    if traffic["host_memory"] not in ("page_locked", "pageable"):
        raise ValueError("host_memory is page_locked or pageable")


def batches(traffic: dict, pin: bool = False) -> list:
    """The distinct batches, by offset, as host numpy; in page-locked
    memory with `pin`."""
    import torch

    check(traffic)
    tiles = corpus.load_tiles(traffic["tile"])
    n, b = len(tiles), traffic["frames"]
    frames = [corpus.mosaic(tiles, o, 1, traffic["height"],
                            traffic["width"])[0] for o in range(n)]
    out = []
    for o in range(n):
        buf = torch.empty((b, *frames[0].shape), dtype=torch.uint8,
                          pin_memory=pin).numpy()
        for i in range(b):
            buf[i] = frames[(o + i) % n]
        out.append(buf)
    return out


def first_offset(seed: int, n: int) -> int:
    return int(seed) % n


def make(traffic: dict, seed: int, devices: list) -> list:
    """The distinct requests in the order a run's calls take them, over
    and over."""
    pin = traffic["host_memory"] == "page_locked" and \
        devices[0].type == "cuda"
    bs = batches(traffic, pin)
    o = first_offset(seed, len(bs))
    return bs[o:] + bs[:o]
