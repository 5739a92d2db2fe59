"""Write the photo corpus: the centre square of each photo as a PNG, and
MANIFEST.json.

    python image_segmenter_tpu_torch/bench/corpus/make_corpus.py

A one-off script, run where Pillow, scikit-learn and labmaze are installed
(their photos are the sources). It takes the photos the JAX package's
tests/helpers/corpus.py takes, in its order: sklearn's china.jpg and
flower.jpg, then labmaze's `sky_*/up.png`, `sky_*/ft.png` and the first six
`style_0*/floor_*_d.png`, each converted to RGB by Pillow and cut to its
centre square at its own size. The reference app's working image is not
among them: it is not distributed.

The PNGs are 8-bit RGB with each row filtered by None, Sub or Up (the
filter with the least sum of absolute bytes), which the port's PNG
decoder (`cli._png_decode`) undoes without a loop over bytes; zlib level 9.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import struct
import sys
import zlib
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SKLEARN_LICENCE = ("CC BY 2.0, https://creativecommons.org/licenses/by/2.0/; "
                   "attribution in README.md (sklearn/datasets/images/"
                   "README.txt)")
LABMAZE_LICENCE = "Apache-2.0 (labmaze-1.0.6.dist-info/LICENSE)"


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(rgb: np.ndarray) -> bytes:
    """8-bit RGB PNG bytes, each row filtered by None, Sub or Up."""
    h, w, _ = rgb.shape
    rows = rgb.reshape(h, w * 3).astype(np.int16)
    prior = np.zeros_like(rows[0])
    out = bytearray()
    for y in range(h):
        line = rows[y]
        sub = line.copy()
        sub[3:] -= line[:-3]
        cands = [line, sub, line - prior]
        cost = [int(np.abs((c & 0xFF).astype(np.int8)).sum()) for c in cands]
        kind = int(np.argmin(cost))
        out.append(kind)
        out += (cands[kind] & 0xFF).astype(np.uint8).tobytes()
        prior = line
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(bytes(out), 9))
            + _chunk(b"IEND", b""))


def sources() -> list:
    """[(name, source path relative to site-packages, licence, RGB)] in
    tests/helpers/corpus.py's order."""
    import labmaze
    import sklearn
    from PIL import Image
    from sklearn.datasets import load_sample_image

    site = Path(sklearn.__file__).resolve().parents[1]
    out = [(n, f"sklearn/datasets/images/{n}.jpg", SKLEARN_LICENCE,
            load_sample_image(f"{n}.jpg")) for n in ("china", "flower")]
    assets = os.path.join(os.path.dirname(labmaze.__file__), "assets")
    floors = 0
    for pat in ("sky_*/up.png", "sky_*/ft.png", "style_0*/floor_*_d.png"):
        for p in sorted(glob.glob(os.path.join(assets, pat))):
            name = "-".join(p.split(os.sep)[-2:]).rsplit(".", 1)[0]
            with Image.open(p) as im:
                rgb = np.asarray(im.convert("RGB"))
            rel = Path(p).resolve().relative_to(site).as_posix()
            out.append((name, rel, LABMAZE_LICENCE, rgb))
            if pat.startswith("style"):
                floors += 1
                if floors >= 6:
                    break
    return out


def main() -> int:
    sys.path.insert(0, str(HERE.parents[2]))
    from image_segmenter_tpu_torch.bench.corpus import center_square, \
        rgb_sha256
    from image_segmenter_tpu_torch.cli import _png_decode

    photos = []
    for order, (name, src, licence, rgb) in enumerate(sources()):
        sq = np.ascontiguousarray(center_square(np.asarray(rgb)))
        data = encode_png(sq)
        if not np.array_equal(_png_decode(data)[..., :3], sq):
            raise RuntimeError(f"{name}: the PNG does not decode to itself")
        (HERE / f"{name}.png").write_bytes(data)
        photos.append({"name": name, "order": order, "file": f"{name}.png",
                       "source": src, "licence": licence,
                       "source_shape": list(rgb.shape),
                       "shape": list(sq.shape), "sha256": rgb_sha256(sq)})
        print(f"{name}: {sq.shape} from {src}, {len(data)} bytes")
    with open(HERE / "MANIFEST.json", "w") as f:
        json.dump({"note": "centre squares of the photos of "
                           "tests/helpers/corpus.py, in its order; sha256 of "
                           "the decoded (H, W, 3) RGB bytes",
                   "photos": photos}, f, indent=1)
    total = sum(p.stat().st_size for p in HERE.iterdir() if p.is_file())
    print(f"corpus folder: {total} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
