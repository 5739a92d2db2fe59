"""Command-line driver for the reference app's full workflow.

Counterpart of image_segmenter_tpu/cli.py on the PyTorch port: the same
options, defaults and stage sequence — AI background removal
(main_window.py:388), optional portrait matting refine (:441), color
simplification (:585), region cleanup (:1050), boundary smoothing (:1146),
tendril trimming (harness behavior) — with every default matching the
panels' widget defaults (config.Defaults carries the citations).

    python -m image_segmenter_tpu_torch.cli photo.png cutout.png \
        --colors 8 --algorithm adaptive --cleanup --smooth morphological

Stages run only when requested (like the app: each is one button); the
workflow state promotions mirror MainWindow's three slots. Every stage runs
on `--device` (the card unless `--device cpu` is given). PNG files are read
and written by a small codec of this module; other formats need Pillow.
"""

from __future__ import annotations

import argparse
import struct
import sys
import zlib

import numpy as np

from image_segmenter_tpu_torch.config import DEFAULTS, REMBG_MODELS

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples a pixel


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the five PNG row filters (None, Sub, Up, Average, Paeth) of
    non-interlaced 8-bit rows; returns (h, w * bpp) uint8."""
    stride = w * bpp
    if len(raw) != h * (stride + 1):
        raise ValueError("PNG: image data has the wrong length")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum along each channel, mod 256
            cur = np.cumsum(line.reshape(w, bpp), axis=0,
                            dtype=np.uint8).reshape(stride)
        elif kind == 2:
            cur = line + prior
        elif kind in (3, 4):
            # each byte needs the one left of it, already unfiltered: a
            # loop over plain ints (numpy per pixel is slower)
            row, up = bytearray(line.tobytes()), prior.tobytes()
            for i in range(stride):
                a = row[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                row[i] = (row[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(row), np.uint8)
        else:
            raise ValueError(f"PNG: unknown row filter {kind}")
        out[y] = cur
        prior = cur
    return out


def _png_decode(data: bytes) -> np.ndarray:
    """HxWx4 uint8 RGBA of an 8-bit grey, RGB or RGBA, non-interlaced PNG."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG: bad CRC in chunk {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"tRNS":
            raise ValueError(f"PNG: chunk {kind.decode()} is not supported "
                             "(8-bit grey, RGB and RGBA only)")
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, ctype, method, filt, interlace = header
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace or method or filt:
        raise ValueError(
            f"PNG: bit depth {depth}, colour type {ctype}, interlace "
            f"{interlace} is not supported (8-bit grey, RGB and RGBA, not "
            "interlaced)")
    bpp = _PNG_CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w, bpp).reshape(h, w, bpp)
    if bpp == 4:
        return px
    rgba = np.full((h, w, 4), 255, np.uint8)
    rgba[..., :3] = px
    return rgba


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _png_encode(px: np.ndarray) -> bytes:
    """PNG bytes of an HxWx3 (RGB) or HxWx4 (RGBA) uint8 array, filter 0."""
    h, w, c = px.shape
    rows = np.empty((h, w * c + 1), np.uint8)
    rows[:, 0] = 0
    rows[:, 1:] = px.reshape(h, w * c)
    header = struct.pack(">IIBBBBB", w, h, 8, {3: 2, 4: 6}[c], 0, 0, 0)
    return (_PNG_SIGNATURE + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def _pil(path: str):
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"{path}: this format needs Pillow, which is not installed; "
            ".png is read and written without it") from None
    return Image


def _load_rgba(path: str) -> np.ndarray:
    if path.lower().endswith(".png"):
        with open(path, "rb") as f:
            return _png_decode(f.read())
    img = _pil(path).open(path).convert("RGBA")
    return np.asarray(img, np.uint8).copy()


def _save(path: str, rgba: np.ndarray) -> None:
    # Mirror the reference's save path (main_window.py:1202-1267): RGBA for
    # formats with alpha, flattened for JPEG.
    if path.lower().endswith(".png"):
        with open(path, "wb") as f:
            f.write(_png_encode(np.ascontiguousarray(rgba)))
        return
    img = _pil(path).fromarray(rgba, "RGBA")
    if path.lower().endswith((".jpg", ".jpeg")):
        img = img.convert("RGB")
    img.save(path)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="image-segmenter-tpu-torch",
        description=__doc__.split("\n\n")[0],
    )
    p.add_argument("input", help="input image (.png; other formats through "
                                 "Pillow)")
    p.add_argument("output", help="output image path (.png/.tiff/.bmp/.jpg)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where every stage runs (default cuda)")

    bg = p.add_argument_group("background removal (BG tools panel)")
    bg.add_argument("--rembg", action="store_true",
                    help="run AI background removal (panel: 'AI Remove BG')")
    bg.add_argument("--model", default=DEFAULTS.rembg_model,
                    choices=list(REMBG_MODELS),
                    help=f"rembg model id (default {DEFAULTS.rembg_model})")
    bg.add_argument("--soft-edges", action="store_true",
                    help="skip the Otsu sharpening post-pass")
    bg.add_argument("--refine-portrait", action="store_true",
                    help="closed-form matting refine of the alpha (panel: "
                         "'Refine Portrait')")
    bg.add_argument("--grabcut-rect", metavar="X,Y,W,H",
                    help="GrabCut with a rectangle seed instead of rembg")

    cp = p.add_argument_group("color processing panel")
    cp.add_argument("--colors", type=int, default=DEFAULTS.num_colors,
                    help=f"number of colors (default {DEFAULTS.num_colors})")
    cp.add_argument("--algorithm", default="adaptive",
                    choices=["adaptive", "kmeans", "median_cut", "octree",
                             "threshold", "perceptual", "perceptual_fast",
                             "adaptive_distance", "hsv_clustering"],
                    help="quantization algorithm (default adaptive)")
    cp.add_argument("--palette", metavar="RRGGBB,RRGGBB,...",
                    help="custom palette hex colors (overrides --algorithm)")
    cp.add_argument("--distance-metric", default="lab",
                    choices=["lab", "rgb", "hsv"],
                    help="custom-palette distance space (default lab)")
    cp.add_argument("--no-simplify", action="store_true",
                    help="skip color simplification entirely")

    rc = p.add_argument_group("region cleanup panel")
    rc.add_argument("--cleanup", action="store_true",
                    help="merge small regions (panel: 'Clean Up Regions')")
    rc.add_argument("--min-region-size", type=int,
                    default=DEFAULTS.min_region_size)
    rc.add_argument("--auto-merge-threshold", type=float,
                    default=DEFAULTS.auto_merge_threshold)
    rc.add_argument("--connectivity", type=int, default=DEFAULTS.connectivity,
                    choices=[4, 8])
    rc.add_argument("--smooth", metavar="METHOD",
                    choices=["morphological", "bilateral", "contour",
                             "gaussian", "multiscale", "majority"],
                    help="boundary smoothing method (panel combo; 'majority' "
                         "is the harness's iterative smoother)")
    rc.add_argument("--smooth-strength", type=float,
                    default=DEFAULTS.smoothing_strength)
    rc.add_argument("--trim-tendrils", type=int, metavar="THRESHOLD",
                    help="tendril trimming at the given thickness threshold")

    p.add_argument("--stats", action="store_true",
                   help="print color/region statistics dicts (panel readouts)")
    p.add_argument("-q", "--quiet", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    log = (lambda *a: None) if args.quiet else (
        lambda *a: print(*a, file=sys.stderr))

    from image_segmenter_tpu_torch.utils.backend import resolve_device
    from image_segmenter_tpu_torch.utils.progress import ConsoleProgress
    from image_segmenter_tpu_torch.utils.workflow import WorkflowState

    dev = args.device
    resolve_device(dev)  # raises here, before any work, without a card
    rgba = _load_rgba(args.input)
    state = WorkflowState(rgba)
    log(f"loaded {args.input}: {rgba.shape[1]}x{rgba.shape[0]}")

    # ---- background removal (main_window.py:388 / :243) --------------------
    if args.grabcut_rect:
        from image_segmenter_tpu_torch.processing.grabcut import apply_grabcut

        x, y, w, h = (int(v) for v in args.grabcut_rect.split(","))
        bgr = rgba[..., :3][..., ::-1].copy()
        mask = apply_grabcut(bgr, rect_xywh=(x, y, w, h),
                             iterations=DEFAULTS.grabcut_iterations,
                             device=dev)
        fg = (mask == 1) | (mask == 3)
        out = rgba.copy()
        out[..., 3] = np.where(fg, 255, 0).astype(np.uint8)
        state.set_ai_output(out)
        log(f"grabcut: foreground {fg.mean():.1%}")
    elif args.rembg:
        from image_segmenter_tpu_torch.processing.rembg_infer import (
            rembg_remove_bgr_to_rgba)

        bgr = rgba[..., :3][..., ::-1].copy()
        out = rembg_remove_bgr_to_rgba(
            bgr, model=args.model, sharp_edges=not args.soft_edges,
            device=dev)
        state.set_ai_output(out)
        log(f"rembg[{args.model}]: opaque {(out[..., 3] > 0).mean():.1%}")

    if args.refine_portrait:
        from image_segmenter_tpu_torch.processing.matting_refine import (
            refine_alpha_portrait)

        src = state.working_image
        alpha0 = src[..., 3]
        refined = refine_alpha_portrait(
            np.ascontiguousarray(src[..., :3]), alpha0, None, device=dev)
        out = np.dstack([src[..., :3], refined])
        state.set_ai_output(out)
        log("portrait matting refine applied")

    # ---- color simplification (main_window.py:585 / :634) ------------------
    if args.palette:
        from image_segmenter_tpu_torch.processing.color_simplify import (
            create_palette_from_colors, simplify_colors_custom_palette)

        cols = [tuple(int(c[i:i + 2], 16) for i in (0, 2, 4))
                for c in args.palette.split(",")]
        pal = create_palette_from_colors(cols)
        src = state.working_image
        out, pal = simplify_colors_custom_palette(
            src, pal, True, distance_metric=args.distance_metric, device=dev)
        state.set_simplified_preview(out)
        state.apply_color_processing()
        log(f"custom palette: {len(pal)} colors")
    elif not args.no_simplify:
        from image_segmenter_tpu_torch.processing.color_simplify import (
            simplify_colors_adaptive)

        src = state.working_image
        out, pal = simplify_colors_adaptive(
            src, args.colors, True, algorithm=args.algorithm, device=dev)
        state.set_simplified_preview(out)
        state.apply_color_processing()
        log(f"simplify[{args.algorithm}]: {len(pal)} colors")

    # ---- region cleanup (main_window.py:1050) ------------------------------
    if args.cleanup:
        from image_segmenter_tpu_torch.processing.region_cleanup import (
            merge_small_regions)

        src = state.working_image
        prog = None if args.quiet else ConsoleProgress("cleanup")
        out = merge_small_regions(
            src, args.min_region_size, None, args.auto_merge_threshold,
            None, prog, args.connectivity, device=dev)
        state.set_cleaned_preview(out)
        state.apply_cleanup()

    # ---- smoothing (main_window.py:1146 / harness) -------------------------
    if args.smooth == "majority":
        from image_segmenter_tpu_torch.compat.harness import (
            apply_boundary_smoothing_global)

        out = apply_boundary_smoothing_global(state.working_image, device=dev)
        state.set_cleaned_preview(out)
        state.apply_cleanup()
        log("majority smoothing applied")
    elif args.smooth:
        from image_segmenter_tpu_torch.processing.region_cleanup import (
            smooth_region_boundaries)

        out = smooth_region_boundaries(
            state.working_image, args.smooth, args.smooth_strength,
            device=dev)
        state.set_cleaned_preview(out)
        state.apply_cleanup()
        log(f"smoothing[{args.smooth}] applied")

    # ---- tendril trimming --------------------------------------------------
    if args.trim_tendrils is not None:
        from image_segmenter_tpu_torch.processing.tendril_trimming import (
            trim_tendrils)

        out, iters, msg = trim_tendrils(state.working_image,
                                        args.trim_tendrils, device=dev)
        state.set_cleaned_preview(out)
        state.apply_cleanup()
        log(f"tendrils: {msg}")

    # ---- stats (panel readouts) --------------------------------------------
    if args.stats:
        import json

        from image_segmenter_tpu_torch.processing.color_simplify import (
            get_color_statistics)
        from image_segmenter_tpu_torch.processing.region_cleanup import (
            analyze_regions)

        src = state.working_image
        cs = get_color_statistics(src, device=dev)
        rs = analyze_regions(src, args.min_region_size, args.connectivity,
                             device=dev)
        slim = {k: v for k, v in rs.items() if k != "all_regions"}
        slim["region_colors"] = len(slim.get("region_colors", []))
        slim["region_sizes"] = len(slim.get("region_sizes", []))
        print(json.dumps({"color": {k: (v if not hasattr(v, "tolist") else v.tolist())
                                    for k, v in cs.items()},
                          "regions": slim}, default=str, indent=1))

    _save(args.output, state.working_image)
    log(f"saved {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
