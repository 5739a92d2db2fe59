"""One-command trained-checkpoint verification drill.

    python -m image_segmenter_tpu_torch.tools.verify_checkpoint ~/.u2net/isnet-general-use.onnx

Counterpart of image_segmenter_tpu/tools/verify_checkpoint.py. No rembg
checkpoint is in the repository, so parity of trained weights with the
reference's onnxruntime path (reference rembg_infer.py:46-72) waits for
one; this tool makes it a short task the moment a file appears:

1. strict-loads the checkpoint into the matching network and reports the
   mapped/total leaf accounting (LoadReport);
2. runs the forward on a deterministic golden input and reports
   per-output activation statistics (compare against onnxruntime on the
   same input);
3. runs the product path (rembg pre/post and the Otsu sharp edges) and
   reports mask statistics.

Prints the result as one JSON line. Exit code 0 = checkpoint fully mapped
and forward ran; 1 = load refused (a partial or mismatched checkpoint:
the non-strict report is printed so the gap is visible). Runs on the card
unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch


def golden_image(h: int = 384, w: int = 480) -> np.ndarray:
    """Deterministic content-rich RGB u8 test card (subject blob on a
    textured background, so a trained saliency net produces a non-trivial
    mask and statistics are comparison-stable)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    bg = np.stack([
        120 + 90 * np.sin(xx / 31.0),
        128 + 80 * np.cos(yy / 23.0),
        100 + 60 * np.sin((xx + yy) / 41.0),
    ], axis=-1)
    cy, cx, ry, rx = h * 0.52, w * 0.48, h * 0.27, w * 0.21
    blob = ((yy - cy) ** 2 / ry**2 + (xx - cx) ** 2 / rx**2) < 1.0
    fg = np.stack([230 - 0.08 * yy, 60 + 0.05 * xx, 40 + 0.0 * xx], axis=-1)
    img = np.where(blob[..., None], fg, bg)
    rng = np.random.default_rng(7)
    img = img + rng.normal(0.0, 4.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _arr_stats(name: str, a: np.ndarray) -> dict:
    a = np.asarray(a, np.float64)
    q = np.percentile(a, [1, 50, 99])
    return {
        "output": name,
        "shape": list(np.shape(a)),
        "mean": round(float(a.mean()), 6),
        "std": round(float(a.std()), 6),
        "min": round(float(a.min()), 6),
        "max": round(float(a.max()), 6),
        "p01": round(float(q[0]), 6),
        "p50": round(float(q[1]), 6),
        "p99": round(float(q[2]), 6),
    }


def verify(path: str, model: str | None = None, half: bool = False,
           device="cuda") -> dict:
    """Run the full drill; returns the result dict (printed by main)."""
    from image_segmenter_tpu_torch.compat import rembg_infer as RI
    from image_segmenter_tpu_torch.models import onnx_import as OIMP
    from image_segmenter_tpu_torch.models import registry as REG
    from image_segmenter_tpu_torch.ops import histogram as HG
    from image_segmenter_tpu_torch.ops import resize as RZ

    if model is None:
        model = os.path.splitext(os.path.basename(path))[0]
    if model not in REG.SPECS:
        raise SystemExit(
            f"cannot infer model id from {path!r} (got {model!r}); "
            f"pass --model, one of {sorted(REG.SPECS)}")

    result: dict = {"checkpoint": os.path.abspath(path), "model": model}

    # 1. strict load through the Session; a refusal falls back to one
    # non-strict load for the accounting
    try:
        sess = REG.Session(model, half=half, ckpt_path=path, device=device)
    except RuntimeError as e:
        module = REG._build(REG.SPECS[model], half)
        _, report = OIMP.load_into_state_dict(module, path, strict=False)
        result["load"] = {"ok": False, "error": str(e),
                          "summary": report.summary(),
                          "mapped": report.mapped, "total": report.total,
                          "missing": report.missing[:20],
                          "shape_mismatch": report.shape_mismatch[:20]}
        return result
    report = sess.load_report
    result["load"] = {"ok": True, "summary": report.summary(),
                      "mapped": report.mapped, "total": report.total,
                      "folded_bn": report.folded_bn, "mode": report.mode}

    # 2. golden-input activations through the Session's forward, NHWC as
    # the JAX package reports them
    rgb = golden_image()
    x = torch.from_numpy(rgb).to(sess.device)
    small = RZ.resize_u8(x[None], sess.spec.size, RZ.LANCZOS_PIL)[0]
    with torch.no_grad():
        outs = sess.module(sess._normalize(small))
    result["activations"] = [
        _arr_stats(f"d{i}", o.permute(0, 2, 3, 1).float().cpu().numpy())
        for i, o in enumerate(outs)]

    # 3. pipeline-level mask statistics (the reference-visible contract)
    mask = sess.predict_mask(rgb)
    rgba = RI._make_alpha_sharp(np.dstack([rgb, mask]), sess.device)
    otsu_t = float(HG.otsu_threshold(torch.from_numpy(mask)[None])[0])
    result["mask"] = {
        "golden_input_hw": list(rgb.shape[:2]),
        "mask_mean": round(float(mask.mean()), 4),
        "fg_frac_at_128": round(float((mask > 128).mean()), 6),
        "otsu_threshold": otsu_t,
        "sharp_fg_frac": round(float((rgba[:, :, 3] > 0).mean()), 6),
        "mask_p10_p50_p90": [float(v) for v in
                             np.percentile(mask, [10, 50, 90])],
    }
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="verify_checkpoint",
        description="Strict-load an ONNX checkpoint and print parity stats.")
    ap.add_argument("path", help=".onnx checkpoint file")
    ap.add_argument("--model", default=None,
                    help="model id (default: inferred from filename)")
    ap.add_argument("--half", action="store_true",
                    help="run the forward in bf16 (product default)")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="also write the result dict to this file")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain path)")
    args = ap.parse_args(argv)

    if not os.path.isfile(args.path):
        print(f"no such file: {args.path}", file=sys.stderr)
        return 1
    result = verify(args.path, args.model, half=args.half, device=args.device)
    print(json.dumps(result))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(result, f, indent=1)
    return 0 if result["load"]["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
