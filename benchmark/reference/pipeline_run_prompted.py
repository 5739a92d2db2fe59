"""The reference of the `pipeline_run_prompted` entry, and the comparison
that decides `correct`.

`Reference(config, state, device, control=False, cnn="f32")` is the
main path with a prompted model in plain PyTorch: Segment Anything with
one box a frame (`sam_plain.py`: PIL bilinear to the longest side 1024,
normalise, pad, the image encoder, the box's prompt, the mask decoder,
the logits bilinear up, cropped, bilinear to the frame, 255 where above
0), then the stages of `pipeline_run.py`'s reference from that alpha:
AREA down to at most `matting_dim`, the trimap, the matting CG
warm-started at it, LINEAR up, Otsu, the 3 x 3 close and open, the
black-filter ladder, the grid sample, the deterministic k-means and the
palette map. Float32 with TF32 off, one frame at a time. With
`control=True` it is the control: the encoder's linear operands in
float8 e4m3 and the matting and k-means state in bfloat16 (`plain.py`).
With `cnn="bf16"` the encoder's linear operands are rounded to bfloat16,
the configuration's own arithmetic: a witness that tells the precision's
share of a number from a fault's. It takes the weights the benchmark
made, nothing the program made.

`judge(request, out, ref)` compares one call's outputs (host numpy
rgba, alpha, palettes, logits, iou) with the reference and returns the
numbers, each of which the cell's limits file bounds:
- `logit_rel`: the largest, over the call's frames, of ||logits - ref||_2
  / ||ref||_2 on the low-resolution logits: the network, which the
  configuration computes in bfloat16 and the reference in float32;
- `iou_abs`: the largest |IoU prediction - the reference's|;
- `alpha_mad`: the largest, over the frames, of the mean absolute
  difference between the program's u8 alpha and the reference chain's
  own (its alpha0 from its own logits). Where a logit lies near 0 the
  two alpha0 can differ by a pixel's 255, which the matting then
  spreads: a tolerance;
- `rgba_mismatch`, `palette_mismatch`: as `pipeline_run`'s, exact: the
  reference's stages after the matting on the program's own alpha.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import plain, sam_plain


class Reference:
    def __init__(self, config: dict, state: dict, device, control=False,
                 cnn: str = "f32"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = config
        self.device = torch.device(device)
        self.control = control
        with torch.device("meta"):
            self.net = sam_plain.SamPlain(config["arch"],
                                          "fp8" if control else cnn,
                                          **config["widths"])
        self.net.load_state_dict(state, assign=True)
        self.predict_kw = {}  # sam_plain.predict's fault switches (tests)

    @torch.no_grad()
    def frame(self, img_u8: torch.Tensor, box: np.ndarray):
        """One (H, W, 3) u8 frame and its box -> (rgba, alpha, palette,
        low-resolution logits (1, g, g), IoU (1,)) tensors."""
        cfg = self.cfg
        full, low, iou = sam_plain.predict(self.net, img_u8, box,
                                           **self.predict_kw)
        imgs = img_u8[None].to(self.device)
        h, w = imgs.shape[1:3]
        alpha0 = ((full > 0).to(torch.uint8) * 255)[None]
        mdim = cfg["matting_dim"]
        if h > mdim or w > mdim:
            sh, sw = plain.scale_to_max_dim(h, w, mdim)
            rgb_s = plain.resize_u8(imgs, (sh, sw), plain.AREA)
            a_s = plain.resize_u8(alpha0, (sh, sw), plain.AREA)
        else:
            sh, sw, rgb_s, a_s = h, w, imgs, alpha0
        alpha_m, _ = plain.cg_solve(
            plain.true_div(rgb_s.to(torch.float32), 255.0),
            plain.trimap(a_s), plain.true_div(a_s.to(torch.float32), 255.0),
            rtol=cfg["cg_rtol"], max_iter=cfg["cg_iters"], lowp=self.control)
        alpha_u8 = torch.clamp(torch.floor(alpha_m * 255.0 + 0.5), 0, 255) \
            .to(torch.uint8)
        if (sh, sw) != (h, w):
            alpha_u8 = plain.resize_u8(alpha_u8, (h, w), plain.LINEAR)
        sharp = plain.sharp_alpha(alpha_u8)
        rgb, pal = plain.quantize(imgs, sharp, cfg["k"], self.control)
        rgba = torch.cat([rgb, (sharp.to(torch.uint8) * 255)[..., None]], -1)
        return rgba[0], alpha_u8[0], pal[0], low[0], iou[0]

    def __call__(self, request) -> dict:
        """A request ((B, H, W, 3) u8 frames, (B, 4) boxes) -> the entry's
        outputs, host numpy."""
        frames, boxes = request
        outs = [self.frame(torch.from_numpy(f), b)
                for f, b in zip(frames, boxes)]
        return {k: np.stack([o[i].cpu().numpy() for o in outs])
                for i, k in enumerate(("rgba", "alpha", "palettes",
                                       "logits", "iou"))}

    @torch.no_grad()
    def stages_after(self, img_u8: np.ndarray, alpha_u8: np.ndarray):
        """The reference's stages after the matting on one frame and a
        given u8 alpha: (rgba (H, W, 4) u8, palette (k, 3) u8)."""
        a = torch.from_numpy(alpha_u8)[None].to(self.device)
        img = torch.from_numpy(img_u8)[None].to(self.device)
        sharp = plain.sharp_alpha(a)
        rgb, pal = plain.quantize(img, sharp, self.cfg["k"], False)
        rgba = torch.cat([rgb, (sharp.to(torch.uint8) * 255)[..., None]], -1)
        return rgba[0].cpu().numpy(), pal[0].cpu().numpy()


def judge(request, out: dict, ref: Reference) -> dict:
    """The numbers of one call: `out` (the program's or the control's
    outputs) against the float32 reference `ref`."""
    frames, _ = request
    want = ref(request)
    got_l = out["logits"].astype(np.float64).reshape(len(frames), -1)
    want_l = want["logits"].astype(np.float64).reshape(len(frames), -1)
    logit_rel = float((np.linalg.norm(got_l - want_l, axis=1)
                       / np.maximum(np.linalg.norm(want_l, axis=1),
                                    1e-30)).max())
    iou_abs = float(np.abs(out["iou"].astype(np.float64)
                           - want["iou"]).max())
    alpha_mad = float(np.abs(out["alpha"].astype(np.int16) - want["alpha"])
                      .mean(axis=(1, 2)).max())
    rgba_bad = pal_bad = 0
    for i in range(frames.shape[0]):
        rgba, pal = ref.stages_after(frames[i], out["alpha"][i])
        rgba_bad += int((rgba != out["rgba"][i]).any(axis=-1).sum())
        pal_bad += int((pal != out["palettes"][i]).any(axis=-1).sum())
    return {"logit_rel": logit_rel, "iou_abs": iou_abs,
            "alpha_mad": alpha_mad,
            "rgba_mismatch": rgba_bad / out["alpha"].size,
            "palette_mismatch": float(pal_bad)}
