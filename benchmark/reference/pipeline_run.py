"""The reference of the `pipeline_run` entry, and the comparison that
decides `correct`.

`Reference(config, state, device, control=False)` is the main path in
plain PyTorch (`nets.py`, `plain.py`): the CNN on the PIL-Lanczos input at
the network's size, max-scaled and normalised, its min-max saliency in
u8; Lanczos back up, AREA down to at most `matting_dim`, the trimap, the
matting CG warm-started at the CNN's alpha, LINEAR up, Otsu and the 3 x 3
close and open; then the black-filter ladder, the grid sample, the
deterministic k-means and the palette map. It runs in float32 with TF32
off, one frame at a time. With `control=True` it is the control: the
CNN's convolutions in float8 and the matting and k-means state in
bfloat16 (see `nets.py`, `plain.py`). With `cnn="bf16"` its CNN has the
configuration's own arithmetic (the port's bfloat16 blocks), a witness
that tells the precision's share of `alpha_mad` from a fault's. It takes the weights the benchmark
made, nothing the program made.

`judge(batch, out, ref)` compares one call's outputs (host numpy rgba,
alpha, palettes) with the reference and returns the numbers, each of
which the cell's limits file bounds:
- `alpha_mad`: the largest, over the call's frames, of the mean absolute
  difference between the program's u8 alpha and the reference's. It
  judges the CNN, the resizes, the trimap and the matting CG, which the
  configuration computes in bfloat16 and float32 and the reference in
  float32, so it has a tolerance.
- `rgba_mismatch`: the share of the call's pixels whose rgba differs from
  what the reference's stages after the matting (Otsu, the close and
  open, the black filter, the grid sample, the k-means and the palette
  map) make of the frame and the program's own alpha, and
- `palette_mismatch`: the palette entries that differ there. Given what
  the program fed them, those stages are exact in the program (integer
  histograms, sums in a fixed order, whole-number distances), so the two
  are compared exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import nets, plain

class Reference:
    def __init__(self, config: dict, state: dict, device, control=False,
                 cnn: str = "f32"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = config
        self.device = torch.device(device)
        self.control = control
        self.net = nets.build(config["arch"], "fp8" if control else cnn)
        self.net.load_state_dict(state, assign=True)
        self.mean = torch.tensor(config["mean"], device=self.device)
        self.std = torch.tensor(config["std"], device=self.device)

    @torch.no_grad()
    def frame(self, img_u8: torch.Tensor):
        """One (H, W, 3) u8 frame -> (rgba, alpha, palette) tensors."""
        cfg = self.cfg
        imgs = img_u8[None].to(self.device)
        h, w = imgs.shape[1:3]
        small = plain.resize_u8(imgs, cfg["input_size"], plain.LANCZOS_PIL)
        x = small.to(torch.float32)
        x = x / torch.clamp_min(x.amax(dim=(1, 2, 3), keepdim=True), 1e-6)
        x = (x - self.mean) / self.std
        d0 = self.net(x.permute(0, 3, 1, 2))[:, 0]
        mi = d0.amin(dim=(1, 2), keepdim=True)
        ma = d0.amax(dim=(1, 2), keepdim=True)
        m01 = (d0 - mi) / torch.clamp_min(ma - mi, 1e-12)
        mask = torch.clamp(torch.floor(m01 * 255.0 + 0.5), 0, 255) \
            .to(torch.uint8)
        alpha0 = plain.resize_u8(mask, (h, w), plain.LANCZOS_PIL)
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
            rtol=1e-4, max_iter=cfg["cg_iters"], lowp=self.control)
        alpha_u8 = torch.clamp(torch.floor(alpha_m * 255.0 + 0.5), 0, 255) \
            .to(torch.uint8)
        if (sh, sw) != (h, w):
            alpha_u8 = plain.resize_u8(alpha_u8, (h, w), plain.LINEAR)
        sharp = plain.sharp_alpha(alpha_u8)
        rgb, pal = plain.quantize(imgs, sharp, cfg["k"], self.control)
        rgba = torch.cat([rgb, (sharp.to(torch.uint8) * 255)[..., None]], -1)
        return rgba[0], alpha_u8[0], pal[0]

    def __call__(self, batch: np.ndarray) -> dict:
        """A (B, H, W, 3) u8 batch -> the entry's outputs, host numpy."""
        outs = [self.frame(torch.from_numpy(f)) for f in batch]
        return {k: np.stack([o[i].cpu().numpy() for o in outs])
                for i, k in enumerate(("rgba", "alpha", "palettes"))}

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


def judge(batch: np.ndarray, out: dict, ref: Reference) -> dict:
    """The numbers of one call: `out` (the program's or the control's
    outputs) against the float32 reference `ref`."""
    want = ref(batch)
    alpha_mad = float(np.abs(out["alpha"].astype(np.int16) - want["alpha"])
                      .mean(axis=(1, 2)).max())
    rgba_bad = pal_bad = 0
    for i in range(batch.shape[0]):
        rgba, pal = ref.stages_after(batch[i], out["alpha"][i])
        rgba_bad += int((rgba != out["rgba"][i]).any(axis=-1).sum())
        pal_bad += int((pal != out["palettes"][i]).any(axis=-1).sum())
    return {"alpha_mad": alpha_mad,
            "rgba_mismatch": rgba_bad / out["alpha"].size,
            "palette_mismatch": float(pal_bad)}
