"""The main path: background removal -> matting refine -> k-means.

Counterpart of image_segmenter_tpu/pipeline/segment.py (BASELINE config
5). A (B, H, W, 3) uint8 batch goes through:

1. PIL-Lanczos resize to the network size, U^2-Net forward, min-max
   normalise (cnn stage);
2. Lanczos resize back up, AREA shrink to at most `matting_dim`, trimap
   from u8 quantiles, closed-form matting PCG warm-started at the CNN
   alpha, LINEAR resize up, Otsu, 3x3 ellipse close and open (matting);
3. black-filter ladder, grid colour sample, deterministic k-means, and
   the fused nearest-palette map (quantize).

A prompted model (Segment Anything, `sam_vit_h` and `sam`:
models/sam.py) replaces step 1 with its own network stage, which takes
one box a frame: `Pipeline.run(imgs, boxes)`. SamPredictor's path:
PIL-bilinear resize of the longest side to 1024, normalise and pad, the
image encoder, the box's prompt encoding, the mask decoder (mask 0, the
box's single output), the logits bilinear up to 1024, cropped and
bilinear up to the frame, 255 where above 0. That full-size alpha enters
step 2 where the CNN's Lanczos-upsampled mask does; the low-resolution
logits and IoU predictions are outputs too (`PipelineOutput.logits`,
`.iou`).

One batch at a time: the JAX package's per-image `vmap`s are a batch
axis written out. Four hand-written CUDA kernels run on a CUDA device: K1
histogram (trimap quantiles, Otsu), K2 precompute and K3 matvec
(matting), K4 quantize (the palette map).

Compiled on the card, as the JAX package's `jax.jit`: `Pipeline.run` on a
CUDA device captures the batch function once per input shape as CUDA
graphs and replays them (pipeline/compiled.py), the matting CG and the
Lloyd loop replayed a chunk at a time until their stop flag clears. The
batch function is a program (`batch_program`: the network stage, then
`refine_program`'s matting and quantize) that yields each loop it
reaches; `run_eager`, `run_from_mask` and the sharded run drive the same
programs op by op, which is also how the CPU goes.
A prompted model's network stage, and BiRefNet's (`birefnet-general`:
models/birefnet.py, a saliency model whose map takes a sigmoid before
the min-max), ends in a `utils.loops.Cut`, so that it is a graph of its
own, whose `compiled.segment` spans name the model.

`Pipeline(sharding=batch_sharding(mesh))` spreads a batch over a (data,
space) mesh of device slots (parallel/mesh.py), as the JAX package's
sharded run does: the batch splits over the data axis; in each data
group the CNN, the resizes, the trimap, Otsu, the morphology and the
k-means fit and map run whole on the group's first slot (the JAX
package pins those to batch-only sharding), and the matting solve (K2
once, K3 every iteration) runs with its rows split over the group's
space slots. The groups run one after another from one controller; the
outputs are gathered on the mesh's first slot.
"""

from __future__ import annotations

import copy
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from image_segmenter_tpu_torch.config import DEFAULTS
from image_segmenter_tpu_torch.kernels.quantize import quantize_map
from image_segmenter_tpu_torch.models import registry as REG
from image_segmenter_tpu_torch.models import sam as SAM
from image_segmenter_tpu_torch.ops import histogram as HG
from image_segmenter_tpu_torch.ops import morphology as M
from image_segmenter_tpu_torch.ops import resize as RZ
from image_segmenter_tpu_torch.parallel.mesh import DATA_AXIS, SPACE_AXIS, \
    same_device, split_bounds, to_slot
from image_segmenter_tpu_torch.pipeline.compiled import ProgramCache
from image_segmenter_tpu_torch.solvers import kmeans as KM
from image_segmenter_tpu_torch.solvers.matting import CGLoop
from image_segmenter_tpu_torch.utils.backend import resolve_device, true_div
from image_segmenter_tpu_torch.utils.loops import Cut, drive
from image_segmenter_tpu_torch.utils.profiling import setup_span, span


class _Outputs(NamedTuple):
    rgba: torch.Tensor      # (B, H, W, 4) uint8 quantized cutout
    alpha: torch.Tensor     # (B, H, W) uint8 refined alpha
    palettes: torch.Tensor  # (B, K, 3) uint8


class PipelineOutput(_Outputs):
    """(rgba, alpha, palettes), as a tuple of three; a prompted model's
    run also sets `logits`, the network's low-resolution mask logits
    (B, 1, 256, 256) float32, and `iou`, its IoU predictions (B, 1)
    float32. Both are None for the other models."""

    def __new__(cls, rgba, alpha, palettes, logits=None, iou=None):
        out = super().__new__(cls, rgba, alpha, palettes)
        out.logits, out.iou = logits, iou
        return out


def _bview(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B,) -> broadcastable against `like` (B, ...)."""
    return x.reshape(-1, *([1] * (like.dim() - 1)))


def _trimap_device(alpha_init: torch.Tensor) -> torch.Tensor:
    """The reference trimap ladder (matting_refine.py:14-54), per image of
    a (B, H, W) u8 batch -> (B, H, W) float32 in {0, 0.5, 1}."""
    a = alpha_init.to(torch.float32)
    amin = a.amin(dim=(1, 2))
    amax = a.amax(dim=(1, 2))
    contrast = (amax - amin) > 50
    # sort-free u8 percentiles, both from one histogram
    q_hi, q_lo = HG.u8_quantile(alpha_init, (0.8, 0.2))
    hi_t = torch.where(contrast, 220.0, q_hi)
    lo_t = torch.where(contrast, 20.0, q_lo)
    tri = torch.full_like(a, 0.5)
    tri = torch.where(a >= _bview(hi_t, a), 1.0, tri)
    tri = torch.where(a <= _bview(lo_t, a), 0.0, tri)
    # FG/BG-nonempty fallback -> simple 128 threshold
    need_fb = ((tri == 1.0).sum(dim=(1, 2)) == 0) \
        | ((tri == 0.0).sum(dim=(1, 2)) == 0)
    fb = torch.where(a >= 128, 1.0, 0.0)
    return torch.where(_bview(need_fb, a), fb, tri)


def _sharp_alpha(alpha_u8: torch.Tensor) -> torch.Tensor:
    """Otsu + 3x3 ellipse close/open (rembg_infer.py:75-96) -> bool."""
    binary = HG.otsu_binarize(alpha_u8)
    se = M.structuring_element(M.ELLIPSE, (3, 3))
    return M.open_binary(M.close_binary(binary, se), se)


def _span_idx(n: int, count: int, device=None) -> torch.Tensor:
    """`count` DISTINCT indices spanning [0, n): the centre of each of
    `count` equal buckets (distinct whenever count <= n)."""
    return (torch.arange(count, device=device) * n) // count \
        + max(n // (2 * count), 0)


def _pick_index_set(cnt: torch.Tensor, uni: torch.Tensor, ok: torch.Tensor,
                    count: int) -> torch.Tensor:
    """Per image: the uniform index set where `ok`, else the `count`
    largest-count indices (lowest index first on ties), sorted."""
    mass = torch.sort(cnt, dim=1, descending=True, stable=True).indices[:, :count]
    mass = torch.sort(mass, dim=1).values
    return torch.where(ok[:, None], uni[None, :], mass)


def grid_sample_colors(rgb: torch.Tensor, fit2d: torch.Tensor,
                       min_mass: int = 64, cap: int = 1 << 14):
    """Systematic grid sample of the fit-masked colour distribution, per
    image: rgb (B, h, w, 3) u8, fit2d (B, h, w) bool -> sample (B, cap, 3)
    float32, weights (B, cap) float32.

    Rows first (about 128 full rows), then columns of those rows. Where
    the uniform grid catches less than `min_mass` of fit mass (a thin
    foreground between sampled rows), the rows — or, at the column stage,
    the columns — with the most fit pixels are taken instead.
    """
    bsz, h, w = fit2d.shape
    dev = rgb.device
    R = min(h, 128)
    ncol = min(w, max(1, cap // R))
    ar = torch.arange(bsz, device=dev)

    row_cnt = fit2d.sum(dim=2, dtype=torch.int32)          # (B, h)
    uni_rows = _span_idx(h, R, dev)
    mm = float(min_mass)
    col_scale = float(np.float32(ncol) / np.float32(w))
    rows_ok = row_cnt[:, uni_rows].sum(dim=1).to(torch.float32) \
        * col_scale >= mm
    row_idx = _pick_index_set(row_cnt, uni_rows, rows_ok, R)

    rows = rgb[ar[:, None], row_idx]                        # (B, R, w, 3)
    rfit = fit2d[ar[:, None], row_idx]                      # (B, R, w)
    col_cnt = rfit.sum(dim=1, dtype=torch.int32)            # (B, w)
    uni_cols = _span_idx(w, ncol, dev)
    cols_ok = col_cnt[:, uni_cols].sum(dim=1).to(torch.float32) >= mm
    col_idx = _pick_index_set(col_cnt, uni_cols, cols_ok, ncol)

    sample = torch.gather(rows, 2, col_idx[:, None, :, None].expand(
        -1, R, -1, 3)).reshape(bsz, -1, 3).to(torch.float32)
    wts = torch.gather(rfit, 2, col_idx[:, None, :].expand(-1, R, -1)) \
        .reshape(bsz, -1).to(torch.float32)
    if sample.shape[1] < cap:
        pad = cap - sample.shape[1]
        sample = torch.nn.functional.pad(sample, (0, 0, 0, pad))
        wts = torch.nn.functional.pad(wts, (0, pad))
    return sample[:, :cap], wts[:, :cap]


def _kmeans16_sample(rgb: torch.Tensor, alpha_mask: torch.Tensor, k: int):
    """Black-filter ladder + grid colour sample per image. The brightness
    here is the mean (sum / 3), as the JAX package's `jnp.mean`; the
    palette map (K4) uses (r+g+b) * (1/3). Each stays where it is."""
    bsz, h, w = alpha_mask.shape
    flat = rgb.reshape(bsz, -1, 3).to(torch.float32)
    nt = alpha_mask.reshape(bsz, -1)
    brightness = true_div((flat[..., 0] + flat[..., 1]) + flat[..., 2], 3.0)
    # black-filter ladder folded into one threshold: 30 -> 10 -> none
    n30 = (nt & (brightness > 30)).sum(dim=1)
    n10 = (nt & (brightness > 10)).sum(dim=1)
    thr = torch.where(n30 >= k, 30.0, torch.where(n10 > 0, 10.0, -1.0))
    fit = nt & (brightness > thr[:, None])
    sample, wts = grid_sample_colors(rgb, fit.reshape(bsz, h, w),
                                     min_mass=max(k, 64))
    return sample, wts, thr


def _kmeans16_fit_program(sample: torch.Tensor, wts: torch.Tensor, k: int):
    """Deterministic weighted k-means on the (B, cap, 3) sample -> u8
    centers (B, k, 3); yields its Lloyd loop."""
    loop = KM.kmeans_fit_det_loop(sample, wts, k)
    yield loop
    return torch.clamp(loop.finish().centers, 0, 255).to(torch.uint8)


def _kmeans16_fit(sample: torch.Tensor, wts: torch.Tensor, k: int):
    return drive(_kmeans16_fit_program(sample, wts, k))


def _kmeans16_map(rgb: torch.Tensor, alpha_mask: torch.Tensor,
                  thr: torch.Tensor, centers_u8: torch.Tensor, k: int):
    """Map every pixel to its nearest center, zeroing transparent and
    black-filtered pixels (kernel K4 on the card)."""
    return quantize_map(rgb, alpha_mask, centers_u8.to(torch.float32), k, thr)


def _kmeans16_quantize_program(rgb: torch.Tensor, alpha_mask: torch.Tensor,
                               k: int):
    """Reference kmeans semantics on a batch: black-filter + weighted
    Lloyd on a grid sample + the fused palette map."""
    sample, wts, thr = _kmeans16_sample(rgb, alpha_mask, k)
    centers_u8 = yield from _kmeans16_fit_program(sample, wts, k)
    return _kmeans16_map(rgb, alpha_mask, thr, centers_u8, k), centers_u8


@torch.no_grad()
def saliency_u8(module, small: torch.Tensor, mean: torch.Tensor,
                std: torch.Tensor, post: str = "identity") -> torch.Tensor:
    """The network on the resized (B, nh, nw, 3) u8 batch: max-scale,
    normalise, forward, the spec's `post` ("sigmoid": rembg's BiRefNet
    session), min-max per image -> (B, nh, nw) u8 mask."""
    x = small.to(torch.float32)
    x = x / torch.clamp_min(x.amax(dim=(1, 2, 3), keepdim=True), 1e-6)
    x = (x - mean) / std
    d0 = module(x.permute(0, 3, 1, 2))[0][:, 0]
    if post == "sigmoid":
        d0 = torch.sigmoid(d0)
    mi = d0.amin(dim=(1, 2), keepdim=True)
    ma = d0.amax(dim=(1, 2), keepdim=True)
    m01 = (d0 - mi) / torch.clamp_min(ma - mi, 1e-12)
    return torch.clamp(torch.floor(m01 * 255.0 + 0.5), 0, 255) \
        .to(torch.uint8)


def matting_solve_program(rgb_s: torch.Tensor, trimap: torch.Tensor,
                          a_s: torch.Tensor, cg_iters: int, mesh=None):
    """The matting solve at the shrunk size: u8 rgb (B, h, w, 3), the
    trimap and the u8 CNN alpha as the warm start -> (u8 alpha (B, h, w),
    CG iterations (B,)); yields its CG loop."""
    # rtol 1e-4 suffices for uint8 alpha (quantization step 4e-3);
    # CG warm-started at the CNN alpha
    loop = CGLoop(true_div(rgb_s.to(torch.float32), 255.0), trimap,
                  rtol=1e-4, max_iter=cg_iters,
                  x0=true_div(a_s.to(torch.float32), 255.0), half_stats=True,
                  mesh=mesh)
    yield loop
    alpha_m, _, iters, _, _ = loop.finish()
    return torch.clamp(torch.floor(alpha_m * 255.0 + 0.5), 0, 255) \
        .to(torch.uint8), iters


def matting_solve_u8(rgb_s: torch.Tensor, trimap: torch.Tensor,
                     a_s: torch.Tensor, cg_iters: int, mesh=None):
    """`matting_solve_program`, run eagerly."""
    return drive(matting_solve_program(rgb_s, trimap, a_s, cg_iters, mesh))


class StageFns(NamedTuple):
    """The three pipeline phases as batch functions, eager, and the two
    with a loop also as programs that yield it (pipeline/compiled.py).
    A prompted model's `cnn` takes the boxes too and gives (alpha0 u8
    BHW, logits, iou); its `matting` starts from that full-size alpha0.
    `model`: the model id of a network stage that is a graph of its own
    (the spec's `own_graph`: SAM, BiRefNet), which ends in a `Cut` so
    labelled; "" for any other."""
    cnn: Callable        # (module, imgs u8 BHW3) -> mask_small u8 (B,nh,nw)
    matting: Callable    # (imgs, mask_small) -> (sharp bool BHW, alpha u8 BHW)
    quantize: Callable   # (imgs, sharp) -> (rgba u8 BHW4, palettes u8 BK3)
    matting_program: Callable   # matting as a program
    quantize_program: Callable  # quantize as a program
    model: str = ""             # the label of the network's own graph


def make_stage_fns(session, k: int, matting_dim: int, cg_iters: int,
                   device=None, solve_mesh=None) -> StageFns:
    """The stages on `device` (the session's by default). solve_mesh, a
    (1, S) (data, space) mesh whose first slot is `device`, splits the
    matting solve's rows over its S slots."""
    spec = session.spec
    dev = session.device if device is None else resolve_device(device)
    nh, nw = spec.size
    mean = torch.tensor(spec.mean, dtype=torch.float32, device=dev)
    std = torch.tensor(spec.std, dtype=torch.float32, device=dev)
    mdim = matting_dim

    def cnn_stage(module, imgs):
        small = RZ.resize_u8(imgs, (nh, nw), RZ.LANCZOS_PIL)
        return saliency_u8(module, small, mean, std, spec.post)

    def prompted_stage(module, imgs, boxes):
        return SAM.prompted_logits(module, imgs, boxes, mean, std)

    def matting_program(imgs, mask_small):
        h, w = imgs.shape[1:3]
        # upsample netmask to full res (LANCZOS like rembg post); a
        # prompted model's alpha is full-size already
        alpha0 = mask_small if spec.prompted else \
            RZ.resize_u8(mask_small, (h, w), RZ.LANCZOS_PIL)
        # matting at <= matting_dim (reference shrink rule)
        if h > mdim or w > mdim:
            sh, sw = RZ.scale_to_max_dim(h, w, mdim)
            rgb_s = RZ.resize_u8(imgs, (sh, sw), RZ.AREA)
            a_s = RZ.resize_u8(alpha0, (sh, sw), RZ.AREA)
        else:
            sh, sw = h, w
            rgb_s, a_s = imgs, alpha0
        trimap = _trimap_device(a_s)
        alpha_m_u8, _ = yield from matting_solve_program(
            rgb_s, trimap, a_s, cg_iters, solve_mesh)
        if (sh, sw) != (h, w):
            alpha_full = RZ.resize_u8(alpha_m_u8, (h, w), RZ.LINEAR)
        else:
            alpha_full = alpha_m_u8
        return _sharp_alpha(alpha_full), alpha_full

    def quantize_program(imgs, sharp):
        qrgb, centers = yield from _kmeans16_quantize_program(imgs, sharp, k)
        alpha_out = sharp.to(torch.uint8) * 255
        rgba = torch.cat([qrgb, alpha_out[..., None]], dim=-1)
        return rgba, centers

    def matting_stage(imgs, mask_small):
        return drive(matting_program(imgs, mask_small))

    def quantize_stage(imgs, sharp):
        return drive(quantize_program(imgs, sharp))

    return StageFns(prompted_stage if spec.prompted else cnn_stage,
                    matting_stage, quantize_stage, matting_program,
                    quantize_program,
                    session.model_id if spec.own_graph else "")


def refine_program(stages: StageFns, imgs: torch.Tensor,
                   mask: torch.Tensor):
    """Matting then quantize from the network stage's mask, as one
    program: (rgba, alpha, palettes)."""
    sharp, alpha = yield from stages.matting_program(imgs, mask)
    rgba, palettes = yield from stages.quantize_program(imgs, sharp)
    return rgba, alpha, palettes


def batch_program(stages: StageFns, module, imgs: torch.Tensor,
                  boxes: Optional[torch.Tensor] = None):
    """The whole batch function as one program: (rgba, alpha, palettes)
    of a (B, H, W, 3) u8 batch on the stages' device; with `boxes` (a
    prompted model's (B, 4) float32) also (logits, iou), the network
    stage cut into a graph of its own, as BiRefNet's is."""
    if boxes is None:
        mask, extra = stages.cnn(module, imgs), ()
    else:
        mask, *extra = stages.cnn(module, imgs, boxes)
    if stages.model:
        yield Cut(stages.model)
    out = yield from refine_program(stages, imgs, mask)
    return out + tuple(extra)


def _batch_program(imgs: torch.Tensor, boxes=None, *, stages: StageFns,
                   module):
    """`batch_program` with its tensors first, as `ProgramCache` calls a
    program."""
    return batch_program(stages, module, imgs, boxes)


def network_on(module: torch.nn.Module, dev: torch.device,
               copies: dict) -> torch.nn.Module:
    """`module` on `dev`: itself where it lives there, else a copy kept in
    `copies` (made once for these weights)."""
    if same_device(next(module.parameters()).device, dev):
        return module
    key = (id(module), str(dev))
    if key not in copies:
        copies[key] = copy.deepcopy(module).to(dev)
    return copies[key]


def _as_batch(imgs_u8) -> torch.Tensor:
    x = torch.as_tensor(imgs_u8)
    if x.dim() != 4 or x.shape[-1] != 3 or x.dtype != torch.uint8 \
            or x.shape[0] == 0:
        raise ValueError("Pipeline.run takes a (B, H, W, 3) uint8 batch, "
                         f"B >= 1, got {tuple(x.shape)} {x.dtype}")
    return x


def _as_boxes(boxes, session, batch: int):
    """A prompted model's (B, 4) float32 boxes as a tensor; None for the
    other models. Raises where a box is missing or not wanted."""
    model = session.model_id
    if not session.spec.prompted:
        if boxes is not None:
            raise ValueError(f"{model} takes no boxes; only a prompted "
                             "model (sam_vit_h, sam) does")
        return None
    if boxes is None:
        raise ValueError(f"{model} takes one box a frame: run(imgs, boxes) "
                         "with boxes (B, 4) float32 x0, y0, x1, y1")
    b = torch.as_tensor(boxes)
    if tuple(b.shape) != (batch, 4) or b.dtype != torch.float32:
        raise ValueError(f"{model}: boxes are ({batch}, 4) float32, got "
                         f"{tuple(b.shape)} {b.dtype}")
    return b


class Pipeline:
    """End-to-end pipeline for a fixed model id, on one device or sharded
    over a mesh.

    `run(imgs)` takes a (B, H, W, 3) uint8 batch (numpy or tensor) and
    returns a PipelineOutput of tensors on `device`; a prompted model
    (`sam_vit_h`, `sam`) takes `run(imgs, boxes)`, one (x0, y0, x1, y1)
    box a frame as (B, 4) float32 numpy or tensor, which every other
    model refuses. device defaults to "cuda" and raises when CUDA is
    absent; it never falls back to the CPU. On a CUDA device `run` is
    compiled, as the JAX `Pipeline` is: the first call of each input
    shape captures the batch function as CUDA graphs, and every call
    replays them (pipeline/compiled.ProgramCache: a program a (B, H, W)
    and device, those of the last `PROGRAM_SHAPES` kept; the boxes are
    its second input).
    `run_eager` runs the same stages op by op, which is what `run` does
    on the CPU. With `sharding`
    (`batch_sharding(mesh)`; see the module docstring) the run lives on
    the mesh's slots, eagerly, `device` is not read, and the outputs are
    on the mesh's first slot.
    """

    def __init__(self, model: str = "u2netp", k: int = 16,
                 matting_dim: Optional[int] = None, cg_iters: int = 200,
                 device="cuda", sharding=None):
        with setup_span("pipeline.init", model):
            self.sharding = sharding
            if sharding is None:
                self.device = resolve_device(device)
            else:
                mesh = sharding.mesh
                if mesh.axis_names != (DATA_AXIS, SPACE_AXIS):
                    raise ValueError("Pipeline: sharding needs a (data, "
                                     "space) mesh, got axes "
                                     f"{mesh.axis_names}")
                for d in mesh.devices.flat:
                    resolve_device(d)
                self.device = mesh.first
            self.session = REG.new_session(model, device=self.device)
            self.k = k
            self.matting_dim = matting_dim or DEFAULTS.matting_max_dim
            self.cg_iters = cg_iters
            self.stages = make_stage_fns(self.session, self.k,
                                         self.matting_dim, self.cg_iters,
                                         device=self.device)
            # per data group: its first slot and its stages, the solve
            # split over the group's space slots; unsharded, one group
            self._groups = [(self.device, self.stages)] if sharding is None \
                else [(g.first, make_stage_fns(
                    self.session, self.k, self.matting_dim, self.cg_iters,
                    device=g.first, solve_mesh=g))
                    for g in (mesh.group(i) for i in range(mesh.shape[0]))]
            self._copies = {}
            # the compiled run's programs, a (B, H, W) and device each
            self._programs = ProgramCache()

    @property
    def programs(self) -> dict:
        """The compiled run's programs kept, by ((B, H, W), device name),
        the one the last call replayed last: at most
        `compiled.PROGRAM_SHAPES`."""
        return {key: prog for key, group in self._programs.groups.items()
                for prog, _ in group.values()}

    def run(self, imgs_u8, boxes=None) -> PipelineOutput:
        with span("pipeline.run"):  # a call's root (utils/profiling.py)
            x = _as_batch(imgs_u8)
            b = _as_boxes(boxes, self.session, x.shape[0])
            if self.sharding is not None or self.device.type != "cuda":
                return self._run(x, None, b)
            return PipelineOutput(*self._programs(
                self.device, tuple(x.shape[:3]), _batch_program, x, b,
                stages=self.stages, module=self.session.module))

    def run_eager(self, imgs_u8, boxes=None) -> PipelineOutput:
        """`run` op by op through `stages`, never from a graph: the plain
        counterpart of the compiled run, with its bytes."""
        x = _as_batch(imgs_u8)
        return self._run(x, None, _as_boxes(boxes, self.session, x.shape[0]))

    def run_from_mask(self, imgs_u8, mask_small) -> PipelineOutput:
        """The matting and quantize stages from a given CNN mask (B, nh,
        nw) uint8, as `run` would take them after its CNN stage (for a
        prompted model the full-size alpha (B, H, W) its network stage
        gives)."""
        return self._run(_as_batch(imgs_u8), torch.as_tensor(mask_small))

    def _run(self, x: torch.Tensor, mask_small, boxes=None) -> PipelineOutput:
        outs = []
        for (dev, st), (b0, b1) in zip(
                self._groups, split_bounds(x.shape[0], len(self._groups))):
            if b0 == b1:  # a group past the batch's last image stays idle
                continue
            xi = to_slot(x[b0:b1], dev)
            if mask_small is not None:
                prog = refine_program(st, xi, to_slot(mask_small[b0:b1], dev))
            else:
                prog = batch_program(
                    st, network_on(self.session.module, dev, self._copies),
                    xi, None if boxes is None else to_slot(boxes[b0:b1], dev))
            outs.append(drive(prog))
        if len(outs) == 1:
            return PipelineOutput(*outs[0])
        return PipelineOutput(*(torch.cat([to_slot(o[i], self.device)
                                           for o in outs])
                                for i in range(len(outs[0]))))
