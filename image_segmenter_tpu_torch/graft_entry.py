"""Entry points of the port: a forward step and the multi-slot dry run.

Counterpart of the repository's __graft_entry__.py (JAX). `entry()` gives
U^2-Netp's forward at 320 x 320 with seeded weights; `dryrun_multichip(n)`
runs the sharded paths on n slots at small shapes (n cards where the host
has them, else n slots of one device) and holds each against its
unsharded run, with the JAX dry run's contracts:

1. `Pipeline` sharded dp x sp against one slot, on distinct images: per
   image at most 10 % of the boundary band's alpha flips and none off it,
   and a quantization error within 5 % + 5 of the one-slot run's;
2. the full-resolution refine split over the rows of a (1, n) mesh
   against the unsplit one: under 1 % of pixels differ, by at most 2;
3. `sharded_stencil` of a 3-row blur against the dense blur, to 1e-6;
4. `shard_train_step` over 2 processes on a (2, 1) mesh (whole rows, a
   slot a process) and on a (2, 2) mesh (each image's rows split over a
   process's 2 space slots, the JAX dry run's (dp, 2)), and in one
   process over (1, 2) and (2, 2), against the one-slot step:
   loss within 1e-4 relative, the parameters the JAX check holds within
   1e-4 (`HELD_PARAMS`; every other parameter's gap is reported), and
   every parameter moved;
5. `StagedPipeline` against the one-slot run, under check 1's contract.

Run: python -m image_segmenter_tpu_torch.graft_entry N [--device cpu]
(the card by default).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from image_segmenter_tpu_torch.models.registry import _seeded_init
from image_segmenter_tpu_torch.models.u2net import U2NET
from image_segmenter_tpu_torch.utils.backend import resolve_device


def entry(device="cuda"):
    """(fn, example_args): U^2-Netp's forward at its native 320 x 320 from
    seeded weights, the hot CNN of the background-removal stage."""
    dev = resolve_device(device)
    module = U2NET(small=True)
    _seeded_init(module, 0)
    module = module.to(dev).eval()

    @torch.no_grad()
    def fn(module, x):
        return module(x)[0]

    return fn, (module, torch.ones((1, 3, 320, 320), device=dev))


def distinct_images(b: int, h: int = 64, w: int = 64, seed: int = 0):
    """b photo-like (H, W, 3) uint8 images, each with its own frequencies,
    phases and noise, so that a permuted or mixed batch shows."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    imgs = np.empty((b, h, w, 3), np.uint8)
    for i in range(b):
        base = np.stack([
            127 + 90 * np.sin(xx / (13 + 2 * i) + i),
            127 + 90 * np.cos(yy / (9 + i) + 2 * i),
            127 + 90 * np.sin((xx + yy) / (17 + 3 * i)),
        ], axis=-1)
        imgs[i] = np.clip(base + rng.normal(0, 6, base.shape), 0, 255)
    return imgs


def _require(ok, msg) -> None:
    """A check of the dry run: raises AssertionError, also under -O."""
    if not ok:
        raise AssertionError(msg)


def _grow(m: np.ndarray, r: int) -> np.ndarray:
    """4-neighbour dilation by r of (B, H, W) masks, zero-padded (a wrapped
    dilation would let a fault at an edge hide in the band)."""
    for _ in range(r):
        p = np.pad(m, ((0, 0), (1, 1), (1, 1)))
        m = (m | p[:, :-2, 1:-1] | p[:, 2:, 1:-1]
             | p[:, 1:-1, :-2] | p[:, 1:-1, 2:])
    return m


def band_contract(rgba: np.ndarray, ref: np.ndarray, imgs: np.ndarray,
                  what: str):
    """Hold a run's (B, H, W, 4) output to a reference run of the same
    images: per image at most 10 % of the boundary band (within 3 pixels
    of the reference mask's edge) flips alpha and nothing off the band
    does; each run's quantization error over its own mask within 5 % + 5
    of the reference's. Returns (alpha agreement, [(err, err_ref)]);
    raises AssertionError naming `what`."""
    mask = ref[..., 3] > 0
    band = _grow(mask, 3) & _grow(~mask, 3)
    flips = rgba[..., 3] != ref[..., 3]
    off = flips & ~band
    _require(not off.any(), f"{what}: {int(off.sum())} alpha flips off the "
             "band")
    for i in range(len(imgs)):
        n, bp = int(flips[i].sum()), int(band[i].sum())
        _require(n <= 0.1 * bp, f"{what}: image {i}: {n} flips, band {bp}")
    qerr = []
    for i in range(len(imgs)):
        nt_a, nt_c = rgba[i, ..., 3] > 0, ref[i, ..., 3] > 0
        if not (nt_a.any() and nt_c.any()):
            continue
        e_a = float(((rgba[i, ..., :3].astype(float) - imgs[i]) ** 2)[nt_a]
                    .mean())
        e_c = float(((ref[i, ..., :3].astype(float) - imgs[i]) ** 2)[nt_c]
                    .mean())
        _require(abs(e_a - e_c) <= 0.05 * e_c + 5.0,
                 f"{what}: image {i}: quantization error {e_a} against "
                 f"{e_c}")
        qerr.append((e_a, e_c))
    return 1.0 - float(flips.mean()), qerr


def train_batch(b: int, hw: int, seed: int = 0):
    """Standard-normal (B, 3, hw, hw) images and coin-flip masks."""
    rng = np.random.default_rng(seed)
    imgs = rng.normal(0, 1, (b, 3, hw, hw)).astype(np.float32)
    masks = (rng.random((b, hw, hw)) > 0.5).astype(np.float32)
    return torch.from_numpy(imgs), torch.from_numpy(masks)


# The parameters check 4 holds to 1e-4: the fuse conv, the leaf the JAX
# dry run holds (the first of its parameter tree). Every other parameter is
# reported. At 32 x 32 the innermost BatchNorms normalise 4 numbers, where
# float32 E[y^2] - E[y]^2 cancels: two float32 summation orders then give
# gradients some 10 % apart on many tensors, and Adam's first step, about
# -lr * sign(g), moves a near-zero entry by 2e-3 between them. In float64
# the two steps' gradients agree to 1e-10 (tests/test_torch_distributed.py).
HELD_PARAMS = ("outconv.weight", "outconv.bias")


def spread(n: int, dev: torch.device) -> list:
    """n slots: n distinct cards where `dev` is "cuda" (no index) and the
    host has n, else n slots of `dev`."""
    if dev.type == "cuda" and dev.index is None \
            and torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [dev] * n


# The layouts of check 4's ranks, by their space size: whole rows on one
# slot a rank (data parallel), and rows over two slots (the JAX dry run's).
RANK_SPACES = (1, 2)


def rank_slots(rank: int, world: int, space: int,
               dev: torch.device) -> list:
    """The `space` slots of a rank: distinct cards where `spread` finds
    space x world of them (card `rank` first, the rank's card in every
    layout), else `space` slots of the rank's device."""
    cards = spread(space * world, dev)
    if len(set(cards)) == space * world:
        return cards[rank::world]
    return [spread(world, dev)[rank]] * space


def _run_steps(fn, state, imgs, masks, steps: int, dev: torch.device):
    """(state after the first step, losses, ms a step) of `steps` steps
    of fn from `state`."""
    first, losses, walls = None, [], []
    for _ in range(steps):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, loss = fn(state, imgs, masks)
        losses.append(float(loss))
        walls.append((time.perf_counter() - t0) * 1e3)
        first = state if first is None else first
    return first, losses, walls


def _train_gaps(state0, first_sh, loss_sh, first_1, loss_1) -> dict:
    """How a sharded run of steps from `state0` stands against the
    one-slot run: the loss gap of each step, and after the first step
    the parameters' gaps (later steps start from states that differ by
    those gaps) and the least move of any parameter."""
    diff = {k: (v - first_1.params[k]).abs()
            for k, v in first_sh.params.items()}
    return dict(
        loss_gaps=[abs(a - c) / max(abs(c), 1e-9)
                   for a, c in zip(loss_sh, loss_1)],
        held_maxdiff=max(float(diff[k].max()) for k in HELD_PARAMS),
        param_maxdiff=max(float(d.max()) for d in diff.values()),
        params_over=sum(int((d > 1e-4).sum()) for d in diff.values()),
        params_total=sum(d.numel() for d in diff.values()),
        moved=min(float((v - state0.params[k]).abs().max())
                  for k, v in first_sh.params.items()),
        steps=int(first_sh.step))


def _hold(r: dict, what: str) -> None:
    """Check 4's contracts on `_train_gaps`' report of step 1."""
    _require(np.isfinite(r["loss"][0]) and r["steps"] == 1, r)
    _require(r["loss_gaps"][0] < 1e-4, f"{what}: train loss diverged: {r}")
    _require(r["moved"] > 0, f"{what}: a parameter did not move: {r}")
    _require(r["held_maxdiff"] <= 1e-4, f"{what}: params diverged: {r}")


def train_rank(rank: int, world: int, device: str, b: int, hw: int,
               steps: int = 1, threads: int = 0) -> dict:
    """One rank of check 4 (run by parallel/distributed.run_ranks): for
    each space size of `RANK_SPACES`, `steps` steps of U^2-Netp on the
    seeded batch over a (world, space) mesh, this rank's images on its
    slots (`rank_slots`); rank 0 then takes the same steps in one process
    on one slot and compares (`_train_gaps`). Returns by space size the
    losses, the ms of each sharded step and the slots and, on rank 0, the
    gaps."""
    from image_segmenter_tpu_torch.parallel import distributed as D
    from image_segmenter_tpu_torch.pipeline import train as TR

    if threads:
        torch.set_num_threads(threads)
    dev = rank_slots(rank, world, 1, resolve_device(device))[0]
    if dev.index is not None:  # a card of its own: NCCL works on it
        torch.cuda.set_device(dev)
    module = U2NET(small=True).to(dev)
    tx, state0 = TR.create_train_state(module, seed=0, input_hw=(hw, hw))
    step = TR.make_train_step(module, tx)
    imgs, masks = (t.to(dev) for t in train_batch(b, hw))
    out, firsts = {}, {}
    for space in RANK_SPACES:
        slots = rank_slots(rank, world, space, resolve_device(device))
        mesh = D.hybrid_mesh((1, space), (world, 1), devices=slots)
        firsts[space], loss, walls = _run_steps(
            TR.shard_train_step(step, mesh), state0, imgs, masks, steps, dev)
        out[space] = {"loss": loss, "ms": walls,
                      "slots": [str(d) for d in slots],
                      "backend": torch.distributed.get_backend()}
    if rank == 0:
        first_1, loss_1, walls_1 = _run_steps(step, state0, imgs, masks,
                                              steps, dev)
        for space, r in out.items():
            r.update(loss_1=loss_1, ms_1=walls_1, **_train_gaps(
                state0, firsts[space], r["loss"], first_1, loss_1))
    return out


def check_train(device: str, b: int, hw: int, steps: int = 1,
                threads: int = 0) -> dict:
    """Check 4 over processes: rank 0's reports of `train_rank` over 2
    processes (on a card each under NCCL where the host has two, else
    gloo) by space size, each held to check 4's contracts, both ranks
    reporting the same losses."""
    from image_segmenter_tpu_torch.parallel.distributed import run_ranks

    res = run_ranks(train_rank, 2, args=(device, b, hw, steps, threads),
                    timeout=900)
    for space, r0 in res[0].items():
        _require(res[1][space]["loss"] == r0["loss"], f"ranks disagree on "
                 f"the loss over {space} space slot(s): {res}")
        _hold(r0, f"2 ranks x {space} space slot(s)")
    return res[0]


def check_train_one_process(device: str, b: int, hw: int,
                            shapes=((1, 2), (2, 2))) -> dict:
    """Check 4 in one process: one step of `shard_train_step` over each
    mesh shape (distinct cards where `spread` finds them) against the
    one-slot step, held to check 4's contracts; the reports by shape."""
    from image_segmenter_tpu_torch.parallel import mesh as PM
    from image_segmenter_tpu_torch.pipeline import train as TR

    dev = resolve_device(device)
    module = U2NET(small=True).to(dev)
    tx, state0 = TR.create_train_state(module, seed=0, input_hw=(hw, hw))
    step = TR.make_train_step(module, tx)
    imgs, masks = (t.to(dev) for t in train_batch(b, hw))
    first_1, loss_1, _ = _run_steps(step, state0, imgs, masks, 1, dev)
    out = {}
    for shape in shapes:
        mesh = PM.make_mesh(shape, devices=spread(shape[0] * shape[1], dev))
        first, loss, walls = _run_steps(TR.shard_train_step(step, mesh),
                                        state0, imgs, masks, 1, dev)
        out[shape] = dict(loss=loss, ms=walls, **_train_gaps(
            state0, first, loss, first_1, loss_1))
        _hold(out[shape], f"one process, mesh {shape}")
    return out


def dryrun_multichip(n_slots: int, device="cuda") -> str:
    """Run the sharded paths on `n_slots` slots (`spread`) at tiny shapes
    against their one-slot runs (the module docstring lists the checks);
    prints and returns one summary line, raises AssertionError on a
    failed check."""
    from image_segmenter_tpu_torch.compat.matting_refine import \
        refine_alpha_portrait_full_res
    from image_segmenter_tpu_torch.parallel import mesh as PM
    from image_segmenter_tpu_torch.parallel.halo import sharded_stencil
    from image_segmenter_tpu_torch.pipeline.segment import Pipeline
    from image_segmenter_tpu_torch.pipeline.staged import StagedPipeline, \
        split_stage_meshes

    dev = resolve_device(device)
    slots = spread(n_slots, dev)
    rng = np.random.default_rng(0)

    # 1. the main path, dp x sp, against one slot
    sp = 2 if n_slots % 2 == 0 else 1
    dp = n_slots // sp
    mesh = PM.make_mesh((dp, sp), devices=slots)
    b = max(dp, 2)
    imgs = distinct_images(b)
    out_sh = Pipeline(model="u2netp", k=4, cg_iters=20,
                      sharding=PM.batch_sharding(mesh)).run(imgs)
    out_1 = Pipeline(model="u2netp", k=4, cg_iters=20,
                     device=slots[0]).run(imgs)
    ref = out_1.rgba.cpu().numpy()
    agree, qerr = band_contract(out_sh.rgba.cpu().numpy(), ref, imgs,
                                "sharded pipeline")

    # 2. the full-resolution refine, rows split over (1, n)
    smesh = PM.make_mesh((1, n_slots), devices=slots)
    h, w = 8 * n_slots, 48
    rgb = np.zeros((h, w, 3), np.uint8)
    rgb[:, : w // 2] = [200, 50, 50]
    rgb[:, w // 2:] = [30, 30, 180]
    alpha0 = np.zeros((h, w), np.uint8)
    alpha0[:, : w // 2] = 255
    m_sh = refine_alpha_portrait_full_res(rgb, alpha0, None, mesh=smesh)
    m_1 = refine_alpha_portrait_full_res(rgb, alpha0, None, device=slots[0])
    d = np.abs(m_sh.astype(int) - m_1.astype(int))
    mat_disagree, mat_maxdiff = float((d != 0).mean()), int(d.max())
    _require(mat_disagree < 0.01 and mat_maxdiff <= 2,
             f"sharded refine: {mat_disagree} of pixels differ, max "
             f"{mat_maxdiff}")

    # 3. the halo-exchange stencil against the dense one
    def blur3(x):  # 3-row box blur, zero boundary
        up = torch.cat([x[:1] * 0, x[:-1]])
        dn = torch.cat([x[1:], x[-1:] * 0])
        return (up + x + dn) / 3.0

    x = torch.from_numpy(rng.random((8 * n_slots, 16, 3)).astype(np.float32))
    y = sharded_stencil(blur3, halo=1, mesh=smesh)(x.to(slots[0]))
    stencil_err = float((y.cpu() - blur3(x)).abs().max())
    _require(stencil_err <= 1e-6, f"halo stencil error {stencil_err}")

    # 4. the training step: 2 processes x 1 and 2 space slots, and one
    # process
    tr = check_train(str(dev), 4, 32, threads=2 if dev.type == "cpu" else 0)
    tr1 = check_train_one_process(str(dev), 4, 32)

    # 5. the stages on their own sub-meshes against the one-slot run
    staged_line = "staged: skipped (needs >= 3 slots)"
    if n_slots >= 3:
        spipe = StagedPipeline(model="u2netp", k=4, cg_iters=20,
                               meshes=split_stage_meshes(slots),
                               device=slots[0])
        st_agree, _ = band_contract(spipe.run(imgs).rgba.cpu().numpy(), ref,
                                    imgs, "staged pipeline")
        staged_line = (f"staged==fused (alpha agreement={st_agree:.4f}, "
                       f"flips boundary-band-only)")

    cards = sorted({str(d) for d in slots})
    line = (f"dryrun_multichip OK: {n_slots} slots on {', '.join(cards)}, "
            f"mesh dp={dp} "
            f"sp={sp} | pipeline alpha agreement={agree:.4f} (flips "
            f"boundary-band-only), quant err sharded/single="
            f"{[(round(a, 2), round(c, 2)) for a, c in qerr]} | sharded "
            f"matting agreement={1 - mat_disagree:.4f} (max |diff|="
            f"{mat_maxdiff}) | halo stencil max err {stencil_err:.1e} | "
            f"train step loss={tr[1]['loss'][0]:.4f} ("
            + "; ".join(
                f"2 {r['backend']} ranks x {sp} space "
                f"slot{'s' if sp > 1 else ''} on {', '.join(r['slots'])} / "
                f"one slot gap {r['loss_gaps'][0]:.1e}, fuse conv max |diff| "
                f"{r['held_maxdiff']:.1e}, {r['params_over']} of "
                f"{r['params_total']} parameters over 1e-4"
                for sp, r in tr.items())
            + "; one process "
            + ", ".join(f"{s} gap {r['loss_gaps'][0]:.1e}"
                        for s, r in tr1.items())
            + f") | {staged_line}")
    print(line)
    return line


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_slots", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_slots, device=args.device)


if __name__ == "__main__":
    main()
