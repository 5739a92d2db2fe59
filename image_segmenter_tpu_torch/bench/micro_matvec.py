"""Microbench: the CG matvec L @ p in its four forms.

Counterpart of the repo's bench/micro_matvec.py (the JAX package's XLA
stencil against its Pallas matvec variants). Here: the plain PyTorch
formulation (`laplacian_matvec_plain`, packed factors), K3
(`matvec_planes`, reads K2's planes), K5 (`matvec_stack`, reads the padded
13-plane stack) and K6 (`kernels.matting.matvec_planes`, recomputes the
window means from 10 planes). On a CPU tensor each kernel's wrapper takes
its plain version, so a CPU run checks the plumbing only.

Protocol, as in the JAX bench: the output is fed back, q <- q + 1e-6 L q,
`inner` times, so nothing is dead and the iterate stays bounded; the loop
is timed as a whole (CUDA events on the card, the host clock on the CPU)
after one warm-up matvec, and each variant's final q is compared with the
plain loop's (the drift). At one small image that loop is bound by the host
(three launches an iteration), so each form is also timed over `LAUNCHES`
matvecs of one q back to back, median of `REPS`: the kernel's own time.
K6's form pads q and slices its output; its row also holds K6 alone on an
operand padded once (back to back, whether it has the plain version's
bits, and the sha256 of its output). The script calls the kernels' public
entry points only, so one copy of it times any tree of the package
(PYTHONPATH set to each in turn, in one call).
The TPU tile sweeps of the JAX bench are TPU
schedule and have no counterpart.

    python -m image_segmenter_tpu_torch.bench.micro_matvec [cuda|cpu] [H W]
"""

from __future__ import annotations

import hashlib
import statistics
import sys
import time

import numpy as np
import torch

from image_segmenter_tpu_torch.kernels import matting as K6
from image_segmenter_tpu_torch.kernels import matvec as KMV
from image_segmenter_tpu_torch.kernels import precompute as KP
from image_segmenter_tpu_torch.utils.backend import resolve_device


LAUNCHES = 20   # back to back between two events
REPS = 10


def setup(device, b: int, h: int, w: int, seed: int = 0):
    """Seeded operands: images and p from numpy, K2's planes, K5's stack
    and K6's static planes."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    imgs = torch.from_numpy(rng.random((b, h, w, 3), dtype=np.float32)) \
        .permute(0, 3, 1, 2).contiguous().to(dev)
    ps = torch.from_numpy(
        rng.standard_normal((b, h, w)).astype(np.float32)).to(dev)
    planes = KP.precompute_planes(imgs, 1e-7)
    stack = KMV.build_matvec_stack_planes(imgs, planes)
    ones = torch.ones((b, h, w), dtype=torch.float32, device=dev)
    static = K6.pack_static(ones, imgs, planes[:, 0:6])
    return imgs, ps, planes, stack, static


def variants(imgs, planes, stack, static):
    """name -> matvec(q) for the four forms on the same operands."""
    h, w = imgs.shape[2:]
    n, mu, ldl = planes[:, 7], planes[:, 8:11], planes[:, 0:6]
    return {
        "plain": lambda q: KMV.laplacian_matvec_plain(imgs, n, mu, ldl, q),
        "K3 matvec_planes": lambda q: KMV.matvec_planes(planes, imgs, q),
        "K5 matvec_stack": lambda q: KMV.matvec_stack(stack, q),
        "K6 matvec_recompute":
            lambda q: K6.matvec_planes(K6.pad_p(q), static)[:, :h, :w],
    }


def _loop(mv, q: torch.Tensor, inner: int):
    """(final q, ms per matvec) of `inner` fed-back matvecs."""
    on_card = q.is_cuda
    mv(q)  # warm-up: builds the library, fills caches
    if on_card:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
    else:
        t0 = time.perf_counter()
    for _ in range(inner):
        q = q + 1e-6 * mv(q)
    if on_card:
        e1.record()
        e1.synchronize()
        ms = e0.elapsed_time(e1)
    else:
        ms = (time.perf_counter() - t0) * 1e3
    return q, ms / inner


def _back_to_back(mv, q: torch.Tensor) -> float:
    """ms per matvec of `LAUNCHES` calls on one q, median of `REPS`."""
    times = []
    for _ in range(REPS):
        if q.is_cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
        else:
            t0 = time.perf_counter()
        for _ in range(LAUNCHES):
            mv(q)
        if q.is_cuda:
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1) / LAUNCHES)
        else:
            times.append((time.perf_counter() - t0) * 1e3 / LAUNCHES)
    return statistics.median(times)


def run(device="cuda", b: int = 4, h: int = 576, w: int = 1024,
        inner: int = 50) -> list:
    """One row per variant: {"name", "ms_per_matvec", "ms_back_to_back",
    "drift"}; drift is max|q - q_plain| / max|q_plain| after `inner`
    fed-back matvecs. K6's row also has "ms_kernel_back_to_back",
    "kernel_bit_equal" and "kernel_sha" (`recompute_alone`)."""
    imgs, ps, planes, stack, static = setup(device, b, h, w)
    rows, ref = [], None
    for name, mv in variants(imgs, planes, stack, static).items():
        out, ms = _loop(mv, ps, inner)
        if ref is None:
            ref = out
        drift = float((out - ref).abs().max() / (ref.abs().max() + 1e-30))
        rows.append({"name": name, "ms_per_matvec": ms, "drift": drift,
                     "ms_back_to_back": _back_to_back(mv, ps)})
    rows[-1].update(recompute_alone(ps, static))
    return rows


def recompute_alone(ps: torch.Tensor, static: torch.Tensor) -> dict:
    """K6 alone on an operand padded once: its time back to back, whether
    it gives the plain version's bits, and the sha256 of its output."""
    p_pad = K6.pad_p(ps)
    out = K6.matvec_planes(p_pad, static)
    same = torch.equal(out, K6.matvec_planes_plain(p_pad, static))
    return {"ms_kernel_back_to_back": _back_to_back(
                lambda q: K6.matvec_planes(q, static), p_pad),
            "kernel_bit_equal": bool(same),
            "kernel_sha": hashlib.sha256(
                out.cpu().numpy().tobytes()).hexdigest()[:16]}


def main(argv) -> None:
    device = argv[1] if len(argv) > 1 else "cuda"
    h, w = (int(v) for v in argv[2:4]) if len(argv) > 3 else (576, 1024)
    for b in (1, 4):
        for row in run(device, b=b, h=h, w=w):
            alone = ""
            if "ms_kernel_back_to_back" in row:
                alone = (f"; alone {row['ms_kernel_back_to_back']:8.4f} back "
                         f"to back, plain's bits {row['kernel_bit_equal']}, "
                         f"sha {row['kernel_sha']}")
            print(f"{row['name']:24s} {b}x{h}x{w} {row['ms_per_matvec']:8.4f} "
                  f"ms/matvec fed back, {row['ms_back_to_back']:8.4f} back to "
                  f"back  50-iter drift vs plain {row['drift']:.2e}{alone}",
                  flush=True)
    print(f"package {K6.__file__}", file=sys.stderr, flush=True)


if __name__ == "__main__":
    main(sys.argv)
