"""The matting CG's iteration outside K3, as three kernels.

Replaces no TPU kernel: the JAX package leaves the CG's vector algebra to
XLA, which fuses it around its Pallas matvec. In the port it ran as
solvers/matting.CGLoop._body, about 70 PyTorch launches an iteration.
`CGLoop` takes these kernels for an unsplit float32 solve on the card;
an iteration is then K3 and the three below, in this order:

- `cg_dot`: y = L q + (lam C) q in place of K3's L q, and p.y and p.p;
- `cg_advance`: the step from p.y and p.p, x and r of the images that
  advance, r = b - y of those that restart, and r.z and r.r with
  z = m_inv r (the Jacobi preconditioner);
- `cg_direction`: beta, p, the operand q of the next K3 (x where the next
  iteration restarts, else p), and the new scalar state (rz, pending, it,
  active: `State`), with the stop test of `CGLoop._cond`; at a chunk's
  end also the loop's flag.

An image's sum needs all of its blocks, so it ends a kernel: each block
writes float64 partial sums (`partials`), and every block of the next
kernel folds its image's partials in a fixed order and rounds once to
float32, as `_bsum` does. `cg_direction` reads one `State` and writes
another: the caller alternates two. An image no longer active is
skipped, and keeps its state. csrc/cg_update.cu says what bounds the
kernels (device memory, 17 float32 planes an iteration that advances)
and why the bits are `_body`'s, which is the kernels' plain version: the
CPU runs `_body` (`update_path`), so the wrappers take card tensors only.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from image_segmenter_tpu_torch.kernels import _build

LAUNCHES = 0  # launches of the three kernels in this process

THREADS = 256  # a block of each kernel
ITEMS = 4      # pixels a thread
TILE = THREADS * ITEMS


class State(NamedTuple):
    """The CG's per-image scalar state, (B,) tensors."""
    rz: torch.Tensor       # float32 r.z
    pending: torch.Tensor  # bool: the next iteration restarts
    it: torch.Tensor       # int32 iterations run
    active: torch.Tensor   # bool


def blocks(hw: int) -> int:
    """Blocks an image of `hw` pixels takes in each kernel's grid."""
    return max(1, -(-hw // TILE))


def partials(b: int, hw: int, device) -> torch.Tensor:
    """Scratch for a kernel's float64 partial sums, two a block:
    (B, blocks, 2)."""
    return torch.empty((b, blocks(hw), 2), dtype=torch.float64,
                       device=device)


def _check(fields, *parts) -> tuple:
    """(B, H * W, blocks) of (B, H, W) float32 fields on one card, all
    contiguous, and partials buffers that fit them."""
    b, h, w = fields[0].shape
    for t in fields:
        if (t.shape != (b, h, w) or t.dtype != torch.float32
                or not t.is_cuda or not t.is_contiguous()):
            raise ValueError("the CG update takes contiguous (B, H, W) "
                             "float32 fields on the card; got "
                             f"{tuple(t.shape)} {t.dtype} {t.device}")
    nblk = blocks(h * w)
    for part in parts:
        if part.shape != (b, nblk, 2) or part.dtype != torch.float64:
            raise ValueError(f"partials {tuple(part.shape)} {part.dtype} "
                             f"do not fit a ({b}, {h}, {w}) field")
    return b, h * w, nblk


def _launch(entry: str, *args) -> None:
    global LAUNCHES
    dev = args[0].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    # the C entry launches on the current device, which must own the stream
    with torch.cuda.device(dev):
        rc = getattr(_build.library(), entry)(*ptrs, stream)
    _build.check(rc, entry)
    LAUNCHES += 1


def cg_dot(lq: torch.Tensor, q: torch.Tensor, known: torch.Tensor,
           p: torch.Tensor, active: torch.Tensor, lam: float,
           part1: torch.Tensor) -> None:
    """y = lq + (lam * known) * q written over lq (K3's L q), and the
    partials of p.y and p.p, for the active images."""
    b, hw, nblk = _check((lq, q, known, p), part1)
    _launch("iseg_cg_dot", lq, q, known, p, active, b, hw, nblk, lam, part1)


def cg_advance(y: torch.Tensor, rhs: torch.Tensor, m_inv: torch.Tensor,
               x: torch.Tensor, r: torch.Tensor, p: torch.Tensor,
               part1: torch.Tensor, state: State,
               part2: torch.Tensor) -> None:
    """x and r of the active images in place (x + step p and r - step y
    where they advance, r = rhs - y where they restart), and the partials
    of r.z and r.r, z = m_inv r."""
    b, hw, nblk = _check((y, rhs, m_inv, x, r, p), part1, part2)
    _launch("iseg_cg_advance", y, rhs, m_inv, x, r, p, part1, state.rz,
            state.pending, state.active, b, hw, nblk, part2)


def cg_direction(m_inv: torch.Tensor, r: torch.Tensor, x: torch.Tensor,
                 p: torch.Tensor, q: Optional[torch.Tensor],
                 part1: torch.Tensor, part2: torch.Tensor, state: State,
                 new: State, bnorm: torch.Tensor, rtol: float, max_iter: int,
                 flag: Optional[torch.Tensor] = None) -> None:
    """p of the active images in place (m_inv r + beta p where they
    restarted or advanced), q (None: not needed) for the next K3, and the
    scalar state after the iteration into `new`; `flag`, where given,
    becomes whether any image is still active."""
    fields = (m_inv, r, x, p) if q is None else (m_inv, r, x, p, q)
    b, hw, nblk = _check(fields, part1, part2)
    _launch("iseg_cg_direction", m_inv, r, x, p, 0 if q is None else q,
            part1, part2, *state, *new, bnorm, rtol, max_iter, b, hw, nblk,
            0 if flag is None else flag)
