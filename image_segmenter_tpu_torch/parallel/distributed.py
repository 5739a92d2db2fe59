"""Multi-process initialization, the hybrid mesh and the cross-process sum.

Counterpart of image_segmenter_tpu/parallel/distributed.py, which joins
processes into one JAX runtime. Here the processes form a
`torch.distributed` process group. `hybrid_mesh()` lays the (data, space)
axes out so that the data axis (independent images; in training, the
gradient sum) is the one that crosses processes, while every space group
stays inside one process, whose controller exchanges its halo rows and
adds its partial sums. The helpers work in a single process too: there
`initialize` does nothing and `all_reduce_sum` returns its input.

Backend: NCCL when each rank of this host has a GPU of its own, else
gloo. gloo sums host tensors, so `all_reduce_sum` copies a card tensor
to the host, sums it there and copies it back. That is the design for
ranks that share a card (NCCL refuses two ranks on one GPU), not a
fallback from a failed NCCL call.
"""

from __future__ import annotations

import os
import queue
import socket
import time
import traceback
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from image_segmenter_tpu_torch.parallel.mesh import DATA_AXIS, SPACE_AXIS, \
    Mesh, device_grid, make_mesh


def default_backend(world_size: int) -> str:
    """nccl when every rank of this host can have a GPU of its own, else
    gloo. The ranks of this host are LOCAL_WORLD_SIZE when it is set (as
    torchrun sets it), else the whole world."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if torch.cuda.is_available() and torch.cuda.device_count() >= local:
        return "nccl"
    return "gloo"


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Join (or start) the process group.

    The arguments fall back to the standard variables MASTER_ADDR and
    MASTER_PORT (as tcp://ADDR:PORT), WORLD_SIZE and RANK. A single process
    (no address and a world of at most one) returns without touching
    anything, as does a process already in a group."""
    if dist.is_initialized():
        return
    if world_size is None and os.environ.get("WORLD_SIZE"):
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and os.environ.get("RANK"):
        rank = int(os.environ["RANK"])
    if init_method is None and os.environ.get("MASTER_ADDR"):
        init_method = (f"tcp://{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    if init_method is None and world_size in (None, 1):
        return  # single process: nothing to initialize
    if world_size is None or rank is None:
        raise ValueError("initialize: world_size and rank are needed "
                         "(arguments or WORLD_SIZE and RANK)")
    dist.init_process_group(backend or default_backend(world_size),
                            init_method=init_method or "env://",
                            world_size=world_size, rank=rank)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_multi_host() -> bool:
    return process_count() > 1


def hybrid_mesh(ici_shape: Optional[Sequence[int]] = None,
                dcn_shape: Optional[Sequence[int]] = None,
                axis_names: Sequence[str] = (DATA_AXIS, SPACE_AXIS),
                devices=None) -> Mesh:
    """The global (data, space) mesh with processes tiling the data axis.

    ici_shape: the mesh of one process's slots, by default (its devices,
      1); devices: those slots, by default every CUDA device.
    dcn_shape: how the processes tile the axes, by default (processes, 1).

    Every process lists the same slot names for its own slots, so the
    mesh names another process's slots by the devices of this one; its
    `processes` array says which rank drives each slot, and a rank
    computes only on its own rows of the mesh (`local_mesh`)."""
    n_proc = process_count()
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("hybrid_mesh: no CUDA device, and no devices "
                               "were given")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if ici_shape is None:
        ici_shape = (len(devices), 1)
    if dcn_shape is None:
        dcn_shape = (n_proc, 1)
    ici_shape, dcn_shape = tuple(ici_shape), tuple(dcn_shape)
    if n_proc == 1:
        # no process boundary: one contiguous mesh, as the JAX package does
        shape = tuple(int(i * d) for i, d in zip(ici_shape, dcn_shape))
        return make_mesh(shape, axis_names, devices)
    if int(np.prod(dcn_shape)) != n_proc or dcn_shape[1:] != (1,) * (
            len(dcn_shape) - 1):
        raise ValueError(f"dcn_shape {dcn_shape}: the processes ({n_proc}) "
                         "must tile the leading (data) axis only")
    need = int(np.prod(ici_shape))
    if need > len(devices):
        raise ValueError(f"ici_shape {ici_shape} needs {need} devices per "
                         f"process, have {len(devices)}")
    local = device_grid(devices[:need], ici_shape)
    grid = np.concatenate([local] * n_proc, axis=0)
    procs = np.repeat(np.arange(n_proc), ici_shape[0])
    procs = np.broadcast_to(procs.reshape((-1,) + (1,) * (len(ici_shape) - 1)),
                            grid.shape).copy()
    return Mesh(grid, axis_names, procs)


def local_mesh(mesh: Mesh) -> Mesh:
    """The rows of `mesh` that this process drives."""
    rows = np.nonzero(mesh.processes[:, 0] == process_index())[0]
    return Mesh(mesh.devices[rows], mesh.axis_names, mesh.processes[rows])


def _backend() -> str:
    return dist.get_backend() if dist.is_initialized() else ""


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum `t` over every process, in place; returns `t`. Under NCCL the
    sum runs on the device; under gloo a card tensor is copied to the
    host, summed there and copied back. A single process returns `t`."""
    if process_count() == 1:
        return t
    if t.is_cuda and _backend() != "nccl":
        host = t.cpu()
        dist.all_reduce(host)
        t.copy_(host)
    else:
        dist.all_reduce(t)
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum over the processes; the gradient of each process's input is the
    sum of the processes' gradients at the output."""

    @staticmethod
    def forward(ctx, t):
        return all_reduce_sum(t.clone())

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad.clone())


def all_reduce_sum_grad(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over every process, differentiable: the gradient of
    each process's input is the sum of the gradients at the output (what
    torch.distributed.nn.functional.all_reduce does, through
    `all_reduce_sum`, so a card tensor under gloo goes through the host
    both ways). A single process returns `t`."""
    if process_count() == 1:
        return t
    return _AllReduceSum.apply(t)


def free_port() -> int:
    """A free TCP port on localhost for a process group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world_size, init_method, backend, args, out) -> None:
    try:
        initialize(init_method, world_size, rank, backend)
        try:
            out.put((rank, True, fn(rank, world_size, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        out.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world_size: int, args: tuple = (),
              backend: Optional[str] = None, timeout: float = 600.0) -> list:
    """fn(rank, world_size, *args) in `world_size` new processes that form
    one process group on localhost; their return values in rank order.

    fn must be a module-level function (the processes are spawned, not
    forked, so CUDA state is never shared) and its result picklable.
    Raises RuntimeError when a rank raises or the time runs out; every
    process is stopped before it returns."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    init_method = f"tcp://localhost:{free_port()}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, init_method, backend, args,
                               out))
             for r in range(world_size)]
    for p in procs:
        p.start()
    results, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world_size and not errors:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue.Empty:
                # a rank that died before it could report (in its start-up,
                # or killed) never will
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    errors.append(f"ranks {dead} exited with codes "
                                  f"{[procs[r].exitcode for r in dead]} "
                                  "before they reported")
                elif time.monotonic() > deadline:
                    errors.append(f"no result from every rank within "
                                  f"{timeout} s")
                continue
            if ok:
                results[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
    finally:
        for p in procs:
            p.join(timeout=5 if not errors else 0.1)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("run_ranks: " + "\n".join(errors))
    return [results[r] for r in range(world_size)]
