"""Device mesh construction and sharding specs.

Counterpart of image_segmenter_tpu/parallel/mesh.py. A `Mesh` is a grid of
device slots with named axes; a slot is a `torch.device`, and one device
may fill several slots (one card, or the CPU, holds a (2, 2) mesh as four
slots, as the JAX tests give the host 8 virtual devices). A `Sharding`
names the mesh axis that splits each tensor dimension: `split(x)` cuts a
tensor into one piece a slot, each on its slot's device, and `gather`
puts the pieces back together on the mesh's first slot. Splits follow
`torch.tensor_split`: uneven sizes are allowed, the first pieces one
longer.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
SPACE_AXIS = "space"


class Mesh:
    """Device slots on a grid: `devices[i, j]` is data group i, space
    slot j of a (data, space) mesh. `processes` holds the rank of the
    process that drives each slot (hybrid_mesh); a process computes only
    on its own slots."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 processes: Optional[np.ndarray] = None):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d devices for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.processes = (np.zeros(devices.shape, np.int64)
                          if processes is None else processes)

    @property
    def shape(self) -> tuple:
        return self.devices.shape

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def first(self) -> torch.device:
        """The slot outputs are gathered on."""
        return self.devices.flat[0]

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    def group(self, i: int) -> "Mesh":
        """The (1, ...) mesh of data group i (index i on the first axis)."""
        return Mesh(self.devices[i:i + 1], self.axis_names,
                    self.processes[i:i + 1])

    def __repr__(self) -> str:
        return (f"Mesh({dict(zip(self.axis_names, self.shape))}, "
                f"{[str(d) for d in self.devices.flat]})")


def device_grid(devices: Sequence, shape: Sequence[int]) -> np.ndarray:
    """An object array of `shape` holding `devices` in row-major order."""
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return arr.reshape(tuple(shape))


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = (DATA_AXIS, SPACE_AXIS),
              devices=None) -> Mesh:
    """A (data, space) mesh over `devices`, by default every CUDA device.

    shape=None puts every device on the data axis (space 1). A device may
    be listed more than once; each listing is a slot. Raises ValueError
    when the shape needs more slots than were given, and RuntimeError
    when no devices were given and CUDA has none."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device, and no devices "
                               "were given; pass devices=[...] for the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    if shape is None:
        shape = (n, 1)
    need = int(np.prod(shape))
    if need > n:
        raise ValueError(f"mesh shape {tuple(shape)} needs {need} devices, "
                         f"have {n}")
    return Mesh(device_grid(devices[:need], shape), axis_names)


def split_bounds(n: int, k: int) -> list:
    """(start, stop) of the k pieces torch.tensor_split makes of n."""
    q, r = divmod(n, k)
    out, start = [], 0
    for i in range(k):
        stop = start + q + (1 if i < r else 0)
        out.append((start, stop))
        start = stop
    return out


def same_device(a, b) -> bool:
    """Whether two device names are one device ("cuda" is the current
    card)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return a.index == b.index
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == \
        (cur if b.index is None else b.index)


def to_slot(t: torch.Tensor, device) -> torch.Tensor:
    """`t` on `device`. A copy to a card is queued on the stream
    (non_blocking); a copy to the host waits for its data, because a
    non_blocking copy from the card would hand back memory that is not
    written yet."""
    device = torch.device(device)
    return t.to(device, non_blocking=device.type == "cuda")


def take(blocks: Sequence[torch.Tensor], bounds: Sequence[tuple],
         start: int, stop: int, device, dim: int = 0) -> torch.Tensor:
    """Indices [start, stop) along `dim` of the tensor that `blocks` split
    (block j holds [bounds[j][0], bounds[j][1])), on `device`. A block
    that holds exactly that range on that device is returned as it is."""
    parts = []
    for blk, (b0, b1) in zip(blocks, bounds):
        lo, hi = max(start, b0), min(stop, b1)
        if lo >= hi:
            continue
        if (lo, hi) == (b0, b1):
            parts.append(blk)
        else:
            parts.append(blk.narrow(dim, lo - b0, hi - lo))
    parts = [to_slot(p, device) for p in parts]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


class Sharding(NamedTuple):
    """Which mesh axis splits each tensor dimension (None: not split).

    A tensor with fewer dimensions than `spec` takes its leading entries;
    a mesh axis that splits no dimension holds replicas."""
    mesh: Mesh
    spec: tuple

    def _dims(self, ndim: int) -> list:
        spec = tuple(self.spec[:ndim])
        spec += (None,) * (ndim - len(spec))
        return [(d, a) for d, a in enumerate(spec) if a is not None]

    def split(self, x: torch.Tensor) -> list:
        """Nested lists of pieces, `pieces[i][j]` for slot (i, j), each on
        its slot's device."""
        mesh = self.mesh
        dims = self._dims(x.dim())
        cuts = {a: split_bounds(x.shape[d], mesh.axis_size(a))
                for d, a in dims}

        def piece(idx):
            t = x
            for d, a in dims:
                b0, b1 = cuts[a][idx[mesh.axis_names.index(a)]]
                t = t.narrow(d, b0, b1 - b0)
            return to_slot(t, mesh.devices[idx])

        def nest(prefix):
            if len(prefix) == len(mesh.shape):
                return piece(tuple(prefix))
            return [nest(prefix + [i]) for i in range(mesh.shape[len(prefix)])]

        return nest([])

    def gather(self, pieces: list) -> torch.Tensor:
        """The tensor `split` cut into `pieces`, on the mesh's first slot
        (a replicated axis is read at index 0)."""
        mesh = self.mesh
        dev = mesh.first

        def at(idx):
            t = pieces
            for i in idx:
                t = t[i]
            return t

        def rec(fixed, dims):
            if not dims:
                return to_slot(at(tuple(fixed.get(a, 0)
                                        for a in mesh.axis_names)), dev)
            d, a = dims[0]
            parts = [rec({**fixed, a: i}, dims[1:])
                     for i in range(mesh.axis_size(a))]
            return torch.cat(parts, dim=d)

        first = at((0,) * len(mesh.shape))
        return rec({}, self._dims(first.dim()))


def batch_sharding(mesh: Mesh) -> Sharding:
    """A batch of images (N, H, W, C): N across data, H across space."""
    return Sharding(mesh, (DATA_AXIS, SPACE_AXIS, None, None))


def image_sharding(mesh: Mesh) -> Sharding:
    """A single image (H, W, C): rows across the space axis."""
    return Sharding(mesh, (SPACE_AXIS, None, None))


def replicated(mesh: Mesh) -> Sharding:
    """A copy on every slot."""
    return Sharding(mesh, ())
