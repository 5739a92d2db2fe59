"""Compiled programs: one program a shape, replayed from CUDA graphs.

Counterpart of the JAX package's `jax.jit`: the JAX `Pipeline` compiles
its batch function once per input shape (image_segmenter_tpu/pipeline/
segment.py:307-352), and GrabCut its init, one alternation, the
standardized energy and the split candidates (image_segmenter_tpu/
solvers/grabcut.py:246-383); each enqueues with no host read, its loops
(the matting CG, the Lloyd iterations, the Chambolle-Pock cut) running
on the device as `lax.while_loop`s.

Here a program is a generator function of its static input tensors that
yields each loop it reaches and returns a tuple of tensors
(utils/loops.py). `Compiled` is one program for one tuple of input
shapes, run as CUDA graphs. At its first call it runs the program
eagerly with each loop stepped once (`utils.loops.warm_up`), on the
device's capture stream, as `torch.cuda.graph` requires: the cuDNN and
cuBLAS handles and workspaces, the resize weights, the kernels' library,
K1's scratch and the PRNG's key words are made there. Then it captures,
into its memory pool, the code between two yields as one graph and each
loop's `step()` as another. Capture does not execute, so each graph is
replayed before the next is captured: the segment before a loop leaves
its state and flag, and the loop's graph is replayed until the flag
clears, one host read a chunk. Every graph of the program is captured at
the first call, whether or not its loop runs, and later calls replay
them in the order of capture, which is what makes one pool safe to share
between them. Each call copies the caller's tensors into the static
inputs and returns clones of the static outputs, so each call's arrays
are its own, as JAX's are. A capture or a replay that fails raises;
nothing falls back to eager code.

Programs may share a pool (`pool`): every value a call reads from the
pool is written earlier in the same call, and no two programs run at
once, so one program's replay may overwrite another's freed blocks.
All programs of a device capture on one stream, so the blocks one freed
are reused by the next.

The kernels' wrappers count their launches in Python, which a replay does
not run. So the launches a capture counted are taken back and kept with
its graph, and each replay adds them: `LAUNCHES` stays the count of
kernels the card ran.

Spans (utils/profiling.py): a call's copy in is `compiled.ingest`, each
replay of straight code `compiled.segment`, each read of a loop's flag
`loop.flag` and each replay of its chunk `loop.step`, the clones
`compiled.outputs`; the first call is the setup span `compiled.capture`.
"""

from __future__ import annotations

import itertools

import torch

from image_segmenter_tpu_torch.kernels import cg_update as KCG
from image_segmenter_tpu_torch.kernels import histogram as KH
from image_segmenter_tpu_torch.kernels import matvec as KMV
from image_segmenter_tpu_torch.kernels import precompute as KP
from image_segmenter_tpu_torch.kernels import quantize as KQ
from image_segmenter_tpu_torch.utils.loops import warm_up
from image_segmenter_tpu_torch.utils.profiling import setup_span, span

# the launch counters of the main path's kernels, K1-K4, and the CG's
# update (kernels/cg_update.py)
COUNTERS = ((KH, "LAUNCHES"), (KP, "LAUNCHES"), (KMV, "LAUNCHES"),
            (KQ, "LAUNCHES"), (KCG, "LAUNCHES"))

# the capture stream of each device, shared by its programs
_STREAMS: dict = {}
# numbers the programs in the order they are made, for their spans
_SERIAL = itertools.count(1)


def _counts() -> list:
    return [getattr(mod, attr) for mod, attr in COUNTERS]


def _add_counts(delta) -> None:
    for (mod, attr), n in zip(COUNTERS, delta):
        setattr(mod, attr, getattr(mod, attr) + n)


class _Graph:
    """One captured graph, its index in the program, the launches its
    replay makes, and for a loop's step the flag that says whether to
    replay it again, the loop's iteration counts, its class's name and
    the attrs of its `loop.step` spans: (class, index), and the loop's
    `update` path where it has one (solvers/matting.CGLoop)."""

    __slots__ = ("graph", "index", "launches", "flag", "it", "loop",
                 "step_attrs")

    def __init__(self, graph, index, launches, loop=None):
        self.graph, self.index, self.launches = graph, index, launches
        self.flag, self.it, self.loop = (None, None, None) if loop is None \
            else (loop.flag, loop.it, type(loop).__name__)
        update = getattr(loop, "update", None)
        self.step_attrs = (self.loop, index) + (
            () if update is None else (update,))

    def replay(self) -> None:
        if self.flag is None:
            with span("compiled.segment", self.index):
                self.graph.replay()
            _add_counts(self.launches)
            return
        while True:
            with span("loop.flag", self.loop):
                go = bool(self.flag)  # one host read a chunk
            if not go:
                return
            with span("loop.step", *self.step_attrs):
                self.graph.replay()
            _add_counts(self.launches)


class Compiled:
    """`program` (a generator function of tensors of `specs`, a sequence
    of (shape, dtype), on `device`) captured at the first call and
    replayed after that. `pool`: a memory pool shared with other programs
    (`torch.cuda.graph_pool_handle()`), or None for a pool of its own."""

    def __init__(self, program, specs, device: torch.device, pool=None):
        if device.type != "cuda":
            raise ValueError(f"Compiled runs CUDA graphs, not on {device}")
        self.program = program
        self.inputs = tuple(torch.empty(shape, dtype=dtype, device=device)
                            for shape, dtype in specs)
        key = str(device)
        if key not in _STREAMS:
            _STREAMS[key] = torch.cuda.Stream(device)
        self._stream = _STREAMS[key]
        self._pool = torch.cuda.graph_pool_handle() if pool is None else pool
        self._graphs = []
        self._out = None
        self.serial = next(_SERIAL)

    def __call__(self, *xs: torch.Tensor) -> tuple:
        if len(xs) != len(self.inputs):
            raise ValueError(f"the program takes {len(self.inputs)} tensors, "
                             f"got {len(xs)}")
        with span("compiled.ingest", self.serial):
            for dst, x in zip(self.inputs, xs):
                dst.copy_(x)
        if self._out is None:
            with setup_span("compiled.capture", self.serial):
                self._capture()
        else:
            for g in self._graphs:
                g.replay()
        with span("compiled.outputs"):
            return tuple(t.clone() for t in self._out)

    def graphs(self) -> int:
        """The number of graphs the program was captured as."""
        return len(self._graphs)

    def iterations(self) -> list:
        """Each loop's (B,) iteration counts in the last call, in the
        program's order."""
        return [g.it.clone() for g in self._graphs if g.it is not None]

    def _record(self, fn, loop=None) -> None:
        """Capture fn() into this program's pool and replay it."""
        graph = torch.cuda.CUDAGraph()
        before = _counts()
        # capture_begin / capture_end, not `torch.cuda.graph`, whose entry
        # runs the garbage collector and empties the allocator's cache: a
        # program of many loops captures many graphs
        with torch.cuda.stream(self._stream):
            graph.capture_begin(pool=self._pool)
            try:
                fn()
            finally:
                graph.capture_end()
        launches = [a - b for a, b in zip(_counts(), before)]
        _add_counts([-n for n in launches])  # a capture launches nothing
        g = _Graph(graph, len(self._graphs), launches, loop)
        self._graphs.append(g)
        g.replay()

    def _capture(self) -> None:
        cur = torch.cuda.current_stream(self.inputs[0].device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            warm_up(self.program(*self.inputs))
        cur.wait_stream(self._stream)

        gen = self.program(*self.inputs)
        got = {}

        def segment():
            try:
                got["loop"] = gen.send(None)
            except StopIteration as stop:
                got["out"] = stop.value

        while True:
            got.clear()
            self._record(segment)
            if "out" in got:
                break
            loop = got["loop"]
            self._record(loop.step, loop)
        self._out = tuple(got["out"])
