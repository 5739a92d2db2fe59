"""The compiled main path: one program a shape, replayed from CUDA graphs.

Counterpart of the JAX package's `jax.jit` of `Pipeline`'s batch function
(image_segmenter_tpu/pipeline/segment.py:307-352): the JAX `Pipeline`
compiles once per input shape and enqueues the compiled program with no
host read, its two loops (the matting CG, the Lloyd iterations of
`kmeans_fit_det`) running on the device as `lax.while_loop`s.

Here a program is a generator function of the static input batch. It
runs the pipeline's tensor code and yields each loop it reaches, an
object with

- `step()`: a fixed chunk of iterations on the card, no host read, its
  loop-carried state updated in place (solvers/matting.CGLoop,
  solvers/kmeans.LloydLoop);
- `flag`: a 0-dim bool tensor on the card, whether any image is still
  active;
- `it`: the (B,) int32 iterations each image has run;
- `run()`: `step()` until the flag clears, the eager loop;

and returns its outputs, a tuple of tensors.

`drive` runs a program eagerly: each loop it yields runs to its end.

`Compiled` is one program for one input shape, run as CUDA graphs. At its
first call it warms the program up eagerly on a side stream, as
`torch.cuda.graph` requires (cuDNN and cuBLAS handles, the resize weights,
the kernels' library and K1's scratch are made there), and then captures,
into one private memory pool, the code between two yields as one graph
and each loop's `step()` as another. Capture does not execute, so each
graph is replayed before the next is captured: the segment before a loop
leaves its state and flag, and the loop's graph is replayed until the
flag clears, one host read a chunk. Every graph of the program is captured
at the first call, whether or not its loop runs, and later calls replay
them in the order of capture, which is what makes one pool safe to share
between them. Each call copies the caller's batch into the static input
and returns clones of the static outputs, so each call's arrays are its
own, as JAX's are. A capture or a replay that fails raises; nothing falls
back to eager code.

The kernels' wrappers count their launches in Python, which a replay does
not run. So the launches a capture counted are taken back and kept with
its graph, and each replay adds them: `LAUNCHES` stays the count of
kernels the card ran.
"""

from __future__ import annotations

import torch

from image_segmenter_tpu_torch.kernels import histogram as KH
from image_segmenter_tpu_torch.kernels import matvec as KMV
from image_segmenter_tpu_torch.kernels import precompute as KP
from image_segmenter_tpu_torch.kernels import quantize as KQ

# the launch counters of the main path's kernels, K1-K4
COUNTERS = ((KH, "LAUNCHES"), (KP, "LAUNCHES"), (KMV, "LAUNCHES"),
            (KQ, "LAUNCHES"))


def drive(program, loops: list | None = None):
    """Run a program (a generator) eagerly: every loop it yields runs to
    its end, and joins `loops` where a list is given. Returns what the
    program returns."""
    try:
        loop = next(program)
        while True:
            loop.run()
            if loops is not None:
                loops.append(loop)
            loop = program.send(None)
    except StopIteration as stop:
        return stop.value


def _counts() -> list:
    return [getattr(mod, attr) for mod, attr in COUNTERS]


def _add_counts(delta) -> None:
    for (mod, attr), n in zip(COUNTERS, delta):
        setattr(mod, attr, getattr(mod, attr) + n)


class _Graph:
    """One captured graph, the launches its replay makes, and for a loop's
    step the flag that says whether to replay it again and the loop's
    iteration counts."""

    __slots__ = ("graph", "launches", "flag", "it")

    def __init__(self, graph, launches, loop=None):
        self.graph, self.launches = graph, launches
        self.flag, self.it = (None, None) if loop is None \
            else (loop.flag, loop.it)

    def replay(self) -> None:
        if self.flag is None:
            self.graph.replay()
            _add_counts(self.launches)
            return
        while bool(self.flag):  # one host read a chunk
            self.graph.replay()
            _add_counts(self.launches)


class Compiled:
    """`program` (a generator function of one (shape, dtype) tensor on
    `device`) captured at the first call and replayed after that."""

    def __init__(self, program, shape, dtype: torch.dtype,
                 device: torch.device):
        if device.type != "cuda":
            raise ValueError(f"Compiled runs CUDA graphs, not on {device}")
        self.program = program
        self.input = torch.empty(shape, dtype=dtype, device=device)
        self._stream = torch.cuda.Stream(device)
        self._pool = torch.cuda.graph_pool_handle()
        self._graphs = []
        self._out = None

    def __call__(self, x: torch.Tensor) -> tuple:
        self.input.copy_(x)
        if self._out is None:
            self._capture()
        else:
            for g in self._graphs:
                g.replay()
        return tuple(t.clone() for t in self._out)

    def iterations(self) -> list:
        """Each loop's (B,) iteration counts in the last call, in the
        program's order."""
        return [g.it.clone() for g in self._graphs if g.it is not None]

    def _record(self, fn, loop=None) -> None:
        """Capture fn() into this program's pool and replay it."""
        graph = torch.cuda.CUDAGraph()
        before = _counts()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
            fn()
        launches = [a - b for a, b in zip(_counts(), before)]
        _add_counts([-n for n in launches])  # a capture launches nothing
        g = _Graph(graph, launches, loop)
        self._graphs.append(g)
        g.replay()

    def _capture(self) -> None:
        cur = torch.cuda.current_stream(self.input.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            drive(self.program(self.input))  # the warm-up
        cur.wait_stream(self._stream)

        gen = self.program(self.input)
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
