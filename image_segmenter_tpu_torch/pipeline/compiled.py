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
clears, one host read a chunk. A `utils.loops.Cut` the program yields
ends a graph of straight code where no loop follows (a prompted model's
network stage), and labels it. Every graph of the program is captured at
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

`ProgramCache` is where compiled programs are kept, the main path's
(pipeline/segment.Pipeline, one cache a pipeline) and GrabCut's units
(solvers/grabcut.py, one for the process). A call names a device, a
shape and a program (a generator function of tensor arguments, nests of
them as tuples, and static keyword arguments); the program is compiled
at the first call with its argument structure, shapes, dtypes and static
arguments and replayed after that. Programs are kept in groups, one a
(shape, device), whose programs share one memory pool; the
`PROGRAM_SHAPES` groups used last are kept, and the memory of a group
dropped past them goes back to the device, so the memory compiled
programs hold stays bounded however many shapes a process sees.

Python counters (a kernel wrapper's `LAUNCHES`, models/sam.py's
`FRAMES`) are not bumped by a replay, which runs no Python. So of every
counter registered in utils/profiling.py (`replayed_counter`) what a
capture counted is taken back and kept with its graph, and each replay
adds it: `LAUNCHES` stays the count of kernels the card ran.

Spans (utils/profiling.py): a call's copy in is `compiled.ingest`, each
replay of straight code `compiled.segment` (attrs: the graph's index,
and a cut's label), each read of a loop's flag
`loop.flag` and each replay of its chunk `loop.step`, the clones
`compiled.outputs`; the first call is the setup span `compiled.capture`.
"""

from __future__ import annotations

import collections
import gc
import itertools

import torch

from image_segmenter_tpu_torch.utils.loops import Cut, loop_attrs, \
    run_chunks, warm_up
from image_segmenter_tpu_torch.utils.profiling import replayed_counters, \
    setup_span, span

# the groups a ProgramCache keeps, those used last
PROGRAM_SHAPES = 2

# the capture stream of each device, shared by its programs
_STREAMS: dict = {}
# numbers the programs in the order they are made, for their spans
_SERIAL = itertools.count(1)


def _counts() -> list:
    return [getattr(mod, attr) for mod, attr in replayed_counters()]


class _Graph:
    """One captured graph, what its replay adds to the registered
    counters, and for a loop's step the flag that says whether to replay
    it again, the loop's iteration counts and the attrs of its
    `loop.step` spans (`utils.loops.loop_attrs`: class and `index`, the
    graph's in the program). Straight code's `compiled.segment` spans
    carry (index,), or (index, label) for the code before a `Cut`."""

    __slots__ = ("graph", "counts", "flag", "it", "step_attrs",
                 "segment_attrs")

    def __init__(self, graph, index, counts, loop=None, label=None):
        self.graph = graph
        # (module, attribute, n) of each registered counter the capture
        # moved, in the registry's order
        self.counts = tuple((mod, attr, n) for (mod, attr), n
                            in zip(replayed_counters(), counts) if n)
        self.segment_attrs = (index,) if label is None else (index, label)
        self.flag, self.it = (None, None) if loop is None \
            else (loop.flag, loop.it)
        self.step_attrs = None if loop is None else loop_attrs(loop, index)

    def add_counts(self, sign: int = 1) -> None:
        for mod, attr, n in self.counts:
            setattr(mod, attr, getattr(mod, attr) + sign * n)

    def _step(self) -> None:
        self.graph.replay()
        self.add_counts()

    def replay(self) -> None:
        if self.flag is None:
            with span("compiled.segment", *self.segment_attrs):
                self._step()
        else:
            run_chunks(self, self._step, self.step_attrs)


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
        """Capture fn() into this program's pool and replay it; what fn
        returns labels the graph."""
        graph = torch.cuda.CUDAGraph()
        before = _counts()
        # capture_begin / capture_end, not `torch.cuda.graph`, whose entry
        # runs the garbage collector and empties the allocator's cache: a
        # program of many loops captures many graphs
        with torch.cuda.stream(self._stream):
            graph.capture_begin(pool=self._pool)
            try:
                label = fn()
            finally:
                graph.capture_end()
        g = _Graph(graph, len(self._graphs),
                   [a - b for a, b in zip(_counts(), before)], loop, label)
        g.add_counts(-1)  # a capture launches nothing
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
                return None
            return got["loop"].label if isinstance(got["loop"], Cut) \
                else None

        while True:
            got.clear()
            self._record(segment)
            if "out" in got:
                break
            loop = got["loop"]
            if not isinstance(loop, Cut):
                self._record(loop.step, loop)
        self._out = tuple(got["out"])


_TENSOR = "tensor"


def _flatten(x, leaves: list):
    """The tensors of a nest of tuples (named ones too) and None, in
    order, appended to `leaves`; returns the nest's structure."""
    if torch.is_tensor(x):
        leaves.append(x)
        return _TENSOR
    if x is None:
        return None
    if isinstance(x, tuple):
        return type(x), tuple(_flatten(c, leaves) for c in x)
    raise TypeError(f"a program takes tensors, tuples and None, not {type(x)}")


def _unflatten(spec, leaves):
    """The nest of `spec` from an iterator of its tensors."""
    if spec is _TENSOR:
        return next(leaves)
    if spec is None:
        return None
    typ, children = spec
    values = [_unflatten(c, leaves) for c in children]
    return tuple(values) if typ is tuple else typ(*values)


def _release() -> None:
    """Give the memory of dropped programs back to the device."""
    gc.collect()
    torch.cuda.empty_cache()


class _Group(dict):
    """The programs of one group, by (program, argument structure, shapes
    and dtypes, static arguments), each with its output structure, and
    the memory pool they share, made at the first capture."""

    pool = None


class ProgramCache:
    """Compiled programs, kept in groups of a (shape, device), the
    `PROGRAM_SHAPES` groups used last (the module docstring).

    `groups`: the groups by (shape, device name), the one used last
    last."""

    def __init__(self):
        self.groups: collections.OrderedDict = collections.OrderedDict()

    def group(self, key) -> _Group:
        """The group `key`, made the most recently used; the least
        recently used groups past `PROGRAM_SHAPES` are dropped and their
        pools released."""
        group = self.groups.pop(key, None)
        self.groups[key] = group = _Group() if group is None else group
        if len(self.groups) > PROGRAM_SHAPES:  # one group over at most
            self.groups.popitem(last=False)
            _release()
        return group

    def programs(self) -> list:
        """The programs kept, every group's."""
        return [prog for group in self.groups.values()
                for prog, _ in group.values()]

    def clear(self) -> None:
        """Drop every program and release their pools."""
        self.groups.clear()
        _release()

    def __call__(self, device: torch.device, shape, program, *args,
                 **static):
        """`program(*args, **static)` on `device`, in the group of
        (`shape`, device): captured at its first call (as a `Compiled`
        in the group's pool) and replayed after that. The arguments are
        copied into the program's static inputs, from wherever they
        are; the outputs are clones, in the nest the program returned. A
        capture or replay that fails raises, and a failed capture keeps
        nothing."""
        leaves = []
        spec = _flatten(args, leaves)
        group = self.group((shape, str(device)))
        key = (program, spec, tuple((tuple(t.shape), t.dtype)
                                    for t in leaves),
               tuple(sorted(static.items())))
        entry = group.get(key)
        if entry is None:
            out_spec = []

            def flat(*xs):
                out = yield from program(*_unflatten(spec, iter(xs)),
                                         **static)
                outs = []
                out_spec.append(_flatten(out, outs))
                return tuple(outs)

            if group.pool is None:
                group.pool = torch.cuda.graph_pool_handle()
            prog = Compiled(flat, [(t.shape, t.dtype) for t in leaves],
                            device, pool=group.pool)
            outs = prog(*leaves)
            group[key] = entry = (prog, out_spec[-1])
        else:
            outs = entry[0](*leaves)
        return _unflatten(entry[1], iter(outs))
