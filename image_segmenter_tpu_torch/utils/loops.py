"""Loops a program yields, and the two eager ways to run a program.

A program is a generator function of tensors. It runs tensor code and
yields each loop it reaches, an object with

- `step()`: a fixed chunk of iterations on the device, no host read, its
  loop-carried state updated in place (solvers/matting.CGLoop,
  solvers/kmeans.LloydLoop and RestartLoop, solvers/grabcut.CPLoop);
- `flag`: a 0-dim bool tensor on the device, whether any lane is still
  active;
- `it`: the iterations each lane has run;
- `run()`: the eager loop, `step()` until the flag clears (`Loop.run`,
  `run_chunks`) or an equivalent that reads the host more often;

and returns its outputs. A program may also yield a `Cut`, where its
straight code is to end a graph (pipeline/compiled.Compiled); run
eagerly, a cut does nothing. `drive` runs a program eagerly; `warm_up`
runs it with each loop stepped once, which is what
pipeline/compiled.Compiled does before it captures the program as CUDA
graphs.
"""

from __future__ import annotations

from image_segmenter_tpu_torch.utils.profiling import span


def loop_attrs(loop, index=None) -> tuple:
    """The attrs of a loop's `loop.step` spans (utils/profiling.py):
    (class,) stepped eagerly, (class, graph index) replayed from a graph;
    a loop with an `update` path (solvers/matting.CGLoop) adds it, after
    None when eager."""
    name = type(loop).__name__
    update = getattr(loop, "update", None)
    if update is not None:
        return name, index, update
    return (name,) if index is None else (name, index)


def run_chunks(owner, step, attrs: tuple) -> None:
    """Call `step()` until `owner.flag` clears, one host read a chunk:
    each read a `loop.flag` span (attrs: the loop's class, `attrs[0]`),
    each chunk a `loop.step` span with `attrs`. `Loop.run` steps a loop
    eagerly with it, and pipeline/compiled.py replays a loop's graph with
    it."""
    while True:
        with span("loop.flag", attrs[0]):
            go = bool(owner.flag)
        if not go:
            return
        with span("loop.step", *attrs):
            step()


class Loop:
    """The eager `run` of a loop with `step` and `flag`."""

    def run(self) -> None:
        """Step until no lane is active (`run_chunks`)."""
        run_chunks(self, self.step, loop_attrs(self))


class Cut:
    """Yielded where a program's straight code since its last yield is to
    be a graph of its own, whose `compiled.segment` spans carry `label`
    (a prompted model's network stage). No loop: nothing to step."""

    def __init__(self, label: str):
        self.label = label

    def run(self) -> None:
        pass

    step = run


def drive(program, loops: list | None = None):
    """Run a program (a generator) eagerly: every loop it yields runs to
    its end, and joins `loops` where a list is given. Returns what the
    program returns."""
    try:
        loop = next(program)
        while True:
            loop.run()
            if loops is not None and not isinstance(loop, Cut):
                loops.append(loop)
            loop = program.send(None)
    except StopIteration as stop:
        return stop.value


def warm_up(program):
    """Run a program eagerly with each loop it yields stepped once, not
    run to its end: what its graphs will run, once, and nothing more.
    Returns what the program returns (from loops that ran one chunk)."""
    try:
        loop = next(program)
        while True:
            loop.step()
            loop = program.send(None)
    except StopIteration as stop:
        return stop.value
