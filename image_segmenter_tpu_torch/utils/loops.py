"""Loops a program yields, and the two eager ways to run a program.

A program is a generator function of tensors. It runs tensor code and
yields each loop it reaches, an object with

- `step()`: a fixed chunk of iterations on the device, no host read, its
  loop-carried state updated in place (solvers/matting.CGLoop,
  solvers/kmeans.LloydLoop and RestartLoop, solvers/grabcut.CPLoop);
- `flag`: a 0-dim bool tensor on the device, whether any lane is still
  active;
- `it`: the iterations each lane has run;
- `run()`: the eager loop, `step()` until the flag clears (`Loop.run`)
  or an equivalent that reads the host more often;

and returns its outputs. `drive` runs a program eagerly; `warm_up` runs
it with each loop stepped once, which is what pipeline/compiled.Compiled
does before it captures the program as CUDA graphs.
"""

from __future__ import annotations

from image_segmenter_tpu_torch.utils.profiling import span


class Loop:
    """The eager `run` of a loop with `step` and `flag`."""

    def run(self) -> None:
        """Step until no lane is active: one host read a chunk (the spans
        `loop.flag` and `loop.step`, utils/profiling.py)."""
        name = type(self).__name__
        update = getattr(self, "update", None)
        step = (name,) if update is None else (name, None, update)
        while True:
            with span("loop.flag", name):
                go = bool(self.flag)
            if not go:
                return
            with span("loop.step", *step):
                self.step()


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
