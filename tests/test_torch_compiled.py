"""The compiled programs' owner, pipeline/compiled.py, on the CPU.

CUDA graphs cannot run here, so `Compiled` is replaced by a stand-in
that drives the program eagerly where a test needs one; what is held
here is the cache around it: the groups it keeps and drops, the key a
program is compiled under, and that the module knows no kernel and no
model, whose counters register themselves (utils/profiling.py).
"""

import ast
import importlib
import pkgutil
from typing import NamedTuple

import pytest
import torch

from image_segmenter_tpu_torch import kernels
from image_segmenter_tpu_torch.models import sam as SAM
from image_segmenter_tpu_torch.pipeline import compiled as CP
from image_segmenter_tpu_torch.utils.loops import drive
from image_segmenter_tpu_torch.utils.profiling import replayed_counters

SHAPES = [((96, 128), "cuda:0"), ((128, 96), "cuda:0"), ((64, 192), "cuda:0"),
          ((192, 64), "cuda:0"), ((96, 128), "cuda:1")]

# the module-level int counters a kernel wrapper or a model bumps
COUNTER_NAMES = ("LAUNCHES", "STACK_LAUNCHES", "FRAMES", "PROMPTS")


@pytest.fixture
def released(monkeypatch):
    """The releases of dropped pools, stubbed: there is no card."""
    out = []
    monkeypatch.setattr(CP, "_release", lambda: out.append(1))
    return out


@pytest.mark.parametrize("kept", [1, 2, 3])
def test_program_groups_keep_the_last_shapes(kept, released, monkeypatch):
    """Compiled programs are kept in groups, one a shape and device:
    after five shapes the last `PROGRAM_SHAPES` groups are left, each
    with its programs, and every group dropped released its memory."""
    monkeypatch.setattr(CP, "PROGRAM_SHAPES", kept)
    cache = CP.ProgramCache()
    for i, key in enumerate(SHAPES):
        cache.group(key)["unit"] = (f"program {i}", None)
        assert len(cache.groups) == min(i + 1, kept)
    assert list(cache.groups) == SHAPES[-kept:]
    assert cache.programs() == [f"program {i}" for i in range(5 - kept, 5)]
    assert len(released) == 5 - kept


def test_program_group_used_again_is_kept(released, monkeypatch):
    """A group used again becomes the most recent: a new shape drops
    the group used least recently, not the one made first; and `clear`
    drops every group."""
    monkeypatch.setattr(CP, "PROGRAM_SHAPES", 2)
    cache = CP.ProgramCache()
    first = cache.group(SHAPES[0])
    first["unit"] = ("program 0", None)
    cache.group(SHAPES[1])
    assert cache.group(SHAPES[0]) is first and not released
    cache.group(SHAPES[2])
    assert list(cache.groups) == [SHAPES[0], SHAPES[2]]
    assert cache.group(SHAPES[0]) is first and released == [1]
    cache.clear()
    assert not cache.groups and released == [1, 1]


class _Eager:
    """A stand-in for `Compiled`: the program driven eagerly on its
    arguments at every call, its constructions counted."""

    made: list = []

    def __init__(self, program, specs, device, pool=None):
        self.program, self.pool = program, pool
        self.specs = [(tuple(shape), dtype) for shape, dtype in specs]
        _Eager.made.append(self)

    def __call__(self, *xs):
        return drive(self.program(*xs))


class _Pair(NamedTuple):
    a: torch.Tensor
    b: torch.Tensor


def _program(pair, scale=None, *, k):
    total = pair.a + pair.b
    yield from ()
    return _Pair(total * k, total if scale is None else total * scale), None


def test_a_program_is_compiled_once_per_arguments(released, monkeypatch):
    """The cache compiles a program at its first call with new argument
    structure, shapes, dtypes or static arguments, in its group's one
    pool, replays it after that, and returns its outputs in the nest the
    program returned; a capture that raises keeps nothing."""
    monkeypatch.setattr(_Eager, "made", [])
    monkeypatch.setattr(CP, "Compiled", _Eager)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: object())
    cache, dev = CP.ProgramCache(), torch.device("cpu")
    x = _Pair(torch.ones(2, 3), torch.full((2, 3), 2.0))

    out, none = cache(dev, (2, 3), _program, x, k=2)
    assert isinstance(out, _Pair) and none is None
    assert torch.equal(out.a, torch.full((2, 3), 6.0))
    assert torch.equal(out.b, torch.full((2, 3), 3.0))
    cache(dev, (2, 3), _program, x, k=2)
    assert len(_Eager.made) == 1
    assert _Eager.made[0].specs == [((2, 3), torch.float32)] * 2
    cache(dev, (2, 3), _program, x, torch.ones(()), k=2)  # structure
    cache(dev, (2, 3), _program, x, k=3)                  # static
    cache(dev, (2, 3), _program, _Pair(x.a.double(), x.b), k=2)  # dtype
    assert len(_Eager.made) == 4 and len(cache.programs()) == 4
    (group,) = cache.groups.values()
    assert all(p.pool is group.pool for p in _Eager.made)
    y = _Pair(torch.ones(4, 3), torch.ones(4, 3))
    cache(dev, (4, 3), _program, y, k=2)
    assert list(cache.groups) == [((2, 3), "cpu"), ((4, 3), "cpu")]
    assert _Eager.made[-1].pool is not group.pool

    def broken(pair, *, k):
        yield from ()
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError):
        cache(dev, (4, 3), broken, y, k=2)
    assert len(cache.programs()) == 5 and not released


def test_compiled_imports_no_kernel_and_no_model():
    """pipeline/compiled.py names no kernel and no model: of the port it
    imports utils/loops and utils/profiling, nothing else."""
    tree = ast.parse(open(CP.__file__).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    port = {n for n in names if n.startswith("image_segmenter_tpu_torch")}
    assert port == {"image_segmenter_tpu_torch.utils.loops",
                    "image_segmenter_tpu_torch.utils.profiling"}
    assert all(isinstance(n, ast.Import) or n.level == 0
               for n in ast.walk(tree)
               if isinstance(n, (ast.Import, ast.ImportFrom)))


def test_every_kernel_and_model_counter_is_replayed():
    """Every module-level int counter of a kernel wrapper (kernels/*.py)
    and of models/sam.py is declared through `replayed_counter`, so that
    a replay adds what its capture counted, whichever program it runs
    in; the registry holds each once, each an int."""
    mods = [importlib.import_module(f"{kernels.__name__}.{m.name}")
            for m in pkgutil.iter_modules(kernels.__path__)] + [SAM]
    found = [(mod, name) for mod in mods for name in COUNTER_NAMES
             if type(getattr(mod, name, None)) is int]
    assert len(found) >= 12
    registered = replayed_counters()
    assert [f"{m.__name__}.{n}" for m, n in found
            if (m, n) not in registered] == []
    assert len(set(registered)) == len(registered)
    assert all(type(getattr(m, n)) is int for m, n in registered)
