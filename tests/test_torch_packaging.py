"""What an installed port needs beside its Python modules: every source
file the kernel build (kernels/_build.py) and the native geometry build
(ops/native.py) read is package data in pyproject.toml, and the port's
copy of the geometry engine is the repository's native/geometry.cpp."""

import fnmatch
import os
import tomllib
from pathlib import Path

import pytest

from image_segmenter_tpu_torch.kernels import _build
from image_segmenter_tpu_torch.ops import native as TN

PKG = Path(_build.__file__).resolve().parents[1]
REPO = PKG.parent


def _package_data():
    with open(REPO / "pyproject.toml", "rb") as f:
        cfg = tomllib.load(f)
    return cfg["tool"]["setuptools"]["package-data"][PKG.name]


def _shipped(path: Path) -> bool:
    rel = path.resolve().relative_to(PKG).as_posix()
    return any(fnmatch.fnmatch(rel, pat) for pat in _package_data())


@pytest.mark.parametrize("src", [p.name for p in _build._sources()])
def test_kernel_sources_are_package_data(src):
    assert src.endswith((".cu", ".cuh"))
    assert _shipped(_build.CSRC / src), src


def test_kernel_header_is_read_and_shipped():
    """quantize.cu and quantize_flat.cu include palette_map.cuh."""
    names = [p.name for p in _build._sources()]
    assert "palette_map.cuh" in names
    for cu in ("quantize.cu", "quantize_flat.cu"):
        assert '#include "palette_map.cuh"' in (_build.CSRC / cu).read_text()


def test_native_source_is_package_data_and_the_repository_copy():
    src = Path(TN._SRC)
    assert src.is_file() and src.is_relative_to(PKG)
    assert _shipped(src)
    assert src.read_bytes() == (REPO / "native" / "geometry.cpp").read_bytes()


def test_every_non_python_file_of_the_port_is_package_data():
    """Nothing the port reads at run time is left out of a wheel: every
    committed file of the package that is not Python is matched."""
    skip = {"__pycache__", "_build", "_native_build"}
    missing = []
    for root, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d not in skip]
        for f in files:
            shipped = _shipped(Path(root) / f)
            if not f.endswith((".py", ".pyc")) and not shipped:
                missing.append(os.path.relpath(os.path.join(root, f), PKG))
    assert not missing, missing
