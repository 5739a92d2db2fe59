"""The benchmark's own tests: `python -m pytest benchmark/tests -q` from
the root of the repository (about two minutes on the CPU). Tests that need
the card are marked `cuda` and skip without one."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU")
