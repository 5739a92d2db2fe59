"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full power limit of 700 W). A share of a
peak is stated beside the card's own power limit (`card_label`)."""

from __future__ import annotations

import subprocess

PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
PEAK_HBM_BYTES_S = 3.35e12


def card_label(index: int = 0) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    "unknown" where nvidia-smi cannot tell."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30)
        return out.stdout.strip().splitlines()[index]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"
