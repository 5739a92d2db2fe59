"""Console progress reporter with the reference's callback + cancel contract.

Counterpart of image_segmenter_tpu/utils/progress.py, copied: it has no
device code. The reference's ProgressDialog exposes `update_progress(
current, total, message)` (pumping the Qt loop) and `is_cancelled`
(progress_dialog.py:41-68); long operations take a `(current, total,
message)` callback and treat a cancelled dialog / None-returning callback
as "abort the whole operation". This is the headless counterpart, usable
directly as progress_callback.
"""

from __future__ import annotations

import sys
import time


class ConsoleProgress:
    def __init__(self, label: str = "", stream=None, min_interval_s: float = 0.1):
        self.label = label
        self.stream = stream or sys.stderr
        self.min_interval_s = min_interval_s
        self._last_emit = 0.0
        self._cancelled = False
        self.history = []  # (current, total, message)

    def __call__(self, current: int, total: int, message: str = "") -> None:
        self.update_progress(current, total, message)

    def update_progress(self, current: int, total: int, message: str = "") -> None:
        self.history.append((current, total, message))
        now = time.time()
        if now - self._last_emit < self.min_interval_s and current < total:
            return
        self._last_emit = now
        pct = 100.0 * current / total if total else 0.0
        prefix = f"{self.label}: " if self.label else ""
        print(f"\r{prefix}[{pct:5.1f}%] {message}", end="" if current < total else "\n",
              file=self.stream, flush=True)

    def cancel(self) -> None:
        self._cancelled = True

    @property
    def is_cancelled(self) -> bool:
        return self._cancelled
