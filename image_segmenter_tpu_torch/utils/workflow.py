"""Headless workflow state machine (the MainWindow 3-slot model, sans Qt).

Counterpart of image_segmenter_tpu/utils/workflow.py, copied: it has no
device code. The reference orchestrates everything through three image
slots with explicit Apply promotions (main_window.py:49-55, 682-718,
1120-1144) and bounded undo/redo stacks for brush masks
(image_view.py:517-523, 194-208):

  original -> [AI removal / grabcut / matting] -> original_ai_output
           -> [color simplification preview]   -> simplified_output
           -> [apply]                          -> base + original_ai_output
           -> [region cleanup / smoothing]     -> cleaned_output
           -> [apply]                          -> base
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

UNDO_DEPTH = 50  # image_view.py:517-523


class WorkflowState:
    def __init__(self, original_rgba: Optional[np.ndarray] = None):
        self.original: Optional[np.ndarray] = original_rgba
        self.original_ai_output: Optional[np.ndarray] = None
        self.simplified_output: Optional[np.ndarray] = None
        self.cleaned_output: Optional[np.ndarray] = None
        self.color_processing_applied = False
        self._undo: List[np.ndarray] = []
        self._redo: List[np.ndarray] = []

    # ---- slot transitions (main_window.py handlers) ----

    def set_ai_output(self, rgba: np.ndarray) -> None:
        """AI removal / grabcut / matting result (main_window.py:414,463-465)."""
        self.original_ai_output = rgba.copy()
        self.simplified_output = None
        self.cleaned_output = None
        self.color_processing_applied = False

    def set_simplified_preview(self, rgba: np.ndarray) -> None:
        self.simplified_output = rgba.copy()

    def apply_color_processing(self) -> np.ndarray:
        """Promote preview -> base (main_window.py:682-718)."""
        if self.simplified_output is None:
            raise ValueError("no simplified output to apply")
        self.original_ai_output = self.simplified_output.copy()
        self.color_processing_applied = True
        return self.original_ai_output

    def set_cleaned_preview(self, rgba: np.ndarray) -> None:
        self.cleaned_output = rgba.copy()

    def apply_cleanup(self) -> np.ndarray:
        """Promote cleanup -> base (main_window.py:1120-1144)."""
        if self.cleaned_output is None:
            raise ValueError("no cleaned output to apply")
        self.original_ai_output = self.cleaned_output.copy()
        return self.original_ai_output

    @property
    def working_image(self) -> Optional[np.ndarray]:
        """The image the next stage operates on (cleanup > simplify > ai)."""
        for img in (self.cleaned_output, self.simplified_output,
                    self.original_ai_output, self.original):
            if img is not None:
                return img
        return None

    # ---- undo/redo for mask edits (image_view.py:194-208, 517-523) ----

    def push_undo(self, mask: np.ndarray) -> None:
        self._undo.append(mask.copy())
        if len(self._undo) > UNDO_DEPTH:
            self._undo.pop(0)
        self._redo.clear()

    def undo(self, current: np.ndarray) -> Optional[np.ndarray]:
        if not self._undo:
            return None
        self._redo.append(current.copy())
        if len(self._redo) > UNDO_DEPTH:
            self._redo.pop(0)
        return self._undo.pop()

    def redo(self, current: np.ndarray) -> Optional[np.ndarray]:
        if not self._redo:
            return None
        self._undo.append(current.copy())
        if len(self._undo) > UNDO_DEPTH:
            self._undo.pop(0)
        return self._redo.pop()
