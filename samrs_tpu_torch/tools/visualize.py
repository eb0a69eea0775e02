"""Instance overlays of the prompt evaluation (``--vis-dir``; the port of
samrs_tpu/tools/visualize.py's ``overlay_instances``, the numpy twin of
GD/main_sam_hbox_mask_instance.py:305-339's matplotlib figures)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def overlay_instances(image: np.ndarray, masks: np.ndarray, boxes: Optional[np.ndarray] = None,
                      points: Optional[np.ndarray] = None, alpha: float = 0.6,
                      seed: int = 0) -> np.ndarray:
    """HWC uint8 image with each mask blended in a random colour, white box
    edges and green 5x5 centre points -> HWC uint8."""
    out = image.astype(np.float32).copy()
    rng = np.random.default_rng(seed)
    for m in np.asarray(masks).astype(bool):
        color = rng.uniform(64, 255, 3)
        out[m] = out[m] * (1 - alpha) + color[None] * alpha
    out = np.clip(out + 0.5, 0, 255).astype(np.uint8)
    h, w = out.shape[:2]
    if boxes is not None:
        for x0, y0, x1, y1 in np.asarray(boxes).astype(int):
            x0, x1 = np.clip([x0, x1], 0, w - 1)
            y0, y1 = np.clip([y0, y1], 0, h - 1)
            out[y0, x0:x1 + 1] = 255
            out[y1, x0:x1 + 1] = 255
            out[y0:y1 + 1, x0] = 255
            out[y0:y1 + 1, x1] = 255
    if points is not None:
        for x, y in np.asarray(points).astype(int):
            out[max(y - 2, 0):min(y + 3, h), max(x - 2, 0):min(x + 3, w)] = (0, 255, 0)
    return out
