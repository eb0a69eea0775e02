"""Oriented-box and polygon geometry for the annotation loaders and the
rotated-box prompts, vectorised numpy over (N, ...) arrays (the port's copy
of samrs_tpu/geometry/obb.py's ``obb2poly`` and ``poly_to_hbb``)."""

from __future__ import annotations

import numpy as np


def obb2poly(obboxes: np.ndarray) -> np.ndarray:
    """(N, 5) [cx, cy, w, h, theta] -> (N, 8) polygon corners: the (w, h)
    box corners from (-w/2, -h/2), clockwise in image coordinates, rotated
    by theta (the corners are the same under every angle convention)."""
    obboxes = np.asarray(obboxes, np.float64)
    ctr = obboxes[:, None, 0:2]
    w, h, theta = obboxes[:, 2], obboxes[:, 3], obboxes[:, 4]
    cos, sin = np.cos(theta), np.sin(theta)
    dx = np.stack([-w, w, w, -w], axis=1) / 2.0
    dy = np.stack([-h, -h, h, h], axis=1) / 2.0
    x = dx * cos[:, None] - dy * sin[:, None]
    y = dx * sin[:, None] + dy * cos[:, None]
    return (ctr + np.stack([x, y], axis=2)).reshape(-1, 8)


def poly_to_hbb(polys: np.ndarray) -> np.ndarray:
    """(N, 8) polygons -> (N, 4) xyxy enclosing horizontal boxes (the
    prompts of the rotated-box pipeline)."""
    p = np.asarray(polys, np.float64).reshape(-1, 4, 2)
    return np.concatenate([p.min(axis=1), p.max(axis=1)], axis=1).astype(np.float32)
