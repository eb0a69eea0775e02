"""Coordinate and image transforms for SAM inputs (numpy only).

Mirrors samrs_tpu/sam/transforms.py (reference: segment_anything
utils/transforms.py).  The reference resizes through PIL's bilinear filter;
``resize_bilinear_uint8`` reproduces that filter in numpy: a triangle kernel
whose support widens with the downscale factor, coefficients normalised and
quantised to 22 fractional bits, a horizontal pass rounded to uint8, then a
vertical pass.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Tuple

import numpy as np

_PRECISION_BITS = 32 - 8 - 2


def _coefficients(in_size: int, out_size: int):
    """Per output index: first input index and int32 weights (PIL
    precompute_coeffs + normalize_coeffs_8bpc)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    starts = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        x = np.arange(xmax)
        w = np.maximum(1.0 - np.abs((x + xmin - center + 0.5) / filterscale), 0.0)
        total = w.sum()
        if total != 0.0:
            w = w / total
        q = w * (1 << _PRECISION_BITS)
        weights[xx, :xmax] = np.where(q < 0, np.trunc(q - 0.5), np.trunc(q + 0.5))
        starts[xx] = xmin
    return starts, weights


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One PIL bilinear pass of a uint8 (H, W, C) image along `axis`."""
    in_size = img.shape[axis]
    starts, weights = _coefficients(in_size, out_size)
    wshape = [1] * img.ndim
    wshape[axis] = out_size
    acc = np.int64(1 << (_PRECISION_BITS - 1))
    for j in range(weights.shape[1]):  # taps past an index's window have weight 0
        src = np.take(img, np.minimum(starts + j, in_size - 1), axis=axis).astype(np.int64)
        acc = acc + src * weights[:, j].reshape(wshape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear_uint8(image: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """PIL ``Image.resize((w, h), BILINEAR)`` of an HWC uint8 image."""
    out_h, out_w = size_hw
    img = image
    if img.shape[1] != out_w:
        img = _resample_axis(img, out_w, axis=1)
    if img.shape[0] != out_h:
        img = _resample_axis(img, out_h, axis=0)
    return img


class ResizeLongestSide:
    """Resize images and coordinates so the longest side equals target_length."""

    def __init__(self, target_length: int) -> None:
        self.target_length = target_length

    @staticmethod
    def get_preprocess_shape(oldh: int, oldw: int, long_side_length: int) -> Tuple[int, int]:
        """transforms.py:93-102: int(dim * scale + 0.5)."""
        scale = long_side_length * 1.0 / max(oldh, oldw)
        newh, neww = oldh * scale, oldw * scale
        return int(newh + 0.5), int(neww + 0.5)

    def apply_image(self, image: np.ndarray) -> np.ndarray:
        """HWC uint8 -> resized HWC uint8 (the reference's PIL bilinear)."""
        target = self.get_preprocess_shape(image.shape[0], image.shape[1], self.target_length)
        return resize_bilinear_uint8(np.asarray(image, np.uint8), target)

    def apply_coords(self, coords: np.ndarray, original_size: Tuple[int, int]) -> np.ndarray:
        """(..., 2) xy pixel coords in the original frame -> resized frame."""
        old_h, old_w = original_size
        new_h, new_w = self.get_preprocess_shape(old_h, old_w, self.target_length)
        coords = deepcopy(coords).astype(np.float64)
        coords[..., 0] = coords[..., 0] * (new_w / old_w)
        coords[..., 1] = coords[..., 1] * (new_h / old_h)
        return coords.astype(np.float32)

    def apply_boxes(self, boxes: np.ndarray, original_size: Tuple[int, int]) -> np.ndarray:
        """(..., 4) xyxy boxes -> resized frame."""
        return self.apply_coords(boxes.reshape(-1, 2, 2), original_size).reshape(-1, 4)
