"""Semantic maps from per-instance masks (the port of
samrs_tpu/generate/painter.py; reference GD/main_sam_hbox_semantic.py:162-199).

The gray map starts at 255 (no instance) and instances are painted in
order, a later one over an earlier one.  "The last instance wins" is "the
largest covering index wins", so the device form folds each chunk of masks
into a running map of the last covering index (``update_cover``: one max
over the chunk, no order between its masks), then reads labels and palette
colours through that map (``gray_from_cover``).  The label generator's
chunks fold through ``update_cover`` too.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import torch

from samrs_tpu_torch.data.mapping import PALETTE


def paint_semantic(masks: np.ndarray, labels: np.ndarray,
                   hw: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """Host form: (N, H, W) binary masks and (N,) labels -> (gray (H, W)
    uint8, color (H, W, 3) uint8), painted mask after mask."""
    gray = np.full(hw, 255, np.uint8)
    for m, lbl in zip(masks, labels):
        gray[np.asarray(m, bool)] = lbl
    return gray, PALETTE[gray]


def update_cover(cover: torch.Tensor, masks: torch.Tensor, base_idx: int,
                 valid: int) -> torch.Tensor:
    """Fold a chunk into the running last-covering-index map.

    cover: (H, W) int32, -1 where nothing covers; masks: (C, H, W) bool, the
    instances base_idx .. base_idx + C - 1; masks from `valid` on are padding
    and ignored.  Returns the new cover."""
    if valid <= 0:
        return cover
    idx = torch.arange(base_idx, base_idx + valid, device=cover.device, dtype=torch.int32)
    return torch.maximum(cover, torch.where(masks[:valid], idx[:, None, None], -1).amax(0))


def gray_from_cover(cover: np.ndarray, labels: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host (H, W) last-covering-index map and (N,) labels -> (gray, color)."""
    gray = np.full(cover.shape, 255, np.uint8)
    covered = cover >= 0
    gray[covered] = np.asarray(labels)[cover[covered]].astype(np.uint8)
    return gray, PALETTE[gray]


def paint_semantic_device(mask_chunks: Iterable[Tuple[int, torch.Tensor]], labels: np.ndarray,
                          hw: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """Device form over a stream of ``(base_idx, (C, H, W) bool)`` chunks in
    instance order, folded on the chunks' device -> host (gray, color)."""
    cover = torch.full(hw, -1, dtype=torch.int32)
    for base_idx, chunk in mask_chunks:
        cover = update_cover(cover.to(chunk.device), chunk, base_idx, chunk.shape[0])
    return gray_from_cover(cover.cpu().numpy(), labels)
