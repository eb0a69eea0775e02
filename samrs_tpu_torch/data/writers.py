"""Label writers: gray and colour semantic PNGs and the per-image instance
pkl (the port's copy of samrs_tpu/data/writers.py; formats of the reference
generator).  PIL is imported only where a PNG is written."""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


def save_semantic_png(path: str, gray: np.ndarray) -> None:
    """(H, W) uint8 label map -> 8-bit gray PNG."""
    from PIL import Image

    Image.fromarray(np.asarray(gray, np.uint8), mode="L").save(path)


def save_color_png(path: str, color: np.ndarray) -> None:
    """(H, W, 3) uint8 palette image -> RGB PNG."""
    from PIL import Image

    Image.fromarray(np.asarray(color, np.uint8), mode="RGB").save(path)


def instance_record(rle: Dict[str, Any], bbox: Sequence[float], label: int, category: str,
                    area: int, rbox: Optional[Sequence[float]] = None,
                    rhbox: Optional[Sequence[float]] = None) -> Dict[str, Any]:
    """One per-instance dict of the reference's pkl schema: 'mask' (COCO RLE
    with ascii counts), 'bbox' (the prompt hbox), 'category', 'label',
    'size' (mask area); the rotated pipeline adds 'rbox' and 'rhbox'."""
    if isinstance(rle.get("counts"), bytes):
        rle = {"size": rle["size"], "counts": rle["counts"].decode("ascii")}
    rec: Dict[str, Any] = {
        "mask": rle,
        "bbox": np.asarray(bbox, np.float32),
        "category": str(category),
        "label": int(label),
        "size": int(area),
    }
    if rbox is not None:
        rec["rbox"] = np.asarray(rbox, np.float32)
    if rhbox is not None:
        rec["rhbox"] = np.asarray(rhbox, np.float32)
    return rec


def save_instances_pkl(path: str, records: List[Dict[str, Any]]) -> None:
    with open(path, "wb") as f:
        pickle.dump(records, f)


def ensure_dirs(*paths: str) -> None:
    for p in paths:
        os.makedirs(p, exist_ok=True)
