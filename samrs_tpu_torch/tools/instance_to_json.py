"""Binary instance stacks -> COCO JSON dicts for the HRSC prompt evaluation
(the port's copy of samrs_tpu/tools/instance_to_json.py; reference
GD/instance_to_json.py): a ground-truth dict of images, annotations and the
one category 'ship' (id 0), and a results list with scores, both with
compressed RLE whose counts are ascii strings.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Sequence

import numpy as np

from samrs_tpu_torch.data.rle import rle_encode


def _ascii_rle(mask: np.ndarray) -> Dict[str, Any]:
    rle = rle_encode(np.asarray(mask, np.uint8))
    return {"size": rle["size"], "counts": rle["counts"].decode("ascii")}


def binary_to_coco_gt(binary_list: Sequence[np.ndarray],
                      img_name_list: Sequence[str]) -> Dict[str, Any]:
    """Per-image (C, H, W) instance stacks -> COCO ground-truth dict."""
    coco: Dict[str, Any] = {
        "images": [],
        "annotations": [],
        "categories": [{"id": 0, "name": "ship", "supercategory": "None"}],
    }
    for n, stack in enumerate(binary_list):
        _, H, W = stack.shape
        coco["images"].append({"id": int(n), "width": int(W), "height": int(H),
                               "file_name": f"{img_name_list[n]}.png"})
    ann_id = 0
    for n, stack in enumerate(binary_list):
        for m in stack:
            coco["annotations"].append({"id": int(ann_id), "image_id": int(n), "category_id": 0,
                                        "area": int(m.sum()), "iscrowd": 0,
                                        "segmentation": _ascii_rle(m), "attributes": {}})
            ann_id += 1
    return coco


def binary_to_coco_pre(binary_list: Sequence[np.ndarray],
                       score_list: Sequence[np.ndarray]) -> List[Dict[str, Any]]:
    """Per-image prediction stacks and their scores -> COCO results list."""
    out: List[Dict[str, Any]] = []
    for n, stack in enumerate(binary_list):
        scores = np.asarray(score_list[n]).reshape(-1)
        for c, m in enumerate(stack):
            out.append({"image_id": int(n), "category_id": 0, "segmentation": _ascii_rle(m),
                        "score": float(scores[c])})
    return out


def save_json(obj: Any, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)
