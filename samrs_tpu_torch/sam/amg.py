"""Host helpers of the automatic mask generator (the port's copy of
samrs_tpu/sam/amg.py; reference: segment_anything/utils/amg.py): the
``MaskData`` container, stability score, point grids, crop boxes and the
uncrop functions, the crop-edge test, small-region removal, mask boxes, box
NMS and the RLE helpers over ``samrs_tpu_torch.data.rle``.  numpy and scipy
only.

``box_nms`` is a greedy loop over a stable ``argsort`` of the scores, so
equal scores keep their input order.  ``remove_small_regions`` labels the
8-connected components with ``scipy.ndimage.label`` (the reference calls
``cv2.connectedComponentsWithStats``, which the card's machine does not
have): the same components and areas, numbered in raster order.
"""

from __future__ import annotations

import math
from copy import deepcopy
from typing import Any, Dict, ItemsView, List, Tuple

import numpy as np
from scipy import ndimage

from samrs_tpu_torch.data.rle import _encode_counts, _mask_to_counts, rle_decode

_EIGHT_CONNECTED = np.ones((3, 3), bool)


class MaskData:
    """Dict of parallel arrays / lists with filter and cat (amg.py:16-76)."""

    def __init__(self, **kwargs: Any) -> None:
        for k, v in kwargs.items():
            if not isinstance(v, (list, np.ndarray)):
                raise TypeError(f"MaskData only supports list and ndarray, got {type(v)} for {k}")
        self._stats: Dict[str, Any] = dict(**kwargs)

    def __setitem__(self, key: str, item: Any) -> None:
        self._stats[key] = item

    def __delitem__(self, key: str) -> None:
        del self._stats[key]

    def __getitem__(self, key: str) -> Any:
        return self._stats[key]

    def items(self) -> ItemsView[str, Any]:
        return self._stats.items()

    def filter(self, keep: np.ndarray) -> None:
        for k, v in self._stats.items():
            if v is None:
                continue
            if isinstance(v, np.ndarray):
                self._stats[k] = v[keep]
            elif isinstance(v, list) and keep.dtype == bool:
                self._stats[k] = [a for i, a in enumerate(v) if keep[i]]
            elif isinstance(v, list):
                self._stats[k] = [v[i] for i in keep]
            else:
                raise TypeError(f"MaskData key {k} has unsupported type {type(v)}")

    def cat(self, new_stats: "MaskData") -> None:
        for k, v in new_stats.items():
            if k not in self._stats or self._stats[k] is None:
                self._stats[k] = deepcopy(v)
            elif isinstance(v, np.ndarray):
                self._stats[k] = np.concatenate([self._stats[k], v], axis=0)
            elif isinstance(v, list):
                self._stats[k] = self._stats[k] + deepcopy(v)
            else:
                raise TypeError(f"MaskData key {k} has unsupported type {type(v)}")


def calculate_stability_score(masks: np.ndarray, mask_threshold: float,
                              threshold_offset: float) -> np.ndarray:
    """IoU of the masks thresholded at mask_threshold +- threshold_offset."""
    high = (masks > (mask_threshold + threshold_offset)).sum(axis=(-1, -2), dtype=np.int64)
    low = (masks > (mask_threshold - threshold_offset)).sum(axis=(-1, -2), dtype=np.int64)
    return high / np.maximum(low, 1)


def build_point_grid(n_per_side: int) -> np.ndarray:
    """(n^2, 2) points evenly spaced in [0, 1]^2, x fastest."""
    offset = 1 / (2 * n_per_side)
    points_one_side = np.linspace(offset, 1 - offset, n_per_side)
    px = np.tile(points_one_side[None, :], (n_per_side, 1))
    py = np.tile(points_one_side[:, None], (1, n_per_side))
    return np.stack([px, py], axis=-1).reshape(-1, 2)


def build_all_layer_point_grids(n_per_side: int, n_layers: int,
                                scale_per_layer: int) -> List[np.ndarray]:
    """One point grid per crop layer, n_per_side / scale_per_layer^i a side."""
    return [build_point_grid(int(n_per_side / (scale_per_layer ** i)))
            for i in range(n_layers + 1)]


def generate_crop_boxes(im_size: Tuple[int, int], n_layers: int,
                        overlap_ratio: float) -> Tuple[List[List[int]], List[int]]:
    """xyxy crop boxes of every layer (layer 0 is the image) and their layers."""
    crop_boxes, layer_idxs = [], []
    im_h, im_w = im_size
    short_side = min(im_h, im_w)
    crop_boxes.append([0, 0, im_w, im_h])
    layer_idxs.append(0)

    def crop_len(orig_len: int, n_crops: int, overlap: int) -> int:
        return int(math.ceil((overlap * (n_crops - 1) + orig_len) / n_crops))

    for i_layer in range(n_layers):
        n_crops_per_side = 2 ** (i_layer + 1)
        overlap = int(overlap_ratio * short_side * (2 / n_crops_per_side))
        crop_w = crop_len(im_w, n_crops_per_side, overlap)
        crop_h = crop_len(im_h, n_crops_per_side, overlap)
        crop_box_x0 = [int((crop_w - overlap) * i) for i in range(n_crops_per_side)]
        crop_box_y0 = [int((crop_h - overlap) * i) for i in range(n_crops_per_side)]
        for x0 in crop_box_x0:
            for y0 in crop_box_y0:
                crop_boxes.append([x0, y0, min(x0 + crop_w, im_w), min(y0 + crop_h, im_h)])
                layer_idxs.append(i_layer + 1)
    return crop_boxes, layer_idxs


def uncrop_boxes_xyxy(boxes: np.ndarray, crop_box: List[int]) -> np.ndarray:
    x0, y0, _, _ = crop_box
    return boxes + np.array([[x0, y0, x0, y0]], boxes.dtype)


def uncrop_points(points: np.ndarray, crop_box: List[int]) -> np.ndarray:
    x0, y0, _, _ = crop_box
    return points + np.array([[x0, y0]], points.dtype)


def uncrop_masks(masks: np.ndarray, crop_box: List[int], orig_h: int, orig_w: int) -> np.ndarray:
    x0, y0, x1, y1 = crop_box
    if x0 == 0 and y0 == 0 and x1 == orig_w and y1 == orig_h:
        return masks
    return np.pad(masks, ((0, 0), (y0, orig_h - y1), (x0, orig_w - x1)))


def is_box_near_crop_edge(boxes: np.ndarray, crop_box: List[int], orig_box: List[int],
                          atol: float = 20.0) -> np.ndarray:
    """True for boxes within `atol` of a crop edge that is not an image edge."""
    crop = np.array(crop_box, np.float32)
    orig = np.array(orig_box, np.float32)
    boxes = uncrop_boxes_xyxy(boxes, crop_box).astype(np.float32)
    near_crop = np.isclose(boxes, crop[None], atol=atol, rtol=0)
    near_image = np.isclose(boxes, orig[None], atol=atol, rtol=0)
    return (near_crop & ~near_image).any(axis=1)


def remove_small_regions(mask: np.ndarray, area_thresh: float,
                         mode: str) -> Tuple[np.ndarray, bool]:
    """Fill holes (mode "holes") or drop islands ("islands") of fewer than
    `area_thresh` pixels, 8-connected; returns (mask, changed).  Where every
    island is small the largest stays; of islands tied for largest, the
    first in raster order (cv2 numbers components in another order, so it
    can keep another of them)."""
    if mode not in ("holes", "islands"):
        raise ValueError(f"mode must be 'holes' or 'islands', got {mode!r}")
    correct_holes = mode == "holes"
    working_mask = correct_holes ^ np.asarray(mask, bool)
    regions, n_labels = ndimage.label(working_mask, structure=_EIGHT_CONNECTED)
    sizes = np.bincount(regions.ravel(), minlength=n_labels + 1)[1:]
    small_regions = [i + 1 for i, s in enumerate(sizes) if s < area_thresh]
    if not small_regions:
        return mask, False
    fill_labels = [0] + small_regions
    if not correct_holes:
        fill_labels = [i for i in range(n_labels + 1) if i not in fill_labels]
        if not fill_labels:
            fill_labels = [int(np.argmax(sizes)) + 1]
    return np.isin(regions, fill_labels), True


def batched_mask_to_box(masks: np.ndarray) -> np.ndarray:
    """(..., H, W) bool -> (..., 4) int64 xyxy with inclusive right and
    bottom (the last set column and row); zeros for an empty mask."""
    shape = masks.shape
    h, w = shape[-2:]
    flat = np.asarray(masks, bool).reshape(-1, h, w)
    rows, cols = flat.any(-1), flat.any(-2)
    box = np.stack([cols.argmax(-1), rows.argmax(-1), w - 1 - cols[:, ::-1].argmax(-1),
                    h - 1 - rows[:, ::-1].argmax(-1)], -1).astype(np.int64)
    box[~rows.any(-1)] = 0
    return box.reshape(*shape[:-2], 4)


def box_nms(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float) -> np.ndarray:
    """Greedy NMS over xyxy boxes -> kept indices, best score first; equal
    scores keep their input order (a stable sort)."""
    if len(boxes) == 0:
        return np.zeros(0, np.int64)
    x0, y0, x1, y1 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = np.maximum(x1 - x0, 0) * np.maximum(y1 - y0, 0)
    order = np.argsort(-scores, kind="stable")
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        rest = order[1:]
        xx0 = np.maximum(x0[i], x0[rest])
        yy0 = np.maximum(y0[i], y0[rest])
        xx1 = np.minimum(x1[i], x1[rest])
        yy1 = np.minimum(y1[i], y1[rest])
        inter = np.maximum(xx1 - xx0, 0) * np.maximum(yy1 - yy0, 0)
        iou = inter / np.maximum(areas[i] + areas[rest] - inter, 1e-9)
        order = rest[iou <= iou_threshold]
    return np.asarray(keep, np.int64)


def mask_to_rle(mask: np.ndarray) -> Dict[str, Any]:
    """Binary (H, W) -> uncompressed COCO RLE {'size', 'counts': list of int}."""
    h, w = mask.shape
    return {"size": [int(h), int(w)], "counts": _mask_to_counts(mask).tolist()}


def rle_to_mask(rle: Dict[str, Any]) -> np.ndarray:
    return rle_decode(rle).astype(bool)


def area_from_rle(rle: Dict[str, Any]) -> int:
    return int(sum(rle["counts"][1::2]))


def coco_encode_rle(uncompressed_rle: Dict[str, Any]) -> Dict[str, Any]:
    """Uncompressed -> compressed COCO RLE with ascii counts."""
    return {"size": uncompressed_rle["size"],
            "counts": _encode_counts(uncompressed_rle["counts"]).decode("ascii")}
