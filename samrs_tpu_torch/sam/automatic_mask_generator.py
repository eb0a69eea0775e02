"""Automatic mask generation by point-grid prompting over crops (the port of
samrs_tpu/sam/automatic_mask_generator.py; reference:
segment_anything/automatic_mask_generator.py).

Per crop: one encoder pass (``set_image``), then the crop's whole point grid
through ``SamPredictor.amg_sweep``: one multimask decode a chunk of
``points_per_batch`` prompts and K7 on the chunk's masks at the original
size (stability counts, boxes, packed bits), all on the device.  One copy
of the stats comes to the host, where the IoU, stability and crop-edge
filters and the crop's box NMS pick the masks whose bits come over in one
gathered copy, to become RLEs.  Then the cross-crop NMS, small-region
removal and the records.

    SamAutomaticMaskGenerator(SamPredictor(build_sam("vit_h"))).generate(image)
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from samrs_tpu_torch.sam.amg import (MaskData, batched_mask_to_box, box_nms,
                                     build_all_layer_point_grids, coco_encode_rle,
                                     generate_crop_boxes, is_box_near_crop_edge, mask_to_rle,
                                     remove_small_regions, rle_to_mask, uncrop_boxes_xyxy,
                                     uncrop_masks, uncrop_points)
from samrs_tpu_torch.sam.predictor import SamPredictor, _to_numpy, unpackbits2d

OUTPUT_MODES = ("binary_mask", "uncompressed_rle", "coco_rle")


class SamAutomaticMaskGenerator:
    def __init__(self, predictor: SamPredictor, points_per_side: Optional[int] = 32,
                 points_per_batch: int = 64, pred_iou_thresh: float = 0.88,
                 stability_score_thresh: float = 0.95, stability_score_offset: float = 1.0,
                 box_nms_thresh: float = 0.7, crop_n_layers: int = 0,
                 crop_nms_thresh: float = 0.7, crop_overlap_ratio: float = 512 / 1500,
                 crop_n_points_downscale_factor: int = 1,
                 point_grids: Optional[List[np.ndarray]] = None, min_mask_region_area: int = 0,
                 output_mode: str = "binary_mask") -> None:
        if (points_per_side is None) == (point_grids is None):
            raise ValueError("Exactly one of points_per_side or point_grids must be provided.")
        if output_mode not in OUTPUT_MODES:
            raise ValueError(f"output_mode must be one of {OUTPUT_MODES}, got {output_mode!r}")
        if points_per_side is not None:
            self.point_grids = build_all_layer_point_grids(points_per_side, crop_n_layers,
                                                           crop_n_points_downscale_factor)
        else:
            self.point_grids = point_grids
        self.predictor = predictor
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.stability_score_offset = stability_score_offset
        self.box_nms_thresh = box_nms_thresh
        self.crop_n_layers = crop_n_layers
        self.crop_nms_thresh = crop_nms_thresh
        self.crop_overlap_ratio = crop_overlap_ratio
        self.min_mask_region_area = min_mask_region_area
        self.output_mode = output_mode

    def generate(self, image: np.ndarray) -> List[Dict[str, Any]]:
        """(H, W, 3) uint8 -> mask records: segmentation (per output_mode),
        area, bbox (xywh), predicted_iou, point_coords, stability_score,
        crop_box (xywh)."""
        mask_data = self._generate_masks(image)
        if self.min_mask_region_area > 0:
            mask_data = self.postprocess_small_regions(
                mask_data, self.min_mask_region_area,
                max(self.box_nms_thresh, self.crop_nms_thresh))
        if self.output_mode == "coco_rle":
            segmentations = [coco_encode_rle(r) for r in mask_data["rles"]]
        elif self.output_mode == "binary_mask":
            segmentations = [rle_to_mask(r) for r in mask_data["rles"]]
        else:
            segmentations = mask_data["rles"]
        return [{"segmentation": seg,
                 "area": int(sum(mask_data["rles"][i]["counts"][1::2])),
                 "bbox": _xyxy_to_xywh(mask_data["boxes"][i]).tolist(),
                 "predicted_iou": float(mask_data["iou_preds"][i]),
                 "point_coords": [mask_data["points"][i].tolist()],
                 "stability_score": float(mask_data["stability_score"][i]),
                 "crop_box": _xyxy_to_xywh(np.asarray(mask_data["crop_boxes"][i])).tolist()}
                for i, seg in enumerate(segmentations)]

    def _generate_masks(self, image: np.ndarray) -> MaskData:
        orig_size = image.shape[:2]
        crop_boxes, layer_idxs = generate_crop_boxes(orig_size, self.crop_n_layers,
                                                     self.crop_overlap_ratio)
        data = MaskData()
        for crop_box, layer_idx in zip(crop_boxes, layer_idxs):
            data.cat(self._process_crop(image, crop_box, layer_idx, orig_size))
        if len(crop_boxes) > 1 and len(data["boxes"]):
            # prefer masks from smaller crops
            scores = 1.0 / np.array([box_area(b) for b in data["crop_boxes"]])
            data.filter(box_nms(data["boxes"].astype(np.float32), scores, self.crop_nms_thresh))
        return data

    def _process_crop(self, image: np.ndarray, crop_box: List[int], crop_layer_idx: int,
                      orig_size) -> MaskData:
        x0, y0, x1, y1 = crop_box
        cropped_im = image[y0:y1, x0:x1, :]
        cropped_im_size = cropped_im.shape[:2]
        self.predictor.set_image(cropped_im)
        points_scale = np.array(cropped_im_size)[None, ::-1]
        points_for_image = self.point_grids[crop_layer_idx] * points_scale
        data = self._process_points(points_for_image, crop_box, orig_size)
        self.predictor.reset_image()
        data["boxes"] = uncrop_boxes_xyxy(data["boxes"], crop_box)
        data["points"] = uncrop_points(data["points"], crop_box)
        data["crop_boxes"] = [crop_box for _ in range(len(data["rles"]))]
        return data

    def _process_points(self, points: np.ndarray, crop_box: List[int], orig_size) -> MaskData:
        """The crop's whole grid through ``amg_sweep``, one copy of its
        stats, the filters and the crop's box NMS on the host, then the
        survivors' bits in one gathered copy -> MaskData in the NMS's order
        (best IoU prediction first).  The NMS reads only boxes and IoU
        predictions, so it runs before the bits are fetched: only its
        survivors become RLEs."""
        orig_h, orig_w = orig_size
        pred = self.predictor
        n, nb = len(points), self.points_per_batch
        G = max(1, -(-n // nb))
        # one positive point a prompt set, with its not-a-point pad; sets past
        # n are all padding and sliced away after the fetch
        pts, labs = pred._prompts_to_points(points.astype(np.float32)[:, None],
                                            np.ones((n, 1), np.int64), None)
        pts, labs = pred._pad_prompts(pts, labs, G * nb)
        stats_d, packed = pred.amg_sweep(pts.reshape(G, nb, 2, 2), labs.reshape(G, nb, 2),
                                         self.stability_score_offset)
        nm = stats_d.shape[1]  # masks a prompt set: 3, multimask
        stats = _to_numpy(stats_d)[:n]
        iou_preds = stats[..., 0].reshape(-1)
        hi = stats[..., 1].reshape(-1).astype(np.int64)
        lo = stats[..., 2].reshape(-1).astype(np.int64)
        stability = hi / np.maximum(lo, 1)
        boxes = stats[..., 3:7].reshape(-1, 4).astype(np.int64)

        keep = np.ones(n * nm, bool)
        if self.pred_iou_thresh > 0.0:
            keep &= iou_preds > self.pred_iou_thresh
        if self.stability_score_thresh > 0.0:
            keep &= stability >= self.stability_score_thresh
        keep &= ~is_box_near_crop_edge(boxes, crop_box, [0, 0, orig_w, orig_h])
        idx = np.nonzero(keep)[0]
        idx = idx[box_nms(boxes[idx].astype(np.float32), iou_preds[idx], self.box_nms_thresh)]

        masks = unpackbits2d(pred.amg_take_packed(packed, idx), pred.original_size[1])
        masks = uncrop_masks(masks, crop_box, orig_h, orig_w)
        return MaskData(iou_preds=iou_preds[idx], points=np.repeat(points, nm, axis=0)[idx],
                        stability_score=stability[idx], boxes=boxes[idx],
                        rles=[mask_to_rle(m) for m in masks])

    @staticmethod
    def postprocess_small_regions(mask_data: MaskData, min_area: int,
                                  nms_thresh: float) -> MaskData:
        """Fill small holes and drop small islands of every mask, then an NMS
        that prefers the masks left unchanged; a changed mask that survives
        takes its new RLE and box."""
        if len(mask_data["rles"]) == 0:
            return mask_data
        new_masks, scores = [], []
        for rle in mask_data["rles"]:
            mask = rle_to_mask(rle)
            mask, changed = remove_small_regions(mask, min_area, mode="holes")
            unchanged = not changed
            mask, changed = remove_small_regions(mask, min_area, mode="islands")
            unchanged = unchanged and not changed
            new_masks.append(mask)
            scores.append(float(unchanged))
        masks = np.stack(new_masks)
        boxes = batched_mask_to_box(masks)
        keep = box_nms(boxes.astype(np.float32), np.asarray(scores), nms_thresh)
        for i in keep:
            if scores[i] == 0.0:
                mask_data["rles"][i] = mask_to_rle(masks[i])
                mask_data["boxes"][i] = boxes[i]
        mask_data.filter(keep)
        return mask_data


def box_area(box) -> float:
    return max(box[2] - box[0], 0) * max(box[3] - box[1], 0)


def _xyxy_to_xywh(box: np.ndarray) -> np.ndarray:
    return np.array([box[0], box[1], box[2] - box[0], box[3] - box[1]])
