"""The reference's batched end-to-end API, ``sam_forward_batched`` (the port
of samrs_tpu/sam/api.py; reference GD/segment_anything/modeling/sam.py:53-131).

``Sam.forward(batched_input, multimask_output)`` there takes a list of
per-image dicts {'image' (3, H, W) or (H, W, 3) uint8, 'original_size',
'point_coords', 'point_labels', 'boxes', 'mask_inputs'} and returns per-image
dicts {'masks', 'iou_predictions', 'low_res_logits'}.  Here the images go
through one encoder pass (``SamPredictor.encode_images``), then each image's
prompts decode against its features (``predict_boxes`` or ``predict``).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from samrs_tpu_torch.sam.predictor import SamPredictor


def sam_forward_batched(predictor: SamPredictor, batched_input: List[Dict[str, Any]],
                        multimask_output: bool = False) -> List[Dict[str, Any]]:
    """Per-image dicts of prompts -> per-image dicts of host arrays: masks
    (N, M, H, W) bool at the original size, iou_predictions (N, M),
    low_res_logits (N, M, 4g, 4g); N is the number of boxes, or 1."""
    images = []
    for rec in batched_input:
        img = np.asarray(rec["image"])
        if img.ndim == 3 and img.shape[0] == 3:  # CHW -> HWC
            img = img.transpose(1, 2, 0)
        images.append(img.astype(np.uint8))
    outputs: List[Dict[str, Any]] = []
    for rec, enc in zip(batched_input, predictor.encode_images(images)):
        predictor.set_image_features(*enc)
        if rec.get("boxes") is not None:
            boxes = np.asarray(rec["boxes"], np.float32).reshape(-1, 4)
            masks, iou, low_res = predictor.predict_boxes(boxes, multimask_output=multimask_output)
        else:
            pc, pl, mi = rec.get("point_coords"), rec.get("point_labels"), rec.get("mask_inputs")
            masks, iou, low_res = predictor.predict(
                point_coords=None if pc is None else np.asarray(pc, np.float32).reshape(-1, 2),
                point_labels=None if pl is None else np.asarray(pl, np.int64).reshape(-1),
                mask_input=None if mi is None else np.asarray(mi, np.float32),
                multimask_output=multimask_output)
            masks, iou, low_res = masks[None], iou[None], low_res[None]
        outputs.append({"masks": masks, "iou_predictions": iou, "low_res_logits": low_res})
    predictor.reset_image()
    return outputs
