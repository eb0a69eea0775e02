"""HRSC2016 prompt-type evaluation (the port of
samrs_tpu/generate/instance_eval.py; reference:
GD/main_sam_{hbox,rbox,rhbox}_mask_instance.py).

Per image: the per-instance ground truth from the colour-coded LandMask PNG,
one encoder pass, and every instance's prompt decoded in one bucket-padded
batch: its centre point (``predict_points``), its hbox or the hbox of its
rotated box (``predict_boxes``), or its hbox / rotated polygon rasterised
into a +-1000 low-res logit canvas as a mask-only prompt
(``predict_mask_prompts``).  Metrics: the mean instance IoU and the
area-weighted IoU; the ground truth and the predictions can be written as
COCO JSON and the overlays as PNGs.

The canvases need no cv2 (the card's machine has none): the resizes are
``data.transforms._resize`` (cv2's INTER_LINEAR), the border a constant
pad, and ``fill_poly`` rasterises a polygon pixel for pixel as
``cv2.fillPoly`` does it (8-connected outline, fixed-point scanline fill).

    python -m samrs_tpu_torch.generate.instance_eval --prompt hbox \\
        --image-dir IMAGES --ann-dir XML --landmask-dir LANDMASK --json-dir OUT
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from samrs_tpu_torch.data.loaders import Annotation, load_hrsc
from samrs_tpu_torch.data.transforms import _resize
from samrs_tpu_torch.geometry.obb import poly_to_hbb
from samrs_tpu_torch.sam.predictor import SamPredictor
from samrs_tpu_torch.sam.transforms import ResizeLongestSide
from samrs_tpu_torch.tools.instance_to_json import binary_to_coco_gt, binary_to_coco_pre, save_json

PROMPT_MODES = ("point", "hbox", "hbox_mask", "rbox_mask", "rhbox")
_XY_SHIFT = 16  # cv2's fixed-point fraction bits for polygon edges


def gt_masks_from_landmask(land_mask_rgb: np.ndarray, colors: np.ndarray) -> np.ndarray:
    """Colour-coded LandMask (H, W, 3) and per-instance colours -> (N, H, W) uint8."""
    return np.stack([np.all(land_mask_rgb == c.reshape(1, 1, 3), axis=2).astype(np.uint8)
                     for c in colors])


def _clip_line(w: int, h: int, p1: Tuple[int, int], p2: Tuple[int, int]):
    """cv2's clipLine on the (w, h) image: (inside, p1, p2) with the
    endpoints moved onto the image's border rows and columns."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _line8(mask: np.ndarray, p1: Tuple[int, int], p2: Tuple[int, int]) -> None:
    """cv2's 8-connected line (its LineIterator, left to right) into `mask`."""
    h, w = mask.shape
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h and 0 <= p2[1] < h):
        inside, p1, p2 = _clip_line(w, h, p1, p2)
        if not inside:
            return
    if p2[0] < p1[0]:
        p1, p2 = p2, p1
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    major, minor = max(dx, dy), min(dx, dy)
    i = np.arange(major + 1)
    # Bresenham: the minor coordinate steps while its error term is negative
    m = (2 * minor * i + major - 1) // (2 * major) if major else i
    if dy > dx:
        mask[p1[1] + sy * i, p1[0] + m] = 1
    else:
        mask[p1[1] + sy * m, p1[0] + i] = 1


def fill_poly(mask: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Fill the integer polygon `poly` (K, 2) xy into the (H, W) `mask` in
    place as cv2.fillPoly(mask, [poly], 1) does with its defaults (8-connected
    lines, no shift): the outline's lines, then every row's spans between
    pairs of edges, each edge's x in 16.16 fixed point stepped by its
    truncated slope, from the ceiling of the left x to the floor of the
    right; an edge that leaves the image starts from its clipped ends."""
    h, w = mask.shape
    v = [(int(x), int(y)) for x, y in np.asarray(poly).reshape(-1, 2)]
    edges = []  # (y0, y1, x at y0, dx a row), fixed point, y0 < y1
    pt0 = v[-1]
    for pt1 in v:
        _line8(mask, pt0, pt1)
        c0, c1 = (pt0[0] << _XY_SHIFT, pt0[1]), (pt1[0] << _XY_SHIFT, pt1[1])
        if not (0 <= pt0[0] < w and 0 <= pt1[0] < w and 0 <= pt0[1] < h and 0 <= pt1[1] < h):
            _, t0, t1 = _clip_line(w, h, pt0, pt1)
            if t0[1] != t1[1]:
                c0, c1 = (t0[0] << _XY_SHIFT, t0[1]), (t1[0] << _XY_SHIFT, t1[1])
        if pt0[1] != pt1[1]:
            num, den = c1[0] - c0[0], c1[1] - c0[1]
            d = abs(num) // abs(den) * (1 if (num >= 0) == (den > 0) else -1)  # C's division
            top, c = (pt0, c0) if pt0[1] < pt1[1] else (pt1, c1)
            edges.append((top[1], max(pt0[1], pt1[1]), c[0] + (top[1] - c[1]) * d, d))
        pt0 = pt1
    if len(edges) < 2:
        return mask
    y0, y1, x0, d = (np.array(a, np.int64) for a in zip(*edges))
    rows = np.arange(max(int(y0.min()), 0), min(int(y1.max()), h))
    if not rows.size:
        return mask
    live = (y0[None] <= rows[:, None]) & (rows[:, None] < y1[None])
    never = np.iinfo(np.int64).max
    xs = np.sort(np.where(live, x0[None] + (rows[:, None] - y0[None]) * d[None], never), 1)
    if xs.shape[1] % 2:
        xs = np.concatenate([xs, np.full((len(rows), 1), never)], 1)
    left, right = xs[:, 0::2], xs[:, 1::2]
    x_lo = (left + (1 << _XY_SHIFT) - 1) >> _XY_SHIFT
    x_hi = right >> _XY_SHIFT
    ok = (right != never) & (x_lo < w) & (x_hi >= 0)
    x_lo, x_hi = np.maximum(x_lo, 0), np.minimum(x_hi, w - 1)
    ok &= x_lo <= x_hi
    r = np.broadcast_to(np.arange(len(rows))[:, None], ok.shape)[ok]
    runs = np.zeros((len(rows), w + 1), np.int32)
    np.add.at(runs, (r, x_lo[ok]), 1)
    np.add.at(runs, (r, x_hi[ok] + 1), -1)
    mask[rows] |= (np.cumsum(runs, 1)[:, :w] > 0).astype(mask.dtype)
    return mask


def _canvas_prompt(logit: np.ndarray, img_size: int, lowres: int) -> np.ndarray:
    """A +-1000 logit canvas at the image's size -> the low-res mask prompt:
    resized as the image is (longest side to img_size), padded with -1000 to
    the square, resized to lowres (cv2's INTER_LINEAR both times)."""
    th, tw = ResizeLongestSide.get_preprocess_shape(logit.shape[0], logit.shape[1], img_size)
    m = _resize(logit, (th, tw), is_mask=False)
    m = np.pad(m, ((0, img_size - th), (0, img_size - tw)), constant_values=-1000.0)
    return _resize(m, (lowres, lowres), is_mask=False)


def box_as_mask_prompt(box: np.ndarray, image_hw: Tuple[int, int], img_size: int = 1024,
                       lowres: int = 256) -> np.ndarray:
    """xyxy box -> (lowres, lowres) mask prompt, +1000 inside the box
    (inclusive integer edges), -1000 outside."""
    canvas = np.full(image_hw, -1000.0, np.float32)
    x0, y0, x1, y1 = (int(v) for v in box)
    canvas[max(y0, 0):y1 + 1, max(x0, 0):x1 + 1] = 1000.0
    return _canvas_prompt(canvas, img_size, lowres)


def poly_as_mask_prompt(poly: np.ndarray, image_hw: Tuple[int, int], img_size: int = 1024,
                        lowres: int = 256) -> np.ndarray:
    """Rotated polygon (its vertices cast to int32, as the reference does)
    -> (lowres, lowres) mask prompt, +1000 on its ``fill_poly`` pixels."""
    inside = fill_poly(np.zeros(image_hw, np.uint8), np.asarray(poly).reshape(-1, 2)
                       .astype(np.int32))
    return _canvas_prompt(np.where(inside > 0, 1000.0, -1000.0).astype(np.float32), img_size,
                          lowres)


def predict_instances(predictor: SamPredictor, image: np.ndarray, ann: Annotation,
                      prompt: str) -> Tuple[np.ndarray, np.ndarray]:
    """One image and its annotation -> ((N, H, W) uint8 masks, (N,) IoU
    predictions) for prompt mode `prompt`."""
    if prompt not in PROMPT_MODES:
        raise KeyError(f"unknown prompt mode {prompt!r}; have {PROMPT_MODES}")
    hw = image.shape[:2]
    predictor.set_image(image)
    n = ann.num_instances
    if prompt == "point":
        masks, scores, _ = predictor.predict_points(ann.points[:n])
    elif prompt in ("hbox", "rhbox"):
        boxes = poly_to_hbb(ann.polys.reshape(-1, 8)) if prompt == "rhbox" else ann.hboxes
        masks, scores, _ = predictor.predict_boxes(boxes)
    else:
        cfg = predictor.cfg
        lowres = cfg.grid_size * 4
        if prompt == "hbox_mask":
            prompts = [box_as_mask_prompt(ann.hboxes[i], hw, cfg.image_size, lowres)
                       for i in range(n)]
        else:
            prompts = [poly_as_mask_prompt(ann.polys[i], hw, cfg.image_size, lowres)
                       for i in range(n)]
        masks, scores, _ = predictor.predict_mask_prompts(np.stack(prompts))
    return masks[:, 0].astype(np.uint8), scores[:, 0]


def miou_metrics(pred_masks: Sequence[np.ndarray],
                 gt_masks: Sequence[np.ndarray]) -> Dict[str, float]:
    """Mean instance IoU and area-weighted IoU over instances with a
    non-empty union."""
    ious, inters, unions = [], [], []
    for preds, gts in zip(pred_masks, gt_masks):
        for p, g in zip(preds, gts):
            inter = float(np.sum(p.astype(bool) & g.astype(bool)))
            union = float(np.sum(p.astype(bool) | g.astype(bool)))
            if union > 0:
                ious.append(inter / union)
                inters.append(inter)
                unions.append(union)
    return {"miou_avg": float(np.mean(ious)) if ious else 0.0,
            "miou_area": float(np.sum(inters) / np.sum(unions)) if unions else 0.0,
            "num_instances": len(ious)}


def _find_image(image_dir: str, name: str) -> Optional[str]:
    paths = [os.path.join(image_dir, name + ext) for ext in (".bmp", ".png", ".jpg")]
    return next((p for p in paths if os.path.exists(p)), None)


def run_prompt_eval(predictor: SamPredictor, image_dir: str, ann_dir: str, landmask_dir: str,
                    names: Sequence[str], prompt: str = "hbox", json_dir: Optional[str] = None,
                    vis_dir: Optional[str] = None) -> Dict[str, float]:
    """Evaluate prompt mode `prompt` over the named HRSC images -> metrics;
    writes gt_ins_{prompt}.json / sam_ins_{prompt}.json into `json_dir` and
    out_{prompt}_prompt_{name}.png overlays into `vis_dir` where given."""
    from PIL import Image

    from samrs_tpu_torch.tools.visualize import overlay_instances

    all_pred: List[np.ndarray] = []
    all_gt, all_scores, used = [], [], []
    for name in names:
        ann = load_hrsc(name, ann_dir)
        if ann.error and ann.num_instances == 0:
            continue
        img_path = _find_image(image_dir, name)
        if img_path is None:
            continue
        with Image.open(img_path) as im:
            image = np.asarray(im.convert("RGB"))
        with Image.open(os.path.join(landmask_dir, name + ".png")) as im:
            land = np.asarray(im.convert("RGB"))
        gt = gt_masks_from_landmask(land, ann.colors)
        pred, scores = predict_instances(predictor, image, ann, prompt)
        if vis_dir:
            os.makedirs(vis_dir, exist_ok=True)
            Image.fromarray(overlay_instances(image, pred, boxes=ann.hboxes, points=ann.points)
                            ).save(os.path.join(vis_dir, f"out_{prompt}_prompt_{name}.png"))
        all_pred.append(pred)
        all_gt.append(gt)
        all_scores.append(scores)
        used.append(name)
    metrics = miou_metrics(all_pred, all_gt)
    print(f"[{prompt}] Average mIoU: {metrics['miou_avg']:.4f} "
          f"Area mIoU: {metrics['miou_area']:.4f} ({metrics['num_instances']} instances)")
    if json_dir:
        os.makedirs(json_dir, exist_ok=True)
        save_json(binary_to_coco_gt(all_gt, used), os.path.join(json_dir, f"gt_ins_{prompt}.json"))
        save_json(binary_to_coco_pre(all_pred, all_scores),
                  os.path.join(json_dir, f"sam_ins_{prompt}.json"))
    return metrics


def main(argv: Optional[Sequence[str]] = None) -> None:
    from samrs_tpu_torch.generate.semantic import parse_sam_overrides
    from samrs_tpu_torch.sam.build import build_sam

    p = argparse.ArgumentParser(description="HRSC SAM prompt-type evaluation (PyTorch, CUDA)")
    p.add_argument("--prompt", default="hbox", choices=PROMPT_MODES)
    p.add_argument("--sam-variant", default="vit_h")
    p.add_argument("--sam-checkpoint", default=None)
    p.add_argument("--image-dir", required=True)
    p.add_argument("--ann-dir", required=True)
    p.add_argument("--landmask-dir", required=True)
    p.add_argument("--json-dir", default=None)
    p.add_argument("--vis-dir", default=None, help="per-image overlay PNGs")
    p.add_argument("--device", default="cuda")
    p.add_argument("--sam-override", action="append", default=[], metavar="KEY=VALUE",
                   help="SamConfig field override (e.g. image_size=256)")
    a = p.parse_args(argv)
    model = build_sam(a.sam_variant, checkpoint=a.sam_checkpoint, device=a.device,
                      **parse_sam_overrides(a.sam_override))
    names = sorted(os.path.splitext(f)[0] for f in os.listdir(a.ann_dir) if f.endswith(".xml"))
    run_prompt_eval(SamPredictor(model), a.image_dir, a.ann_dir, a.landmask_dir, names,
                    a.prompt, a.json_dir, a.vis_dir)


if __name__ == "__main__":
    main()
