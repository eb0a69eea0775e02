"""Sliding-window testing with flip and multi-scale TTA (mirrors
samrs_tpu/train/evaluate.py; reference ED/test_gpu.py).

    python -m samrs_tpu_torch.train.evaluate --checkpoint CKPT --data-root ROOT [...]

  * the crop forward averages the softmax of the normal and the horizontally
    flipped pass (:159-176);
  * ``scale_process`` visits a 2/3-overlap crop grid over the image (padded
    to at least the crop), batches the crops by 8 (the tail batch padded
    with zeros) and averages the summed probabilities by visit count
    (:179-214);
  * multi-scale [0.75, 1.0, 1.25, 1.5, 1.75, 2.0] (:70-74, :236) resizes
    with the port's numpy copy of cv2's INTER_LINEAR (``data.transforms.
    _resize``; the card's machine has no cv2);
  * gray and palette PNGs and the per-class IoU / F1 report (:252-317).

The model runs on its own device (the card unless it was built on the CPU);
accumulation is in fp32 numpy on the host.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from samrs_tpu_torch.core.metrics import intersection_and_union, segmentation_scores
from samrs_tpu_torch.data.transforms import _resize, normalize_image

logger = logging.getLogger("samrs_tpu_torch.evaluate")

DEFAULT_SCALES = (0.75, 1.0, 1.25, 1.5, 1.75, 2.0)


def make_crop_forward(model: torch.nn.Module,
                      flip_tta: bool = True) -> Callable[[np.ndarray], np.ndarray]:
    """(B, ch, cw, 3) normalized crops -> (B, ch, cw, C) softmax probabilities,
    in eval mode on the model's device."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def fwd(batch: np.ndarray) -> np.ndarray:
        model.eval()
        x = torch.from_numpy(np.ascontiguousarray(batch, np.float32)).to(device)
        prob = model(x).float().softmax(-1)
        if flip_tta:
            flipped = model(x.flip(2)).float().softmax(-1).flip(2)
            prob = (prob + flipped) / 2.0
        return prob.cpu().numpy()

    return fwd


def crop_grid(h: int, w: int, crop: int, stride_rate: float = 2.0 / 3.0):
    """(pads (top, bottom, left, right), crop origins [(y, x)]) of the
    sliding window over an (h, w) image (test_gpu.py:179-214)."""
    ph, pw = max(0, crop - h), max(0, crop - w)
    pads = (ph // 2, ph - ph // 2, pw // 2, pw - pw // 2)
    nh, nw = h + ph, w + pw
    stride = int(np.ceil(crop * stride_rate))
    ys = list(range(0, max(nh - crop, 0) + 1, stride))
    xs = list(range(0, max(nw - crop, 0) + 1, stride))
    if ys[-1] + crop < nh:
        ys.append(nh - crop)
    if xs[-1] + crop < nw:
        xs.append(nw - crop)
    return pads, [(y, x) for y in ys for x in xs]


def scale_process(fwd, image: np.ndarray, num_classes: int, crop: int,
                  stride_rate: float = 2.0 / 3.0, batch_crops: int = 8) -> np.ndarray:
    """Sliding window over one (H, W, 3) normalized image -> (H, W, C)
    probabilities, averaged over the crops that cover each pixel."""
    h, w = image.shape[:2]
    (t, b, l_, r), coords = crop_grid(h, w, crop, stride_rate)
    img = np.pad(image, ((t, b), (l_, r), (0, 0)))
    nh, nw = img.shape[:2]
    pred = np.zeros((nh, nw, num_classes), np.float32)
    count = np.zeros((nh, nw, 1), np.float32)
    for i in range(0, len(coords), batch_crops):
        chunk = coords[i:i + batch_crops]
        batch = np.stack([img[y:y + crop, x:x + crop] for y, x in chunk])
        if len(chunk) < batch_crops:  # one batch shape for every call
            batch = np.concatenate(
                [batch, np.zeros((batch_crops - len(chunk), crop, crop, 3), np.float32)])
        probs = fwd(batch)
        for j, (y, x) in enumerate(chunk):
            pred[y:y + crop, x:x + crop] += probs[j]
            count[y:y + crop, x:x + crop] += 1.0
    pred /= np.maximum(count, 1.0)
    return pred[t:t + h, l_:l_ + w]


def predict_probs(fwd, image_u8: np.ndarray, num_classes: int, crop: int,
                  scales: Sequence[float] = (1.0,)) -> np.ndarray:
    """Summed (H, W, C) probabilities of one uint8 HWC image over `scales`."""
    h, w = image_u8.shape[:2]
    total = np.zeros((h, w, num_classes), np.float32)
    for s in scales:
        nh, nw = int(round(h * s)), int(round(w * s))
        scaled = image_u8 if (nh, nw) == (h, w) else _resize(image_u8, (nh, nw), False)
        prob = scale_process(fwd, normalize_image(scaled), num_classes, crop)
        if (nh, nw) != (h, w):
            prob = _resize(prob, (h, w), False)
        total += prob
    return total


def predict_image(fwd, image_u8: np.ndarray, num_classes: int, crop: int,
                  scales: Sequence[float] = (1.0,)) -> np.ndarray:
    """Full TTA prediction for one uint8 HWC image -> (H, W) label map."""
    return predict_probs(fwd, image_u8, num_classes, crop, scales).argmax(-1).astype(np.uint8)


def run_test(model: torch.nn.Module, dataset, num_classes: int, crop: int,
             scales: Sequence[float] = (1.0,), save_dir: Optional[str] = None,
             palette: Optional[np.ndarray] = None, skip_background: bool = False) -> dict:
    """Evaluate a dataset of (uint8 image, int label) pairs; returns the scores
    (per-class IoU / F1 and the means, test_gpu.py:295-317).  With `save_dir`
    writes ``gray/{i:06d}.png`` and, given a palette, ``color/{i:06d}.png``."""
    from PIL import Image

    fwd = make_crop_forward(model)
    hist = np.zeros((3, num_classes))
    if save_dir:
        os.makedirs(os.path.join(save_dir, "gray"), exist_ok=True)
        os.makedirs(os.path.join(save_dir, "color"), exist_ok=True)
    for i in range(len(dataset)):
        image_u8, label = dataset[i]
        pred = predict_image(fwd, image_u8, num_classes, crop, scales)
        iu = intersection_and_union(torch.from_numpy(pred), torch.from_numpy(label), num_classes)
        hist += np.stack([t.numpy() for t in iu])
        if save_dir:
            name = f"{i:06d}.png"
            Image.fromarray(pred, mode="L").save(os.path.join(save_dir, "gray", name))
            if palette is not None:
                Image.fromarray(palette[pred]).save(os.path.join(save_dir, "color", name))
    scores = segmentation_scores(*hist, skip_background=skip_background)
    logger.info("test: mIoU %.4f mF1 %.4f OA %.4f", scores["miou"], scores["mf1"],
                scores["all_acc"])
    return scores


class _RawDataset:
    """A finetune dataset's file list as raw (uint8 image, int32 label) pairs
    for sliding-window testing (no crop augmentation)."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self) -> int:
        return len(self.ds)

    def __getitem__(self, i: int):
        from PIL import Image

        from samrs_tpu_torch.data.datasets import isprs_rgb_to_label

        image = np.asarray(Image.open(self.ds.files[i]).convert("RGB"))
        label = np.asarray(Image.open(self.ds.targets[i]))
        if getattr(self.ds, "NUM_CLASSES", None) == 6 and label.ndim == 3:
            label = isprs_rgb_to_label(label)
        elif label.ndim == 3:
            label = label[..., 0]
        return image, label.astype(np.int32)


def dataset_palette(dataset: str) -> np.ndarray:
    """(256, 3) output palette of a finetune dataset (ED/utils.py:106-137)."""
    from samrs_tpu_torch.data.datasets import ISPRS_PALETTE
    from samrs_tpu_torch.data.mapping import PALETTE

    if dataset not in ("potsdam", "vaihingen"):
        return PALETTE
    palette = np.zeros((256, 3), np.uint8)
    palette[:len(ISPRS_PALETTE)] = ISPRS_PALETTE
    return palette


def main(argv: Optional[Sequence[str]] = None) -> None:
    """CLI: sliding-window test of a finetuned checkpoint (test_gpu.py's CLI)."""
    from samrs_tpu_torch.seg.frameworks import build_seg_model
    from samrs_tpu_torch.train.finetune import FINETUNE_DATASETS

    p = argparse.ArgumentParser(description="SAMRS sliding-window test, one card")
    p.add_argument("--dataset", default="potsdam", choices=sorted(FINETUNE_DATASETS))
    p.add_argument("--backbone", default="vit_b_rvsa")
    p.add_argument("--decoder", default="upernet")
    p.add_argument("--checkpoint", required=True, help="a finetune checkpoint ({tag}.pt)")
    p.add_argument("--data-root", required=True)
    p.add_argument("--crop", type=int, default=0, help="0 = the dataset's image size")
    p.add_argument("--multiscale", action="store_true")
    p.add_argument("--save-dir", default=None)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    ds_cls, num_classes, default_size, skip_bg = FINETUNE_DATASETS[a.dataset]
    crop = a.crop or default_size
    model = build_seg_model(a.backbone, a.decoder, num_classes, crop, a.device)
    tree = torch.load(a.checkpoint, map_location=a.device, weights_only=True)
    model.load_state_dict(tree["model"], strict=True)
    root = os.path.join(a.data_root, a.dataset)
    ds = ds_cls(root, os.path.join(root, "images"), os.path.join(root, "labels"), split="tes")
    run_test(model, _RawDataset(ds), num_classes, crop,
             scales=DEFAULT_SCALES if a.multiscale else (1.0,), save_dir=a.save_dir,
             palette=dataset_palette(a.dataset), skip_background=skip_bg)


if __name__ == "__main__":
    main()
