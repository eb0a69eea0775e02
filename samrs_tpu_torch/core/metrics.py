"""Metrics and meters (mirrors samrs_tpu/core/metrics.py; reference
ED/utils.py:7-53)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


class AverageMeter:
    """Running average (ED/utils.py:7-21)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


def intersection_and_union(pred: torch.Tensor, target: torch.Tensor, num_classes: int,
                           ignore_index: int = 255) -> Tuple[torch.Tensor, torch.Tensor,
                                                             torch.Tensor]:
    """Per-class (intersection, target area, union) histograms on the
    tensors' device (intersectionAndUnionGPU, ED/utils.py:24-53)."""
    pred = pred.reshape(-1).long()
    target = target.reshape(-1).long()
    valid = target != ignore_index
    pred, target = pred[valid], target[valid]
    inter = torch.bincount(pred[pred == target], minlength=num_classes)[:num_classes]
    area_p = torch.bincount(pred, minlength=num_classes)[:num_classes]
    area_t = torch.bincount(target, minlength=num_classes)[:num_classes]
    return inter, area_t, area_p + area_t - inter


def segmentation_scores(inter: np.ndarray, target: np.ndarray, union: np.ndarray,
                        skip_background: bool = False):
    """mIoU / mAcc / mF1 / allAcc from accumulated histograms
    (ED/main_finetune.py:490-529; class 0 left out of the means when
    ``skip_background``)."""
    eps = 1e-10
    iou = inter / (union + eps)
    acc = inter / (target + eps)
    f1 = 2 * inter / (union + inter + eps)
    sl = slice(1, None) if skip_background else slice(None)
    return dict(iou=iou, acc=acc, f1=f1, miou=float(np.mean(iou[sl])),
                macc=float(np.mean(acc[sl])), mf1=float(np.mean(f1[sl])),
                all_acc=float(inter.sum() / (target.sum() + eps)))
