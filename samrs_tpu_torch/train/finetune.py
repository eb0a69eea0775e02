"""Single-dataset finetuning on one card (mirrors samrs_tpu/train/finetune.py;
reference ED/main_finetune.py).

    python -m samrs_tpu_torch.train.finetune [key=value ...]

takes the JAX entry point's ``FinetuneConfig`` and dotted overrides
(``dataset=potsdam``, ``data.root=...``, ``epochs=...``, ``pretrained=...``),
plus ``device=cpu`` for a run on the CPU (the card otherwise).  Potsdam /
Vaihingen / iSAID at 512 / 512 / 896 (:166-229) under ``data.root/<dataset>``
(train.txt / valid.txt, ``images/``, ``labels/``); ``SegModel`` with one head;
layer-decay AdamW on a per-step warmup-cosine schedule; per epoch the
validation scores (mIoU / mF1 / OA, iSAID without the background class,
:490-529) and the ``last`` / ``best`` checkpoints.  ``pretrained`` grafts a
SEP encoder checkpoint (the ``{tag}_encoder.pt`` that ``run_pretrain``
writes), its pos-embed resized to the new grid with torch's bicubic
(:290-361).
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from samrs_tpu_torch.core.checkpoint import save_train_state
from samrs_tpu_torch.core.config import FinetuneConfig
from samrs_tpu_torch.core.metrics import segmentation_scores
from samrs_tpu_torch.data.datasets import DataLoader, ISAIDDataset, ISPRSDataset
from samrs_tpu_torch.data.transforms import EvalAugment, TrainAugment
from samrs_tpu_torch.seg.frameworks import SegModel, build_seg_model
from samrs_tpu_torch.train.optim import (Optimizer, backbone_optim_settings,
                                         warmup_cosine_schedule)
from samrs_tpu_torch.train.pretrain import to_device
from samrs_tpu_torch.train.trainer import TrainState, eval_step, finetune_step

logger = logging.getLogger("samrs_tpu_torch.finetune")

FINETUNE_DATASETS = {
    # name: (dataset class, num_classes, image size, skip background in the means)
    "potsdam": (ISPRSDataset, 6, 512, False),
    "vaihingen": (ISPRSDataset, 6, 512, False),
    "isaid": (ISAIDDataset, 16, 896, True),
}


def interp_pos_embed(state: Dict[str, torch.Tensor],
                     target: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Any ``pos_embed`` (1, g*g, D) of `state` whose token count differs from
    `target`'s, bicubic-resized on its (g, g) grid with
    ``F.interpolate(align_corners=False)``, as the reference resizes a
    checkpoint (ED/main_finetune.py:290-332)."""
    out = dict(state)
    for k, v in state.items():
        t = target.get(k)
        if not k.endswith("pos_embed") or t is None or v.shape == t.shape or v.dim() != 3:
            continue
        g_old, g_new = round(v.shape[1] ** 0.5), round(t.shape[1] ** 0.5)
        if g_old * g_old != v.shape[1] or g_new * g_new != t.shape[1]:
            continue
        grid = v.float().reshape(1, g_old, g_old, -1).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, size=(g_new, g_new), mode="bicubic", align_corners=False)
        out[k] = grid.permute(0, 2, 3, 1).reshape(1, g_new * g_new, -1).to(v.dtype)
        logger.info("%s interpolated %dx%d -> %dx%d", k, g_old, g_old, g_new, g_new)
    return out


def load_pretrained_encoder(model: SegModel, ckpt_path: str) -> None:
    """Graft a SEP encoder checkpoint (``{"model": encoder state dict}``) into
    `model.encoder`, strictly, with the pos-embed resized to the model's grid.
    RVSA's window-local rel-pos tables are resolution-independent and load
    as they are (main_finetune.py:290-361)."""
    dev = next(model.parameters()).device
    sd = torch.load(ckpt_path, map_location=dev, weights_only=True)["model"]
    model.encoder.load_state_dict(interp_pos_embed(sd, model.encoder.state_dict()), strict=True)


def evaluate_simple(model: SegModel, dataset_val, num_classes: int, skip_bg: bool,
                    batch_size: int = 8) -> dict:
    """Scores on the validation split; the tail batch is padded to
    `batch_size` with ignored labels, so every image counts once."""
    device = next(model.parameters()).device
    hist = torch.zeros(3, num_classes, dtype=torch.int64, device=device)
    loader = DataLoader(dataset_val, batch_size=batch_size, shuffle=False, drop_last=False)
    for x, y in loader:
        if x.shape[0] < batch_size:
            pad = batch_size - x.shape[0]
            x = np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])
            y = np.concatenate([y, np.full((pad, *y.shape[1:]), 255, y.dtype)])
        hist += torch.stack(eval_step(model, to_device(x, device), to_device(y, device),
                                      num_classes))
    inter, target, union = hist.cpu().numpy().astype(np.float64)
    return segmentation_scores(inter, target, union, skip_background=skip_bg)


def build_datasets(cfg: FinetuneConfig, size: int):
    ds_cls = FINETUNE_DATASETS[cfg.dataset][0]
    root = os.path.join(cfg.data.root, cfg.dataset)
    paths = (root, os.path.join(root, "images"), os.path.join(root, "labels"))
    trn = ds_cls(*paths, split="trn", transform=TrainAugment(size, seed=cfg.seed))
    val = ds_cls(*paths, split="val", transform=EvalAugment(size), val_images=cfg.data.val_images)
    return trn, val


def run_finetune(cfg: FinetuneConfig, model: Optional[SegModel] = None, dataset_trn=None,
                 dataset_val=None) -> TrainState:
    """The epoch loop; the model and datasets are injectable (tests).  Runs on
    ``cfg.device`` and never moves elsewhere."""
    _, num_classes, default_size, skip_bg = FINETUNE_DATASETS[cfg.dataset]
    size = cfg.image_size or default_size
    device = torch.device(cfg.device)
    if model is None:
        model = build_seg_model(cfg.backbone, cfg.decoder, num_classes, size, device,
                                torch.Generator(device=device).manual_seed(cfg.seed))
    model.to(device)
    if cfg.pretrained:
        load_pretrained_encoder(model, cfg.pretrained)
        logger.info("loaded pretrained encoder from %s", cfg.pretrained)
    if dataset_trn is None:
        dataset_trn, dataset_val = build_datasets(cfg, size)

    loader = DataLoader(dataset_trn, batch_size=cfg.batch_size, seed=cfg.seed,
                        num_threads=cfg.data.num_workers)
    total_steps = max(len(loader), 1) * cfg.epochs
    sched = warmup_cosine_schedule(cfg.optim.lr, total_steps, cfg.optim.warmup_iters,
                                   cfg.optim.min_lr_ratio)
    bset = backbone_optim_settings(cfg.backbone, model.encoder)
    opt = Optimizer(model, sched, weight_decay=cfg.optim.weight_decay,
                    betas=tuple(cfg.optim.betas), grad_clip=cfg.optim.grad_clip,
                    layer_decay=cfg.optim.layer_decay, num_layers=bset["num_layers"],
                    optimizer=cfg.optim.optimizer)
    state = TrainState(0, model, opt)
    logger.info("finetune %s: %d images, batch %d, %d steps on %s", cfg.dataset,
                len(dataset_trn), cfg.batch_size, total_steps, device)

    best = -1.0
    for epoch in range(cfg.epochs):
        t0 = time.perf_counter()
        losses = []
        for x, y in loader:
            metrics = finetune_step(state, to_device(x, device), to_device(y, device),
                                    cfg.seed + 2)
            losses.append(metrics["loss"])
        scores = evaluate_simple(model, dataset_val, num_classes, skip_bg)
        loss = float(torch.stack(losses).mean()) if losses else 0.0
        logger.info("epoch %d/%d loss %.4f mIoU %.4f mF1 %.4f OA %.4f (%.1fs)", epoch + 1,
                    cfg.epochs, loss, scores["miou"], scores["mf1"], scores["all_acc"],
                    time.perf_counter() - t0)
        save_train_state(cfg.ckpt_dir, model, opt, state.step, "last", {"miou": scores["miou"]})
        if scores["miou"] > best:
            best = scores["miou"]
            save_train_state(cfg.ckpt_dir, model, opt, state.step, "best", {"miou": best})
    return state


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description="SAMRS finetuning, one card")
    p.add_argument("overrides", nargs="*", help="config overrides key=value")
    a = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    run_finetune(FinetuneConfig().override(a.overrides))


if __name__ == "__main__":
    main()
