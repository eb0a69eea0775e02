"""SEP multi-dataset segmentation pretraining (mirrors
samrs_tpu/train/pretrain.py; reference ED/main_pretrain.py).

    python -m samrs_tpu_torch.train.pretrain [key=value ...]
    torchrun --nproc_per_node=N -m samrs_tpu_torch.train.pretrain [key=value ...]

takes the same ``PretrainConfig`` and dotted overrides as the JAX entry point
(``data.root=...``, ``total_iters=...``, ``optim.lr=...``,
``pretrained=mae.pth``), plus ``device=cpu`` for a run on the CPU (the card
otherwise).  Under torchrun each rank drives one card (``core/mesh.py``): the
per-dataset batches are rounded to the ranks as the JAX entry point rounds them to
its devices, each rank reads its shard of every loader, the step is the
global batch's (``train/trainer.py``), the evaluation's histograms are
summed over the ranks, and rank 0 alone writes the checkpoints and
``log.txt``.  ``pretrained`` grafts a torch backbone checkpoint of any of the
seven families into the encoder (``seg/port.py:load_backbone_checkpoint``)
before the optimizer is built.  Three
SegmentationDatasets (SOTA / SIOR / FAST) with per-dataset batch sizes
proportional to the subset sizes (17/12/65 of a global 96), the summed
cross-entropy of the three heads, grad clip 5, layer-decay AdamW on a
per-iteration warmup-cosine schedule; validation every ``eval_interval``
iterations (per-dataset mIoU), checkpoints ``last`` / ``best`` and their
``*_encoder`` copies.  ``decoder=mask2former`` trains the E2E variant
(``MultiHeadMask2FormerModel``, the summed Mask2Former losses of the three
heads, point-sampled with ``m2f_num_points``) in the same loop.
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from samrs_tpu_torch.core.checkpoint import load_train_state, save_train_state
from samrs_tpu_torch.core.config import PretrainConfig
from samrs_tpu_torch.core.logging_utils import setup_logger
from samrs_tpu_torch.core.mesh import DataMesh, all_reduce_, barrier, init_data_mesh
from samrs_tpu_torch.core.metrics import segmentation_scores
from samrs_tpu_torch.core.resilience import GracefulShutdown, Watchdog
from samrs_tpu_torch.data.datasets import DataLoader, SegmentationDataset, infinite_loader
from samrs_tpu_torch.data.transforms import EvalAugment, TrainAugment
from samrs_tpu_torch.seg.frameworks import (build_multihead_mask2former_model,
                                            build_multihead_model)
from samrs_tpu_torch.seg.port import load_backbone_checkpoint
from samrs_tpu_torch.train.optim import (Optimizer, backbone_optim_settings,
                                         warmup_cosine_schedule)
from samrs_tpu_torch.train.trainer import (TrainState, eval_step, mask2former_eval_step,
                                           pretrain_step, pretrain_step_mask2former)

logger = logging.getLogger("samrs_tpu_torch.pretrain")

# subset sizes drive the proportional split (ED/main_pretrain.py:233-242)
DATASET_SIZES = {"sota": 17480, "sior": 11725, "fast": 64147}
DATASET_CLASSES = {"sota": 18, "sior": 20, "fast": 37}

# layout under data.root: (subdir, images, gray labels, image extension)
DATASET_LAYOUT = {
    "sota": ("dotav2_1024/trainval", "images", "hbox_segs_init/gray", ".png"),
    "sior": ("dior", "JPEGImages-trainval", "hbox_segs_trainvaltest_init/gray", ".jpg"),
    "fast": ("fair1m_1024/trainval", "images", "rhbox_segs_init/gray", ".png"),
}


def proportional_batch_sizes(datasets: Sequence[str], global_batch: int) -> Dict[str, int]:
    """Split the global batch by subset size, flooring each share (:245-269)."""
    total = sum(DATASET_SIZES[d] for d in datasets)
    return {d: max(1, int(global_batch * DATASET_SIZES[d] / total)) for d in datasets}


def data_parallel_batch(batch: int, ranks: int) -> int:
    """A global batch rounded to a multiple of the ranks, at least one a
    rank (samrs_tpu/train/pretrain.py:131, finetune.py:130)."""
    return max(ranks, (batch // ranks) * ranks)


def build_datasets(cfg: PretrainConfig, split: str):
    out = {}
    for i, name in enumerate(cfg.data.datasets):
        aug = (TrainAugment(size=cfg.data.image_size, seed=cfg.seed * 1000 + i)
               if split == "trn" else EvalAugment(size=cfg.data.image_size))
        sub, img_dir, lbl_dir, ext = DATASET_LAYOUT[name]
        root = os.path.join(cfg.data.root, sub)
        out[name] = SegmentationDataset(root=root, image_path=os.path.join(root, img_dir),
                                        label_path=os.path.join(root, lbl_dir), ext_img=ext,
                                        split=split, transform=aug,
                                        val_images=cfg.data.val_images)
    return out


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host batch on `device`, through pinned memory on the card."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def evaluate(cfg: PretrainConfig, model: torch.nn.Module, datasets_val,
             num_classes: Sequence[int], mesh: Optional[DataMesh] = None) -> Dict[str, dict]:
    """Scores per dataset on its val split (main_pretrain.py:463-556): each
    rank takes its shard, the histograms are summed over the ranks."""
    device = next(model.parameters()).device
    step = mask2former_eval_step if cfg.decoder == "mask2former" else eval_step
    rank, ranks = (0, 1) if mesh is None else (mesh.rank, mesh.world)
    out = {}
    for i, name in enumerate(cfg.data.datasets):
        nc = num_classes[i]
        hist = torch.zeros(3, nc, dtype=torch.int64, device=device)
        loader = DataLoader(datasets_val[name], batch_size=8, shuffle=False, drop_last=False,
                            process_index=rank, process_count=ranks)
        for x, y in loader:
            hist += torch.stack(step(model, to_device(x, device), to_device(y, device), nc, i))
        inter, target, union = all_reduce_(hist, mesh).cpu().numpy().astype(np.float64)
        out[name] = segmentation_scores(inter, target, union)
        logger.info("val[%s]: mIoU %.4f allAcc %.4f", name, out[name]["miou"],
                    out[name]["all_acc"])
    return out


def run_pretrain(cfg: PretrainConfig, model: Optional[torch.nn.Module] = None,
                 datasets_trn=None, datasets_val=None,
                 max_iters: Optional[int] = None) -> TrainState:
    """The training loop; the model and datasets are injectable (tests).  Runs on
    ``cfg.device`` (each rank on its card) and never moves elsewhere."""
    is_m2f = cfg.decoder == "mask2former"
    mesh = init_data_mesh(cfg.mesh_shape, cfg.device)
    if is_m2f and mesh.world > 1:
        raise NotImplementedError(
            "Mask2Former pretraining over several ranks is not ported (its matching, point draws "
            "and num_masks normaliser over the global batch): ROADMAP.md Queue 1 item 7")
    device = mesh.device
    main = mesh.rank == 0
    num_classes = tuple(DATASET_CLASSES[d] for d in cfg.data.datasets)
    if model is None:
        gen = torch.Generator(device=device).manual_seed(cfg.seed)
        if is_m2f:
            model = build_multihead_mask2former_model(cfg.backbone, num_classes,
                                                      cfg.data.image_size, device, gen)
        else:
            model = build_multihead_model(cfg.backbone, cfg.decoder, num_classes,
                                          cfg.data.image_size, cfg.remat, device, gen)
    model.to(device)
    if cfg.pretrained:
        # a torch backbone checkpoint grafted into the encoder, non-strict, before the
        # optimizer is built (the reference's init_weights path, models.py:201-265)
        load_backbone_checkpoint(cfg.pretrained, model.encoder)
        logger.info("initialized encoder from %s (%s)", cfg.pretrained, cfg.init)
    if datasets_trn is None:
        datasets_trn = build_datasets(cfg, "trn")
    if datasets_val is None:
        datasets_val = build_datasets(cfg, "val")

    bsizes = {k: data_parallel_batch(v, mesh.world) for k, v in
              proportional_batch_sizes(cfg.data.datasets, cfg.data.batch_size).items()}
    logger.info("per-dataset batch sizes: %s on %d rank(s), rank %d on %s", bsizes, mesh.world,
                mesh.rank, device)
    loaders = [infinite_loader(DataLoader(datasets_trn[name], batch_size=bsizes[name] // mesh.world,
                                          seed=cfg.seed, process_index=mesh.rank,
                                          process_count=mesh.world,
                                          num_threads=cfg.data.num_workers))
               for name in cfg.data.datasets]

    sched = warmup_cosine_schedule(cfg.optim.lr, cfg.total_iters, cfg.optim.warmup_iters,
                                   cfg.optim.min_lr_ratio)
    bset = backbone_optim_settings(cfg.backbone, model.encoder, cfg.data.batch_size)
    opt = Optimizer(model, sched, weight_decay=cfg.optim.weight_decay,
                    betas=tuple(cfg.optim.betas), grad_clip=cfg.optim.grad_clip,
                    layer_decay=cfg.optim.layer_decay, num_layers=bset["num_layers"],
                    layer_id_scheme=bset["scheme"], depths=bset["depths"],
                    optimizer=cfg.optim.optimizer)
    state = TrainState(0, model, opt, mesh)
    meta = {}
    if cfg.resume:
        state.step, meta = load_train_state(cfg.ckpt_dir, model, opt, tag=cfg.resume)
        logger.info("resumed from %s at step %d", cfg.resume, state.step)

    shutdown = GracefulShutdown()
    watchdog = Watchdog(timeout_s=1800.0, name="pretrain")
    best_miou = float(meta.get("best_miou", -1.0))
    total = max_iters if max_iters is not None else cfg.total_iters
    t0 = time.perf_counter()
    last_log = state.step
    try:
        while state.step < total:
            if shutdown.should_stop:
                logger.warning("preemption: checkpointing at iter %d and exiting", state.step)
                if main:
                    save_train_state(cfg.ckpt_dir, model, opt, state.step, "last",
                                     {"best_miou": best_miou})
                break
            watchdog.beat()
            batches = []
            for ld in loaders:
                x, y = next(ld)
                batches.append((to_device(x, device), to_device(y, device)))
            if is_m2f:
                metrics = pretrain_step_mask2former(state, batches, cfg.seed, num_classes,
                                                    cfg.m2f_num_points)
            else:
                metrics = pretrain_step(state, batches, cfg.seed)
            it = state.step
            if it % 50 == 0 or it == total:
                dt = (time.perf_counter() - t0) / (it - last_log)
                t0, last_log = time.perf_counter(), it
                logger.info("iter %d/%d loss %.4f lr %.2e %.3fs/it", it, total,
                            float(metrics["loss"]), sched(it), dt)
            if it % cfg.eval_interval == 0 or it == total:
                scores = evaluate(cfg, model, datasets_val, num_classes, mesh)
                miou = float(np.mean([s["miou"] for s in scores.values()])) if scores else 0.0
                if main:
                    save_train_state(cfg.ckpt_dir, model, opt, it, "last",
                                     {"best_miou": best_miou})
                    if miou > best_miou:
                        save_train_state(cfg.ckpt_dir, model, opt, it, "best",
                                         {"best_miou": miou})
                best_miou = max(best_miou, miou)
                barrier(mesh)  # the checkpoints are on disk before any rank goes on
                logger.info("iter %d eval mIoU %.4f (best %.4f)", it, miou, best_miou)
    finally:
        watchdog.stop()
        shutdown.restore()
    return state


def apply_optim_defaults(cfg: PretrainConfig, overrides: Sequence[str]) -> PretrainConfig:
    """Fold the backbone family's lr / wd / layer-decay defaults
    (ED/main_pretrain.py:329-409; resnet50's lr scaled by the global batch)
    into cfg.optim, keeping any explicit ``optim.*=`` override."""
    fam = backbone_optim_settings(cfg.backbone, None, cfg.data.batch_size)
    explicit = {o.split("=", 1)[0] for o in overrides if "=" in o}
    for key in ("lr", "weight_decay", "layer_decay"):
        if f"optim.{key}" not in explicit:
            object.__setattr__(cfg.optim, key, fam[key])
    return cfg


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description="SAMRS segmentation pretraining (SEP); one card, "
                                            "or one card a rank under torchrun")
    p.add_argument("overrides", nargs="*", help="config overrides key=value")
    a = p.parse_args(argv)
    cfg = apply_optim_defaults(PretrainConfig().override(a.overrides), a.overrides)
    setup_logger("samrs_tpu_torch", cfg.ckpt_dir)
    try:
        run_pretrain(cfg)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
