"""Trainer core: the loss, the pretrain and finetune steps and the eval steps
(mirrors samrs_tpu/train/trainer.py; reference ED/main_pretrain.py:567-625,
:463-556, E2E/main_pretrain.py:608-640 and ED/main_finetune.py:536-592).

A pretrain step sums the per-dataset cross-entropies (ignore label 255) over
the heads, a finetune step takes the one head's; each runs one backward,
clips and updates.  The Mask2Former pretrain step sums the heads'
Mask2Former losses (its backward runs head by head, below).  Dropout,
drop-path and the point losses' draws come from a generator seeded from
(seed, step), so a step is reproducible.

With a data mesh of several ranks (``TrainState.mesh``) a step is the JAX
step on the global batch, the ranks' batches in rank order: inside
``mesh.sharded`` dropout and drop-path keep the rank's rows of the global
masks and BatchNorm takes the global moments; a head's loss is the rank's
summed NLL over the global count of valid pixels (``cross_entropy_ignore``
with ``count``), the gradients are summed over the ranks before the clip,
and the reported losses are the global ones.  The Mask2Former step does the
same head by head: its point draws are the global batch's rows of the rank
and its normalisers (the class weights' sum, the matched-mask count) are
sums over the ranks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from samrs_tpu_torch.core.mesh import DataMesh, all_reduce_, reduce_grads, sharded
from samrs_tpu_torch.core.metrics import intersection_and_union
from samrs_tpu_torch.nn.layers import resize_bilinear
from samrs_tpu_torch.train.optim import Optimizer


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: Optimizer
    mesh: Optional[DataMesh] = None  # several ranks: a data-parallel step


def cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor, ignore_label: int = 255,
                         count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy over the pixels that are not ignored, 0 when all
    are (``F.cross_entropy`` would give NaN): logits (..., C), labels (...).
    ``count`` replaces the local count of valid pixels as the normaliser (a
    data-parallel step passes the global batch's)."""
    valid = labels != ignore_label
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / (valid.sum() if count is None else count).clamp(min=1)


def _global_counts(labels: Sequence[torch.Tensor], mesh: Optional[DataMesh],
                   ignore_label: int = 255):
    """Per batch the global batch's count of valid pixels (None for one process)."""
    if mesh is None or mesh.world == 1:
        return [None] * len(labels)
    counts = torch.stack([(y != ignore_label).sum() for y in labels])
    return list(all_reduce_(counts, mesh).unbind())


def _global_losses(losses: Sequence[torch.Tensor], mesh: Optional[DataMesh]):
    """The ranks' loss terms summed (each is already over the global count)."""
    losses = torch.stack([l.detach() for l in losses])
    return list(all_reduce_(losses, mesh).unbind())


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout / drop-path generator of one step (the JAX step folds the
    step into its dropout key)."""
    return torch.Generator(device=device).manual_seed(int(seed) * 1_000_003 + int(step))


def pretrain_step(state: TrainState, batches: Sequence[Optional[Tuple[torch.Tensor, torch.Tensor]]],
                  seed: int) -> Dict[str, torch.Tensor]:
    """One multi-dataset step in place: batches holds one (x, y) per head
    (None skips that head).  Returns the losses as device tensors."""
    model, opt, mesh = state.model, state.optimizer, state.mesh
    model.train()
    xs = [None if b is None else b[0] for b in batches]
    dev = next(x for x in xs if x is not None).device
    with sharded(mesh):
        outs = model(xs, generator=step_generator(seed, state.step, dev))
        live = [(o, b[1]) for o, b in zip(outs, batches) if o is not None]
        counts = _global_counts([y for _, y in live], mesh)
        losses = [cross_entropy_ignore(o, y, count=c) for (o, y), c in zip(live, counts)]
        opt.zero_grad()
        sum(losses).backward()
    reduce_grads(opt.params, mesh)
    grad_norm = opt.step(state.step)
    state.step += 1
    losses = _global_losses(losses, mesh)
    return {"loss": sum(losses), "grad_norm": grad_norm,
            **{f"loss_{i}": l for i, l in enumerate(losses)}}


def pretrain_step_mask2former(state: TrainState,
                              batches: Sequence[Optional[Tuple[torch.Tensor, torch.Tensor]]],
                              seed: int, num_classes: Sequence[int],
                              num_points: Optional[int] = None,
                              draws: Optional[Sequence[Callable]] = None) -> Dict[str, torch.Tensor]:
    """One multi-dataset Mask2Former step in place (JAX
    ``make_pretrain_step_mask2former``): per head the summed
    ``mask2former_loss`` (CE + mask BCE + dice over the decoder's outputs),
    point-sampled when ``num_points`` is set.  Each head's loss runs its own
    backward as soon as it is computed, so only one head's graph is alive at
    a time (the point losses keep ~2 GB a decoder output at the FAST head);
    the accumulated gradient is that of the sum.  ``draws`` (one per head)
    replace the generator's draws of the point losses (the tests feed JAX's).
    K8, K9, K10 and K11 follow ``model.use_kernels``.

    With a data mesh of several ranks each head's forward and loss run
    inside ``mesh.sharded``: the point draws are this rank's rows of the
    global batch's (``sharded_draw``; ``draws`` then draw the global
    batch's), the loss's normalisers are global, the gradients are summed
    over the ranks after the last head and the reported losses are global."""
    from samrs_tpu_torch.seg.decoders.mask2former import (generator_draws, mask2former_loss,
                                                          sharded_draw)

    model, opt, mesh = state.model, state.optimizer, state.mesh
    model.train()
    dev = next(b[0] for b in batches if b is not None).device
    gen = step_generator(seed, state.step, dev)
    opt.zero_grad()
    losses = {}
    with sharded(mesh):
        for i, (b, nc) in enumerate(zip(batches, num_classes)):
            if b is None:
                continue
            draw = None
            if num_points is not None:
                draw = sharded_draw(generator_draws(gen) if draws is None else draws[i], mesh)
            d = mask2former_loss(model.forward_one(b[0], i, gen), b[1], nc,
                                 num_points=num_points, draw=draw, plain=not model.use_kernels)
            loss = d["loss_cls"] + d["loss_mask"] + d["loss_dice"]
            loss.backward()
            losses[i] = loss.detach()
    reduce_grads(opt.params, mesh)
    grad_norm = opt.step(state.step)
    state.step += 1
    heads = list(losses)
    totals = _global_losses([losses[i] for i in heads], mesh)
    return {"loss": sum(totals), "grad_norm": grad_norm,
            **{f"loss_{i}": l for i, l in zip(heads, totals)}}


def finetune_step(state: TrainState, x: torch.Tensor, y: torch.Tensor,
                  seed: int) -> Dict[str, torch.Tensor]:
    """One single-head step in place (JAX ``make_finetune_step``).  Returns
    the loss and the pre-clip gradient norm as device tensors."""
    model, opt, mesh = state.model, state.optimizer, state.mesh
    model.train()
    with sharded(mesh):
        out = model(x, generator=step_generator(seed, state.step, x.device))
        loss = cross_entropy_ignore(out, y, count=_global_counts([y], mesh)[0])
        opt.zero_grad()
        loss.backward()
    reduce_grads(opt.params, mesh)
    grad_norm = opt.step(state.step)
    state.step += 1
    return {"loss": _global_losses([loss], mesh)[0], "grad_norm": grad_norm}


@torch.no_grad()
def eval_step(model: nn.Module, x: torch.Tensor, y: torch.Tensor, num_classes: int,
              head_idx: Optional[int] = None):
    """Per-batch (intersection, target, union) histograms of head `head_idx`
    of a multi-head model, or of a single-head model (None)."""
    model.eval()
    logits = model(x) if head_idx is None else model.forward_one(x, head_idx)
    return intersection_and_union(logits.argmax(-1), y, num_classes)


@torch.no_grad()
def mask2former_eval_step(model: nn.Module, x: torch.Tensor, y: torch.Tensor, num_classes: int,
                          head_idx: int):
    """Per-batch (intersection, target, union) histograms of head `head_idx`
    of a Mask2Former model (JAX ``_make_m2f_eval_step``): the last output's
    softmax(cls) . sigmoid(mask) scores, bilinearly upsampled to the labels'
    size, argmax."""
    from samrs_tpu_torch.seg.decoders.mask2former import mask2former_predict

    model.eval()
    cls_logits, mask_logits = model.forward_one(x, head_idx)[-1]
    seg = mask2former_predict(cls_logits, mask_logits, num_classes).permute(0, 3, 1, 2)
    seg = resize_bilinear(seg, tuple(y.shape[-2:]))
    return intersection_and_union(seg.argmax(1), y, num_classes)
