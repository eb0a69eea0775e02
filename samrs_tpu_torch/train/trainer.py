"""Trainer core: the loss, the pretrain and finetune steps and the eval step
(mirrors samrs_tpu/train/trainer.py; reference ED/main_pretrain.py:567-625,
:463-556 and ED/main_finetune.py:536-592).

A pretrain step sums the per-dataset cross-entropies (ignore label 255) over
the heads, a finetune step takes the one head's; each runs one backward,
clips and updates.  Dropout and drop-path draw
from a generator seeded from (seed, step), so a step is reproducible.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from samrs_tpu_torch.core.metrics import intersection_and_union
from samrs_tpu_torch.train.optim import Optimizer


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: Optimizer


def cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_label: int = 255) -> torch.Tensor:
    """Mean cross-entropy over the pixels that are not ignored, 0 when all
    are (``F.cross_entropy`` would give NaN): logits (..., C), labels (...)."""
    valid = labels != ignore_label
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / valid.sum().clamp(min=1)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout / drop-path generator of one step (the JAX step folds the
    step into its dropout key)."""
    return torch.Generator(device=device).manual_seed(int(seed) * 1_000_003 + int(step))


def pretrain_step(state: TrainState, batches: Sequence[Optional[Tuple[torch.Tensor, torch.Tensor]]],
                  seed: int) -> Dict[str, torch.Tensor]:
    """One multi-dataset step in place: batches holds one (x, y) per head
    (None skips that head).  Returns the losses as device tensors."""
    model, opt = state.model, state.optimizer
    model.train()
    xs = [None if b is None else b[0] for b in batches]
    dev = next(x for x in xs if x is not None).device
    outs = model(xs, generator=step_generator(seed, state.step, dev))
    losses = [cross_entropy_ignore(o, b[1]) for o, b in zip(outs, batches) if o is not None]
    loss = sum(losses)
    opt.zero_grad()
    loss.backward()
    grad_norm = opt.step(state.step)
    state.step += 1
    return {"loss": loss.detach(), "grad_norm": grad_norm,
            **{f"loss_{i}": l.detach() for i, l in enumerate(losses)}}


def finetune_step(state: TrainState, x: torch.Tensor, y: torch.Tensor,
                  seed: int) -> Dict[str, torch.Tensor]:
    """One single-head step in place (JAX ``make_finetune_step``).  Returns
    the loss and the pre-clip gradient norm as device tensors."""
    model, opt = state.model, state.optimizer
    model.train()
    loss = cross_entropy_ignore(model(x, generator=step_generator(seed, state.step, x.device)), y)
    opt.zero_grad()
    loss.backward()
    grad_norm = opt.step(state.step)
    state.step += 1
    return {"loss": loss.detach(), "grad_norm": grad_norm}


@torch.no_grad()
def eval_step(model: nn.Module, x: torch.Tensor, y: torch.Tensor, num_classes: int,
              head_idx: Optional[int] = None):
    """Per-batch (intersection, target, union) histograms of head `head_idx`
    of a multi-head model, or of a single-head model (None)."""
    model.eval()
    logits = model(x) if head_idx is None else model.forward_one(x, head_idx)
    return intersection_and_union(logits.argmax(-1), y, num_classes)
