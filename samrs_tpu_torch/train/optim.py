"""Optimizers of the trainer with optax's semantics (mirrors
samrs_tpu/train/optim.py; reference
ED/mmcv_custom/layer_decay_optimizer_constructor_vit.py:7-100 and
ED/main_pretrain.py:616).

The JAX chain is clip_by_global_norm -> scale_by_adam (or trace) ->
add_decayed_weights(mask) -> per-layer scale -> scale_by_learning_rate.
Here:

  * layer ids on the port's parameter names: ``pos_embed`` / ``patch_embed``
    0, ``blocks.{i}`` i+1, the rest L+1; each parameter's lr is scaled by
    rate^(L+1-id) (one torch param group per scale and decay flag);
  * no weight decay for 1-D parameters, ``pos_embed``, rel-pos and the Swin
    bias tables;
  * global-norm clipping as optax's: g * min(1, c / ||g||) (not
    ``clip_grad_norm_``, which adds 1e-6 to the norm);
  * AdamW with eps 1e-8 and decoupled decay on the pre-update weights, which
    is torch's ``AdamW``; SGD as optax's ``trace(0.9)`` with the decay added
    after the momentum;
  * the warmup-cosine schedule evaluated at the PRE-increment step, so the
    first update runs at lr 0, as ``optax.scale_by_learning_rate`` does.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn


def vit_layer_id(name: str, num_layers: int) -> int:
    """Layer id of a ViT-family parameter (layer_decay_optimizer_constructor_vit.py:7-17)."""
    if "pos_embed" in name or "patch_embed" in name:
        return 0
    m = re.search(r"blocks\.(\d+)\.", name)
    if m:
        return int(m.group(1)) + 1
    return num_layers + 1


def no_weight_decay(name: str, param: torch.Tensor) -> bool:
    """True for parameters that get no decay (1-D, pos/rel-pos tables)."""
    if param.dim() <= 1:
        return True
    return any(k in name for k in ("pos_embed", "rel_pos", "relative_position_bias_table"))


def layer_decay_scale(name: str, layer_decay: Optional[float], num_layers: int) -> float:
    """lr multiplier rate^(num_layers + 1 - id); 1 without layer decay."""
    if layer_decay is None or layer_decay >= 1.0:
        return 1.0
    return layer_decay ** (num_layers + 1 - vit_layer_id(name, num_layers))


def warmup_cosine_schedule(base_lr: float, total_steps: int, warmup_steps: int = 1500,
                           min_lr_ratio: float = 0.0) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, base_lr, warmup, max(total,
    warmup + 1), base_lr * min_lr_ratio), per iteration (ED/utils.py:92-104)."""
    warmup = max(warmup_steps, 1)
    decay = max(total_steps, warmup_steps + 1) - warmup

    def sched(step: int) -> float:
        if step < warmup:
            return base_lr * step / warmup
        t = min(step - warmup, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay))
        return base_lr * ((1.0 - min_lr_ratio) * cosine + min_lr_ratio)

    return sched


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: g unchanged if ||g|| < c, else
    g * (c / ||g||).  Returns ||g|| (a device tensor, no host sync)."""
    if not grads:
        return torch.zeros(())
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class Optimizer:
    """Clip, schedule and update a model's parameters with the JAX package's
    chain.  ``step(it)`` applies the update of iteration `it` (0-based, the
    number of updates already applied) from the parameters' ``.grad``."""

    def __init__(self, model: nn.Module, lr_schedule: Callable[[int], float],
                 weight_decay: float = 0.05, betas: Tuple[float, float] = (0.9, 0.999),
                 grad_clip: float = 5.0, layer_decay: Optional[float] = None,
                 num_layers: int = 12, optimizer: str = "adamw") -> None:
        groups: Dict[Tuple[float, bool], List[torch.Tensor]] = {}
        for name, p in model.named_parameters():
            if not p.requires_grad:
                continue
            key = (layer_decay_scale(name, layer_decay, num_layers), not no_weight_decay(name, p))
            groups.setdefault(key, []).append(p)
        wd_key = "weight_decay" if optimizer == "adamw" else "decoupled_wd"
        param_groups = [{"params": ps, "lr": 0.0, "lr_scale": s, wd_key: weight_decay if d else 0.0}
                        for (s, d), ps in sorted(groups.items())]
        if optimizer == "adamw":
            self.opt = torch.optim.AdamW(param_groups, lr=0.0, betas=tuple(betas), eps=1e-8)
        elif optimizer == "sgd":
            # optax trace(0.9): t = g + 0.9 t; the decay follows in step()
            self.opt = torch.optim.SGD(param_groups, lr=0.0, momentum=0.9)
        else:
            raise KeyError(f"optimizer {optimizer!r} is not ported (adamw, sgd; LARS is queued "
                           "in ROADMAP.md)")
        self.lr_schedule = lr_schedule
        self.grad_clip = grad_clip
        self.params = [p for g in param_groups for p in g["params"]]

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self, it: int) -> torch.Tensor:
        """One update at lr_schedule(it); returns the pre-clip gradient norm."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = clip_by_global_norm(grads, self.grad_clip)
        lr = self.lr_schedule(it)
        for g in self.opt.param_groups:
            g["lr"] = lr * g["lr_scale"]
            if g.get("decoupled_wd"):
                # optax adds wd * p after the momentum: p -= lr * wd * p (pre-update p)
                torch._foreach_mul_(g["params"], 1.0 - g["lr"] * g["decoupled_wd"])
        self.opt.step()
        return norm

    def state_dict(self) -> Dict[str, Any]:
        return self.opt.state_dict()

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.opt.load_state_dict(sd)


# Per-backbone optimizer defaults of the reference's zoo (ED/main_pretrain.py:329-409);
# the rows of samrs_tpu/train/optim.py's table for the backbones the port has.
BACKBONE_OPTIM_DEFAULTS: Dict[str, Dict[str, Any]] = {
    "vit_b": dict(lr=6e-5, weight_decay=0.05, layer_decay=0.9),
    "vit_b_rvsa": dict(lr=6e-5, weight_decay=0.05, layer_decay=0.9),
    "vit_l_rvsa": dict(lr=6e-5, weight_decay=0.05, layer_decay=0.9),
    "vit_h_rvsa": dict(lr=6e-5, weight_decay=0.05, layer_decay=0.9),
}


def backbone_optim_settings(backbone: str, encoder: Optional[nn.Module] = None) -> Dict[str, Any]:
    """The family's lr / weight_decay / layer_decay and ``num_layers`` (the
    encoder's ``depth`` when given, 12 otherwise)."""
    if backbone not in BACKBONE_OPTIM_DEFAULTS:
        raise KeyError(f"backbone {backbone!r} is not ported yet (ROADMAP.md)")
    d = dict(BACKBONE_OPTIM_DEFAULTS[backbone])
    d["num_layers"] = int(getattr(encoder, "depth", 12)) if encoder is not None else 12
    return d
