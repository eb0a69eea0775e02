"""Optimizers of the trainer with optax's semantics (mirrors
samrs_tpu/train/optim.py; reference
ED/mmcv_custom/layer_decay_optimizer_constructor_vit.py:7-100 and
ED/main_pretrain.py:616).

The JAX chain is clip_by_global_norm -> scale_by_adam (or trace) ->
add_decayed_weights(mask) -> per-layer scale -> scale_by_learning_rate.
Here:

  * layer ids on the port's parameter names: ``pos_embed`` / ``patch_embed``
    0, ``blocks.{i}`` i+1, the rest L+1 (scheme "vit"); for staged backbones
    (scheme "depthwise", InternImage) each block its own id counted across
    the stages, ``levels.{i}.downsample`` / ``levels.{i}.norm`` one past the
    stage's last block, capped at the stage-2 boundary; each parameter's lr
    is scaled by rate^(L+1-id) (one torch param group per scale and decay
    flag);
  * no weight decay for 1-D parameters, ``pos_embed``, rel-pos and the Swin
    bias tables;
  * global-norm clipping as optax's: g * min(1, c / ||g||) (not
    ``clip_grad_norm_``, which adds 1e-6 to the norm);
  * AdamW with eps 1e-8 and decoupled decay on the pre-update weights, which
    is torch's ``AdamW``; SGD as optax's ``trace(0.9)`` with the decay added
    after the momentum; LARS as ``optax.lars`` after the clip:
    ``add_decayed_weights(wd, mask)`` -> ``scale_by_trust_ratio`` (trust
    coefficient 1e-3, eps 0, ratio 1 where the parameter's or the update's
    norm is 0, per tensor) -> the learning rate -> ``trace(0.9)`` (momentum
    after the learning rate), and no layer decay (the JAX chain returns
    before it);
  * the warmup-cosine schedule evaluated at the PRE-increment step, so the
    first update runs at lr 0, as ``optax.scale_by_learning_rate`` does.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn


def vit_layer_id(name: str, num_layers: int) -> int:
    """Layer id of a ViT-family parameter (layer_decay_optimizer_constructor_vit.py:7-17;
    the ViT-Adapter's constructor is the same): the ViT-Adapter's ``spm.stem`` is
    not the trunk's patch embedding and takes L+1."""
    if "pos_embed" in name or "patch_embed" in name:
        return 0
    m = re.search(r"blocks\.(\d+)\.", name)
    if m:
        return int(m.group(1)) + 1
    return num_layers + 1


def depthwise_layer_id(name: str, num_layers: int, depths: Sequence[int]) -> int:
    """Depth-aware layer id of a staged backbone's parameter (JAX
    ``depthwise_layer_id``; custom_layer_decay_optimizer_constructor.py:17-63):
    block b of stage s gets b + 1 + sum(depths[:s]); a stage's downsample and
    out-norm one past the stage's last block, the last stage capped at the
    stage-2 boundary as the reference caps it."""
    if any(k in name for k in ("pos_embed", "patch_embed", "stem", "level_embed")):
        return 0
    m = re.search(r"levels\.(\d+)\.blocks\.(\d+)\.", name)
    if m:
        s, b = int(m.group(1)), int(m.group(2))
        return b + 1 + sum(depths[:s])
    m = re.search(r"levels\.(\d+)\.(?:downsample|norm)\.", name)
    if m:
        s = int(m.group(1))
        return 1 + sum(depths[:min(s + 1, len(depths) - 1)])
    return num_layers + 1


def layer_id_for(name: str, num_layers: int, scheme: str = "vit",
                 depths: Optional[Sequence[int]] = None) -> int:
    """The layer id of `name` under `scheme` ("vit" or "depthwise")."""
    if scheme == "depthwise":
        if depths is None:
            raise ValueError("the depthwise layer-id scheme needs the stages' depths")
        return depthwise_layer_id(name, num_layers, depths)
    if scheme != "vit":
        raise KeyError(f"unknown layer-id scheme {scheme!r} (vit, depthwise)")
    return vit_layer_id(name, num_layers)


def no_weight_decay(name: str, param: torch.Tensor) -> bool:
    """True for parameters that get no decay (1-D, pos/rel-pos tables)."""
    if param.dim() <= 1:
        return True
    return any(k in name for k in ("pos_embed", "rel_pos", "relative_position_bias_table"))


def layer_decay_scale(name: str, layer_decay: Optional[float], num_layers: int,
                      scheme: str = "vit", depths: Optional[Sequence[int]] = None) -> float:
    """lr multiplier rate^(num_layers + 1 - id); 1 without layer decay."""
    if layer_decay is None or layer_decay >= 1.0:
        return 1.0
    return layer_decay ** (num_layers + 1 - layer_id_for(name, num_layers, scheme, depths))


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
                 num_layers: int = 12, optimizer: str = "adamw", layer_id_scheme: str = "vit",
                 depths: Optional[Sequence[int]] = None) -> None:
        if optimizer not in ("adamw", "sgd", "lars"):
            raise KeyError(f"unknown optimizer {optimizer!r} (adamw, sgd, lars)")
        groups: Dict[Tuple[float, bool], List[torch.Tensor]] = {}
        for name, p in model.named_parameters():
            if not p.requires_grad:
                continue
            scale = (1.0 if optimizer == "lars" else
                     layer_decay_scale(name, layer_decay, num_layers, layer_id_scheme, depths))
            groups.setdefault((scale, not no_weight_decay(name, p)), []).append(p)
        wd_key = "weight_decay" if optimizer == "adamw" else "decoupled_wd"
        param_groups = [{"params": ps, "lr": 0.0, "lr_scale": s, wd_key: weight_decay if d else 0.0}
                        for (s, d), ps in sorted(groups.items())]
        if optimizer == "adamw":
            self.opt = torch.optim.AdamW(param_groups, lr=0.0, betas=tuple(betas), eps=1e-8)
        else:
            # optax trace(0.9): t = g + 0.9 t; SGD's decay and LARS's update in step()
            self.opt = torch.optim.SGD(param_groups, lr=0.0, momentum=0.9)
        self.kind = optimizer
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
        if self.kind == "lars":
            self._lars_updates(lr)
            self.opt.step()
            return norm
        for g in self.opt.param_groups:
            g["lr"] = lr * g["lr_scale"]
            if g.get("decoupled_wd"):
                # optax adds wd * p after the momentum: p -= lr * wd * p (pre-update p)
                torch._foreach_mul_(g["params"], 1.0 - g["lr"] * g["decoupled_wd"])
        self.opt.step()
        return norm

    @torch.no_grad()
    def _lars_updates(self, lr: float) -> None:
        """Each gradient becomes lr * trust * (g + wd p), trust = 1e-3 ||p|| /
        ||g + wd p|| (1 where either norm is 0); SGD at lr 1 with momentum
        0.9 then applies optax's trace(0.9)."""
        for g in self.opt.param_groups:
            g["lr"] = 1.0
            ps = [p for p in g["params"] if p.grad is not None]
            if not ps:
                continue
            us = [p.grad for p in ps]
            if g["decoupled_wd"]:
                torch._foreach_add_(us, ps, alpha=g["decoupled_wd"])
            pn = torch.stack(torch._foreach_norm(ps))
            un = torch.stack(torch._foreach_norm(us))
            trust = torch.where((pn == 0) | (un == 0), torch.ones_like(pn), 1e-3 * pn / un)
            for u, t in zip(us, (trust * lr).unbind()):
                u.mul_(t)

    def state_dict(self) -> Dict[str, Any]:
        return self.opt.state_dict()

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.opt.load_state_dict(sd)


# Per-backbone optimizer defaults of the reference's zoo (ED/main_pretrain.py:329-409);
# the rows of samrs_tpu/train/optim.py's table.  resnet50's lr follows the reference's
# blr scaling, lr = blr * global batch / 96.
BACKBONE_OPTIM_DEFAULTS: Dict[str, Dict[str, Any]] = {
    "resnet50": dict(lr=None, blr=1e-3, weight_decay=0.05, layer_decay=None),
    "swin_t": dict(lr=6e-5, weight_decay=0.01, layer_decay=None),
    "vitaev2_s": dict(lr=6e-5, weight_decay=0.01, layer_decay=None),
    "vit_b": dict(lr=6e-5, weight_decay=0.05, layer_decay=0.9, scheme="vit"),
    "vit_b_rvsa": dict(lr=6e-5, weight_decay=0.05, layer_decay=0.9, scheme="vit"),
    "vit_l_rvsa": dict(lr=6e-5, weight_decay=0.05, layer_decay=0.9, scheme="vit"),
    "vit_h_rvsa": dict(lr=6e-5, weight_decay=0.05, layer_decay=0.9, scheme="vit"),
    # rate 1.0 (no decay) with the reference's depth-aware ids
    # (custom_layer_decay_optimizer_constructor: num_layers 30, depths 4/4/18/4)
    "internimage_t": dict(lr=6e-5, weight_decay=0.05, layer_decay=1.0, scheme="depthwise"),
    # the ViT ids on the reference key layout: blocks.{i} (gammas too) i+1, the spatial
    # prior (its stem included), level_embed, the interactions, up and the norms L+1
    "vit_adapter_b": dict(lr=6e-5, weight_decay=0.01, layer_decay=0.95, scheme="vit"),
}


def backbone_optim_settings(backbone: str, encoder: Optional[nn.Module] = None,
                            global_batch: int = 96) -> Dict[str, Any]:
    """The family's lr (``blr`` scaled by `global_batch` / 96 where the row
    has one) / weight_decay / layer_decay / layer-id scheme, and
    ``num_layers`` / ``depths`` from the encoder when given (a staged
    backbone's ``depths``, summed; a ViT's ``depth``; 12 without one)."""
    if backbone not in BACKBONE_OPTIM_DEFAULTS:
        raise KeyError(f"unknown backbone {backbone!r}; have {sorted(BACKBONE_OPTIM_DEFAULTS)}")
    d = dict(BACKBONE_OPTIM_DEFAULTS[backbone])
    if d["lr"] is None:
        d["lr"] = d.pop("blr") * global_batch / 96.0
    d.setdefault("scheme", "vit")
    depths = getattr(encoder, "depths", None) if encoder is not None else None
    if depths is not None:
        d["depths"] = tuple(depths)
        d["num_layers"] = int(sum(depths))
    else:
        d["depths"] = None
        d["num_layers"] = int(getattr(encoder, "depth", 12)) if encoder is not None else 12
    return d
