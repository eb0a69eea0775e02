"""Checkpoints of the trainer (mirrors samrs_tpu/core/checkpoint.py's
``save_train_state`` / ``load_train_state``; reference
ED/main_pretrain.py:643-652, 681-687).

``{tag}.pt`` holds ``{step, model, optimizer, meta}`` (``torch.save``,
written atomically); ``{tag}_encoder.pt`` the encoder's state dict alone,
for transfer to finetuning.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch


def _save(obj: Any, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_train_state(ckpt_dir: str, model: torch.nn.Module, optimizer, step: int,
                     tag: str = "last", meta: Optional[Dict[str, Any]] = None) -> None:
    _save({"step": int(step), "model": model.state_dict(), "optimizer": optimizer.state_dict(),
           "meta": dict(meta or {})}, os.path.join(ckpt_dir, f"{tag}.pt"))
    encoder = getattr(model, "encoder", None)
    if encoder is not None:
        _save({"model": encoder.state_dict()}, os.path.join(ckpt_dir, f"{tag}_encoder.pt"))


def load_train_state(ckpt_dir: str, model: torch.nn.Module, optimizer,
                     tag: str = "last") -> Tuple[int, Dict[str, Any]]:
    """Restore model and optimizer in place (strictly); returns (step, meta)."""
    dev = next(model.parameters()).device
    tree = torch.load(os.path.join(ckpt_dir, f"{tag}.pt"), map_location=dev, weights_only=True)
    model.load_state_dict(tree["model"], strict=True)
    optimizer.load_state_dict(tree["optimizer"])
    return int(tree["step"]), dict(tree.get("meta", {}))
