"""Backbone and decoder factories (mirrors samrs_tpu/seg/registry.py).

Only what the port has so far is registered; any other name raises a
KeyError that points to ROADMAP.md, where the remaining backbones and
decoders wait in order.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence

from torch import nn


def _rvsa(name: str) -> Callable[..., nn.Module]:
    def build(**kw):
        from samrs_tpu_torch.seg.backbones import rvsa

        return getattr(rvsa, name)(**kw)

    return build


BACKBONES: Dict[str, Callable[..., nn.Module]] = {
    "vit_b_rvsa": _rvsa("vit_b_rvsa"),
    "vit_l_rvsa": _rvsa("vit_l_rvsa"),
    "vit_h_rvsa": _rvsa("vit_h_rvsa"),
}

DECODERS = ("upernet",)


def get_backbone(name: str, image_size: int = 224, **kw: Any) -> nn.Module:
    if name not in BACKBONES:
        raise KeyError(f"backbone {name!r} is not ported yet (ported: {sorted(BACKBONES)}; "
                       "the others are queued in ROADMAP.md)")
    return BACKBONES[name](image_size=image_size, **kw)


def get_decoder(name: str, encoder_channels: Sequence[int], **kw: Any) -> nn.Module:
    """UperNet's width is the backbone's out_channels[2] (ED/models.py:176-182)."""
    if name == "upernet":
        from samrs_tpu_torch.seg.decoders.upernet import UPerHead

        return UPerHead(encoder_channels[1:], channels=encoder_channels[2], **kw)
    raise KeyError(f"decoder {name!r} is not ported yet (ported: {list(DECODERS)}; "
                   "the others are queued in ROADMAP.md)")
