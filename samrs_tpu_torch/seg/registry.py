"""Backbone and decoder factories (mirrors samrs_tpu/seg/registry.py):
every backbone and decoder of the JAX package's registries; any other name
raises a KeyError.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence

from torch import nn


def _resnet50(**kw) -> nn.Module:
    from samrs_tpu_torch.seg.backbones.resnet import resnet50

    kw.pop("image_size", None)  # a CNN: any image size
    return resnet50(**kw)


def _swin_t(**kw) -> nn.Module:
    from samrs_tpu_torch.seg.backbones.swin import swin_t

    kw.pop("image_size", None)  # windows of 7 on any grid (padded)
    return swin_t(**kw)


def _vitaev2_s(**kw) -> nn.Module:
    from samrs_tpu_torch.seg.backbones.vitae import vitaev2_s

    kw.pop("image_size", None)
    return vitaev2_s(**kw)


def _vit_b(**kw) -> nn.Module:
    from samrs_tpu_torch.seg.backbones.vit import vit_b

    return vit_b(**kw)


def _rvsa(name: str) -> Callable[..., nn.Module]:
    def build(**kw):
        from samrs_tpu_torch.seg.backbones import rvsa

        return getattr(rvsa, name)(**kw)

    return build


def _internimage_t(**kw) -> nn.Module:
    from samrs_tpu_torch.seg.backbones.internimage import internimage_t

    kw.pop("image_size", None)  # a CNN: any image size
    return internimage_t(**kw)


def _vit_adapter_b(**kw) -> nn.Module:
    from samrs_tpu_torch.seg.backbones.vit_adapter import vit_adapter_b

    return vit_adapter_b(**kw)


BACKBONES: Dict[str, Callable[..., nn.Module]] = {
    "resnet50": _resnet50,
    "vit_b": _vit_b,
    "vit_b_rvsa": _rvsa("vit_b_rvsa"),
    "vit_l_rvsa": _rvsa("vit_l_rvsa"),
    "vit_h_rvsa": _rvsa("vit_h_rvsa"),
    "swin_t": _swin_t,
    "vitaev2_s": _vitaev2_s,
    "internimage_t": _internimage_t,
    "vit_adapter_b": _vit_adapter_b,
}

DECODERS = ("unet", "unetpp", "upernet", "mask2former")


def get_backbone(name: str, image_size: int = 224, **kw: Any) -> nn.Module:
    if name not in BACKBONES:
        raise KeyError(f"unknown backbone {name!r}; have {sorted(BACKBONES)}")
    return BACKBONES[name](image_size=image_size, **kw)


def get_decoder(name: str, encoder_channels: Sequence[int], **kw: Any) -> nn.Module:
    """UperNet's width is the backbone's out_channels[2] (ED/models.py:176-182);
    UNet / UNet++ and Mask2Former take c1..c4's channels
    (``MultiHeadMask2FormerModel`` builds Mask2Former)."""
    if name == "unet":
        from samrs_tpu_torch.seg.decoders.unet import UnetDecoder

        return UnetDecoder(encoder_channels[1:], **kw)
    if name == "unetpp":
        from samrs_tpu_torch.seg.decoders.unetpp import UnetPlusPlusDecoder

        return UnetPlusPlusDecoder(encoder_channels[1:], **kw)
    if name == "upernet":
        from samrs_tpu_torch.seg.decoders.upernet import UPerHead

        return UPerHead(encoder_channels[1:], channels=encoder_channels[2], **kw)
    if name == "mask2former":
        from samrs_tpu_torch.seg.decoders.mask2former import Mask2FormerDecoder

        return Mask2FormerDecoder(in_channels=tuple(encoder_channels[1:]), **kw)
    raise KeyError(f"unknown decoder {name!r}; have {list(DECODERS)}")
