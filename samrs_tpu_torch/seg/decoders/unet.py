"""UNet decoder (mirrors samrs_tpu/seg/decoders/unet.py; reference
ED/unet.py:8-127).  NCHW.

Takes [img, c1..c4]; drops the image, reverses, and runs skip-concat
upsampling blocks: 2x nearest upsample, the skip bilinearly resized to
match, concat, two ConvBNReLU (with SCSE before and after under
``attention_type="scse"``); then a final 2x bilinear.  Module names follow
the JAX package's: ``block{i}.conv1`` / ``conv2`` / ``attention1`` /
``attention2``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from samrs_tpu_torch.seg.decoders.blocks import (ConvBNReLU, SCSEModule, resize_bilinear,
                                                 upsample_nearest_2x)


class DecoderBlock(nn.Module):
    def __init__(self, in_channels: int, skip_channels: int, out_channels: int,
                 attention_type: str = "none") -> None:
        super().__init__()
        if attention_type not in ("none", "scse"):
            raise KeyError(f"attention_type {attention_type!r} (none, scse)")
        scse = attention_type == "scse"
        cat = in_channels + skip_channels
        self.attention1 = SCSEModule(cat) if scse and skip_channels else None
        self.conv1 = ConvBNReLU(cat, out_channels)
        self.conv2 = ConvBNReLU(out_channels, out_channels)
        self.attention2 = SCSEModule(out_channels) if scse else None

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = upsample_nearest_2x(x)
        if skip is not None:
            x = torch.cat([x, resize_bilinear(skip, x.shape[-2:]).to(x.dtype)], 1)
            if self.attention1 is not None:
                x = self.attention1(x)
        x = self.conv2(self.conv1(x))
        return x if self.attention2 is None else self.attention2(x)


class UnetDecoder(nn.Module):
    """`encoder_channels`: the channels of c1..c4 (the backbone's
    out_channels without the image's)."""

    def __init__(self, encoder_channels: Sequence[int],
                 decoder_channels: Tuple[int, ...] = (512, 256, 128, 64),
                 attention_type: str = "none") -> None:
        super().__init__()
        rev = list(encoder_channels)[::-1]  # head first (unet.py:109-117)
        self.decoder_channels = tuple(decoder_channels)
        ins = [rev[0], *self.decoder_channels[:-1]]
        skips = rev[1:] + [0] * (len(self.decoder_channels) - len(rev) + 1)
        for i, (cin, cskip, cout) in enumerate(zip(ins, skips, self.decoder_channels)):
            self.add_module(f"block{i}", DecoderBlock(cin, cskip, cout, attention_type))

    @property
    def out_features(self) -> int:
        return self.decoder_channels[-1]

    def forward(self, features: Sequence[torch.Tensor], upsample: bool = True) -> torch.Tensor:
        """The decoded map at the input's size, or at half of it unless
        `upsample` (then ``self.upsample`` does the last 2x)."""
        feats = list(features[1:])[::-1]
        x, skips = feats[0], feats[1:]
        for i in range(len(self.decoder_channels)):
            x = getattr(self, f"block{i}")(x, skips[i] if i < len(skips) else None)
        return self.upsample(x) if upsample else x

    @staticmethod
    def upsample(x: torch.Tensor) -> torch.Tensor:
        """The final 2x bilinear (unet.py:128)."""
        return resize_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2))
