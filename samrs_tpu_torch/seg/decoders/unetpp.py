"""UNet++ decoder (mirrors samrs_tpu/seg/decoders/unetpp.py; reference
ED/unetpp.py:8-140): dense nested skip pathways.  NCHW.

Node X[l][j] (j >= 1) takes the 2x-upsampled X[l+1][j-1] concatenated after
all same-level predecessors X[l][0..j-1] through two ConvBNReLU
(``node_{l}_{j}_conv1`` / ``conv2``); X[l][0] is the encoder's c(l+1).  The
output is the last node of the top level, one more 2x nearest step with
``final_conv`` (stride 2), then the final 2x bilinear.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from samrs_tpu_torch.seg.decoders.blocks import (ConvBNReLU, resize_bilinear,
                                                 upsample_nearest_2x)


class UnetPlusPlusDecoder(nn.Module):
    """`encoder_channels`: the channels of c1..c4."""

    def __init__(self, encoder_channels: Sequence[int],
                 decoder_channels: Tuple[int, ...] = (512, 256, 128, 64)) -> None:
        super().__init__()
        self.decoder_channels = tuple(decoder_channels)
        enc = list(encoder_channels)
        self.depth = depth = len(enc) - 1
        ch: Dict[Tuple[int, int], int] = {(lvl, 0): c for lvl, c in enumerate(enc)}
        for j in range(1, depth + 1):
            for lvl in range(depth + 1 - j):
                cin = sum(ch[(lvl, k)] for k in range(j)) + ch[(lvl + 1, j - 1)]
                cout = self.decoder_channels[min(len(self.decoder_channels) - 1, depth - lvl)]
                self.add_module(f"node_{lvl}_{j}_conv1", ConvBNReLU(cin, cout))
                self.add_module(f"node_{lvl}_{j}_conv2", ConvBNReLU(cout, cout))
                ch[(lvl, j)] = cout
        self.final_conv = ConvBNReLU(ch[(0, depth)], self.decoder_channels[-1])

    @property
    def out_features(self) -> int:
        return self.decoder_channels[-1]

    def forward(self, features: Sequence[torch.Tensor], upsample: bool = True) -> torch.Tensor:
        """The decoded map at the input's size, or at half of it unless
        `upsample` (then ``self.upsample`` does the last 2x)."""
        nodes = {(lvl, 0): f for lvl, f in enumerate(features[1:])}  # c1..c4, strides 4..32
        for j in range(1, self.depth + 1):
            for lvl in range(self.depth + 1 - j):
                below = upsample_nearest_2x(nodes[(lvl + 1, j - 1)])
                below = resize_bilinear(below, nodes[(lvl, 0)].shape[-2:])
                x = torch.cat([nodes[(lvl, k)].to(below.dtype) for k in range(j)] + [below], 1)
                x = getattr(self, f"node_{lvl}_{j}_conv1")(x)
                nodes[(lvl, j)] = getattr(self, f"node_{lvl}_{j}_conv2")(x)
        out = self.final_conv(upsample_nearest_2x(nodes[(0, self.depth)]))
        return self.upsample(out) if upsample else out

    @staticmethod
    def upsample(x: torch.Tensor) -> torch.Tensor:
        """The final 2x bilinear."""
        return resize_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2))
