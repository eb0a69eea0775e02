"""UperNet head (mirrors samrs_tpu/seg/decoders/upernet.py; reference
ED/upernet_mmseg_30.py:439-570).  NCHW.

PPM pyramid pooling on the top feature, FPN lateral and top-down fusion over
the lower ones, concat and bottleneck, then a 4x bilinear upsample; the
classification conv lives in the framework's heads.  Module names follow the
JAX package's (``ppm.ppm{i}``, ``bottleneck``, ``lateral{i}``, ``fpn{i}``,
``fpn_bottleneck``), each a ConvBNReLU with ``conv`` and ``bn``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from samrs_tpu_torch.seg.decoders.blocks import ConvBNReLU, adaptive_avg_pool, resize_bilinear


class PPM(nn.Module):
    """Pooling pyramid module (upernet_mmseg_30.py:46-93)."""

    def __init__(self, in_channels: int, channels: int,
                 pool_scales: Tuple[int, ...] = (1, 2, 3, 6)) -> None:
        super().__init__()
        self.pool_scales = tuple(pool_scales)
        for i in range(len(self.pool_scales)):
            self.add_module(f"ppm{i}", ConvBNReLU(in_channels, channels, 1))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        H, W = x.shape[-2:]
        return [resize_bilinear(getattr(self, f"ppm{i}")(adaptive_avg_pool(x, (s, s))), (H, W))
                for i, s in enumerate(self.pool_scales)]


class UPerHead(nn.Module):
    """Input: [img, c1..c4] (NCHW maps, the image unused); output (B,
    channels, 4 h1, 4 w1)."""

    def __init__(self, in_channels: Sequence[int], channels: int = 512,
                 pool_scales: Tuple[int, ...] = (1, 2, 3, 6)) -> None:
        super().__init__()
        ins = list(in_channels)
        self.channels = channels
        self.ppm = PPM(ins[-1], channels, pool_scales)
        self.bottleneck = ConvBNReLU(ins[-1] + len(pool_scales) * channels, channels, 3)
        for i in range(len(ins) - 1):
            self.add_module(f"lateral{i}", ConvBNReLU(ins[i], channels, 1))
            self.add_module(f"fpn{i}", ConvBNReLU(channels, channels, 3))
        self.fpn_bottleneck = ConvBNReLU(len(ins) * channels, channels, 3)
        self.num_levels = len(ins)

    @property
    def out_features(self) -> int:
        return self.channels

    def forward(self, features: Sequence[torch.Tensor], upsample: bool = True) -> torch.Tensor:
        """The fused map, 4x upsampled to the input's size unless `upsample`
        is False (then ``self.upsample`` does it)."""
        inputs = list(features[1:])  # drop the raw image (upernet_mmseg_30.py:563)
        top = inputs[-1]
        psp = self.bottleneck(torch.cat([top, *self.ppm(top)], 1))
        laterals = [getattr(self, f"lateral{i}")(inputs[i]) for i in range(self.num_levels - 1)]
        laterals.append(psp)
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize_bilinear(laterals[i],
                                                                laterals[i - 1].shape[-2:])
        fpn_outs = [getattr(self, f"fpn{i}")(laterals[i]) for i in range(self.num_levels - 1)]
        fpn_outs.append(laterals[-1])
        hw = fpn_outs[0].shape[-2:]
        feats = self.fpn_bottleneck(torch.cat([resize_bilinear(f, hw) for f in fpn_outs], 1))
        return self.upsample(feats) if upsample else feats

    @staticmethod
    def upsample(feats: torch.Tensor) -> torch.Tensor:
        """4x bilinear to the input resolution (c1 has stride 4)."""
        return resize_bilinear(feats, (feats.shape[-2] * 4, feats.shape[-1] * 4))
