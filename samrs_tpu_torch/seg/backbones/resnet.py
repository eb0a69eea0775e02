"""ResNet-50 segmentation backbone (mirrors samrs_tpu/seg/backbones/resnet.py;
reference ED/backbone/resnet_mmseg_10.py, out_channels (3, 256, 512, 1024,
2048)).

The standard bottleneck ResNet on NCHW maps: a 7x7 stride-2 stem conv,
BatchNorm, ReLU and a 3x3 stride-2 max-pool with padding 1 (padded with
-inf, as flax's ``max_pool``), then four stages of 3 / 4 / 6 / 3 bottlenecks
of width 64 / 128 / 256 / 512 (output 4x), the stride on the 3x3 conv of a
stage's first block, and a 1x1 conv + BatchNorm shortcut where the shape
changes.  Every BatchNorm is the flax-semantics ``BatchNorm`` (momentum
0.9, eps 1e-5, biased running variance), never ``nn.BatchNorm2d``.  No
kernel runs here: ``use_kernels`` is accepted for the frameworks' sake.

Module names follow the torchvision key layout that the reference's
checkpoints use (samrs_tpu/seg/port.py:235-322 reads it): ``conv1``,
``bn1``, ``layer{l}.{b}.conv{j}`` / ``bn{j}``, ``layer{l}.{b}.downsample.{0,
1}``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from samrs_tpu_torch.nn.layers import run_block
from samrs_tpu_torch.seg.decoders.blocks import BatchNorm


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (4x width), each with BatchNorm, ReLU after
    the first two and after the residual sum."""

    def __init__(self, in_channels: int, features: int, stride: int = 1) -> None:
        super().__init__()
        out = 4 * features
        self.conv1 = nn.Conv2d(in_channels, features, 1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, stride, padding=1, bias=False)
        self.bn2 = BatchNorm(features)
        self.conv3 = nn.Conv2d(features, out, 1, bias=False)
        self.bn3 = BatchNorm(out)
        self.downsample = None
        if stride != 1 or in_channels != out:
            self.downsample = nn.Sequential(nn.Conv2d(in_channels, out, 1, stride, bias=False),
                                            BatchNorm(out))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                use_kernels: bool = True) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """``forward`` takes NHWC images and returns [img, c1, c2, c3, c4] with
    NCHW maps (strides 4, 8, 16, 32)."""

    def __init__(self, stage_sizes: Tuple[int, ...] = (3, 4, 6, 3),
                 use_checkpoint: bool = False) -> None:
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.use_checkpoint = use_checkpoint
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        in_ch = 64
        for s, (n_blocks, w) in enumerate(zip(self.stage_sizes, (64, 128, 256, 512))):
            blocks = []
            for b in range(n_blocks):
                blocks.append(Bottleneck(in_ch, w, 2 if s > 0 and b == 0 else 1))
                in_ch = 4 * w
            self.add_module(f"layer{s + 1}", nn.Sequential(*blocks))

    @property
    def out_channels(self) -> Tuple[int, ...]:
        return (3, 256, 512, 1024, 2048)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                use_kernels: bool = True) -> List[torch.Tensor]:
        img = x
        ckpt = self.use_checkpoint and self.training  # per-block activation checkpointing
        x = F.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2).contiguous())))
        x = F.max_pool2d(x, 3, 2, padding=1)
        feats = []
        for s in range(len(self.stage_sizes)):
            for blk in getattr(self, f"layer{s + 1}"):
                x = run_block(blk, x, generator, use_kernels, ckpt)
            feats.append(x.contiguous())
        return [img, *feats]


def resnet50(**kw) -> ResNet:
    kw.setdefault("stage_sizes", (3, 4, 6, 3))
    return ResNet(**kw)
