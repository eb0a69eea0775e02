"""ViTAEv2-S: the 4-stage CNN + transformer hybrid (mirrors
samrs_tpu/seg/backbones/vitae.py; reference ED/backbone/ViTAE_Window_NoShift),
out_channels (3, 64, 128, 256, 512).

Channels-last token maps; the convs run on NCHW views:

  * a ReductionCell per stage: the PRM, parallel dilated convs (dilations
    1-4 / 1-3 / 1-2 / 1-2) downsampling by the stage's ratio 4 / 2 / 2 / 2,
    each padded by ceil(((k - 1) d + 1 - ratio) / 2), exact GELU, cropped to
    (H / ratio, W / ratio) and concatenated; LayerNorm (eps 1e-5) and
    attention to the stage's token width, windowed (7, no shift, no
    position bias) in the 'swin' stages 0 / 1 and over all tokens with V as
    the skip in the 'transformer' stages 2 / 3 (token_transformer.py:37-48);
    plus the PCM on the raw input (three grouped 3x3 convs with strides from
    ratio / 2, BatchNorm and SiLU after the first two), cropped alike; then
    ``x += mlp(norm2 x)`` with mlp_ratio 1.0; drop path 0 (ReductionCell.py:
    74-215);
  * NormalCells (2 / 2 / 8 / 2): ``x = x + drop_path(attn(norm1 x)) +
    drop_path(PCM(x)); x += drop_path(mlp(norm2 x))``, LayerNorm eps 1e-6,
    PCM widths C -> 4C -> C -> C, mlp_ratio 4.0 (NormalCell.py:118-259);
    the drop-path slices of the reference (base_model.py:156-160: a stage
    starts at ``NC_depth[i - 1]``, not at a running sum).

Every BatchNorm is the flax-semantics ``BatchNorm``.  Attention is plain
torch, as the JAX package computes it outside any kernel; the MLPs run K11
under ``use_kernels`` (a ReductionCell's at C = M = 64 / 128 / 256 / 512).
Module names follow the reference key layout that
samrs_tpu/seg/port.py:418-563 reads: ``layers.{s}.RC.{PRM.convs.{j}.0,
PCM.{0,3,6} / {1,4}, attn.{norm1, norm2, mlp.fc*, attn.{qkv, proj}}}`` and
``layers.{s}.NC.{b}.{norm1, attn.{qkv, proj}, PCM.*, norm2, mlp.fc*}``.
Drop-path draws from the generator passed to ``forward``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from samrs_tpu_torch.nn.layers import (DropPath, run_block, window_partition,
                                       window_unpartition)
from samrs_tpu_torch.seg.backbones.vit_common import Mlp
from samrs_tpu_torch.seg.decoders.blocks import BatchNorm


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class AttentionIO(nn.Module):
    """Full attention from `in_dim` to `out_dim` over (B, N, in_dim) tokens;
    with ``v_skip`` the output adds V (the T2T Token_transformer's skip, for
    an input width that differs from the output's)."""

    def __init__(self, in_dim: int, out_dim: int, num_heads: int, v_skip: bool = False) -> None:
        super().__init__()
        self.num_heads, self.v_skip = num_heads, v_skip
        self.qkv = nn.Linear(in_dim, 3 * out_dim)
        self.proj = nn.Linear(out_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, _ = x.shape
        out_dim = self.proj.out_features
        nH = self.num_heads
        hd = out_dim // nH
        q, k, v = self.qkv(x).reshape(B, N, 3, nH, hd).permute(2, 0, 3, 1, 4).unbind(0)
        attn = ((q * hd ** -0.5) @ k.transpose(-1, -2)).softmax(-1)
        out = self.proj((attn @ v).transpose(1, 2).reshape(B, N, out_dim))
        if self.v_skip:
            out = out + v.transpose(1, 2).reshape(B, N, out_dim)
        return out


def _attend(attn: AttentionIO, x: torch.Tensor, windowed: bool, ws: int) -> torch.Tensor:
    """`attn` on an NHWC map: within non-shifted ws x ws windows (zero
    padding bottom-right, cropped after) or over all of its tokens."""
    B, H, W, C = x.shape
    if not windowed:
        return attn(x.reshape(B, H * W, C)).reshape(B, H, W, -1)
    wins, pad_hw = window_partition(x, ws)
    y = attn(wins.reshape(-1, ws * ws, C))
    return window_unpartition(y.reshape(-1, ws, ws, y.shape[-1]), ws, pad_hw, (H, W))


def _pcm(in_ch: int, chans: Tuple[int, int, int], strides: Tuple[int, int, int],
         groups: int) -> nn.Sequential:
    """Three grouped 3x3 convs, BatchNorm and SiLU after the first two
    (NormalCell.py:170-178 / ReductionCell.py:109-117): indices 0, 3, 6 are
    the convs, 1 and 4 the BatchNorms."""
    layers, c_in = [], in_ch
    for i, (c, s) in enumerate(zip(chans, strides)):
        layers.append(nn.Conv2d(c_in, c, 3, s, padding=1, groups=groups))
        if i < 2:
            layers += [BatchNorm(c), nn.SiLU()]
        c_in = c
    return nn.Sequential(*layers)


class PRM(nn.Module):
    """Parallel dilated convs downsampling by `downsample`, exact GELU,
    cropped to (H // downsample, W // downsample), concatenated."""

    def __init__(self, in_ch: int, embed_dim: int, kernel_size: int, downsample: int,
                 dilations: Sequence[int]) -> None:
        super().__init__()
        self.downsample = downsample
        self.convs = nn.ModuleList(
            nn.Sequential(nn.Conv2d(in_ch, embed_dim, kernel_size, downsample,
                                    padding=math.ceil(((kernel_size - 1) * d + 1 - downsample) / 2),
                                    dilation=d), nn.GELU())
            for d in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW -> NHWC
        Ho, Wo = x.shape[2] // self.downsample, x.shape[3] // self.downsample
        return _nhwc(torch.cat([conv(x)[:, :, :Ho, :Wo] for conv in self.convs], 1))


class RCAttention(nn.Module):
    """The ReductionCell's transformer part (the reference's ``RC.attn``):
    norm1, attention, norm2 and the MLP; eps 1e-5."""

    def __init__(self, in_dim: int, token_dim: int, num_heads: int, v_skip: bool,
                 mlp_ratio: float) -> None:
        super().__init__()
        self.norm1 = nn.LayerNorm(in_dim, eps=1e-5)
        self.attn = AttentionIO(in_dim, token_dim, num_heads, v_skip=v_skip)
        self.norm2 = nn.LayerNorm(token_dim, eps=1e-5)
        self.mlp = Mlp(token_dim, int(token_dim * mlp_ratio))


class ReductionCell(nn.Module):
    def __init__(self, in_ch: int, embed_dim: int, token_dim: int, downsample: int,
                 num_heads: int, kernel_size: int = 3, dilations: Sequence[int] = (1, 2, 3, 4),
                 tokens_type: str = "swin", window_size: int = 7, group: int = 1,
                 mlp_ratio: float = 1.0) -> None:
        super().__init__()
        self.downsample, self.window_size = downsample, window_size
        self.windowed = tokens_type == "swin"
        self.PRM = PRM(in_ch, embed_dim, kernel_size, downsample, dilations)
        strides, r = [], downsample // 2
        for _ in range(3):
            strides.append(2 if r > 0 else 1)
            r //= 2
        self.PCM = _pcm(in_ch, (embed_dim, embed_dim, token_dim), tuple(strides), group)
        # the 'transformer' stages' T2T attention keeps V as its skip
        self.attn = RCAttention(len(dilations) * embed_dim, token_dim, num_heads,
                                not self.windowed, mlp_ratio)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                use_kernels: bool = True) -> torch.Tensor:
        H, W = x.shape[1:3]
        Ho, Wo = H // self.downsample, W // self.downsample
        xc = _nchw(x)
        prm = self.PRM(xc)
        pcm = _nhwc(self.PCM(xc))[:, :Ho, :Wo]
        blk = self.attn
        x = _attend(blk.attn, blk.norm1(prm), self.windowed, self.window_size) + pcm
        return x + blk.mlp(blk.norm2(x), use_kernels)


class NormalCell(nn.Module):
    def __init__(self, dim: int, num_heads: int, tokens_type: str = "swin",
                 window_size: int = 7, group: int = 64, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0) -> None:
        super().__init__()
        self.window_size = window_size
        self.windowed = tokens_type == "swin"
        hidden = int(dim * mlp_ratio)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = AttentionIO(dim, dim, num_heads)
        self.PCM = _pcm(dim, (hidden, dim, dim), (1, 1, 1), group)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, hidden)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                use_kernels: bool = True) -> torch.Tensor:
        attn = _attend(self.attn, self.norm1(x), self.windowed, self.window_size)
        pcm = _nhwc(self.PCM(_nchw(x)))
        x = x + self.drop_path(attn, generator) + self.drop_path(pcm, generator)
        return x + self.drop_path(self.mlp(self.norm2(x), use_kernels), generator)


class BasicLayer(nn.Module):
    def __init__(self, rc: ReductionCell, ncs: Sequence[NormalCell]) -> None:
        super().__init__()
        self.RC = rc
        self.NC = nn.ModuleList(ncs)


class ViTAEv2(nn.Module):
    """``forward`` takes NHWC images and returns [img, c1, c2, c3, c4] with
    NCHW maps (strides 4, 8, 16, 32)."""

    def __init__(self, embed_dims: Tuple[int, ...] = (64, 64, 128, 256),
                 token_dims: Tuple[int, ...] = (64, 128, 256, 512),
                 downsample_ratios: Tuple[int, ...] = (4, 2, 2, 2),
                 NC_depth: Tuple[int, ...] = (2, 2, 8, 2), NC_heads: Tuple[int, ...] = (1, 2, 4, 8),
                 RC_heads: Tuple[int, ...] = (1, 1, 2, 4),
                 NC_group: Tuple[int, ...] = (1, 32, 64, 128),
                 RC_group: Tuple[int, ...] = (1, 16, 32, 64),
                 RC_kernel: Tuple[int, ...] = (7, 3, 3, 3),
                 dilations: Tuple[Tuple[int, ...], ...] = ((1, 2, 3, 4), (1, 2, 3), (1, 2),
                                                           (1, 2)),
                 tokens_types: Tuple[str, ...] = ("swin", "swin", "transformer", "transformer"),
                 window_size: int = 7, drop_path_rate: float = 0.3,
                 use_checkpoint: bool = False) -> None:
        super().__init__()
        self.token_dims = tuple(token_dims)
        self.NC_depth = tuple(NC_depth)
        self.use_checkpoint = use_checkpoint
        dpr = np.linspace(0, drop_path_rate, sum(NC_depth))
        layers, in_ch = [], 3
        for s in range(len(token_dims)):
            rc = ReductionCell(in_ch, embed_dims[s], token_dims[s], downsample_ratios[s],
                               RC_heads[s], RC_kernel[s], dilations[s], tokens_types[s],
                               window_size, RC_group[s])
            # the reference's slices: stage s starts at NC_depth[s - 1], not a running sum
            start = 0 if s == 0 else NC_depth[s - 1]
            ncs = [NormalCell(token_dims[s], NC_heads[s], tokens_types[s], window_size,
                              NC_group[s], drop_path=float(dpr[start + b]))
                   for b in range(NC_depth[s])]
            layers.append(BasicLayer(rc, ncs))
            in_ch = token_dims[s]
        self.layers = nn.ModuleList(layers)

    @property
    def out_channels(self) -> Tuple[int, ...]:
        return (3,) + self.token_dims

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                use_kernels: bool = True) -> List[torch.Tensor]:
        img = x
        ckpt = self.use_checkpoint and self.training  # per-block activation checkpointing
        feats = []
        for layer in self.layers:
            x = run_block(layer.RC, x, generator, use_kernels, ckpt)
            for cell in layer.NC:
                x = run_block(cell, x, generator, use_kernels, ckpt)
            feats.append(_nchw(x).contiguous())
        return [img, *feats]


def vitaev2_s(**kw) -> ViTAEv2:
    """ViTAEv2-S (base_model.py:307-330): the defaults above."""
    return ViTAEv2(**kw)
