"""Swin Transformer segmentation backbone (mirrors
samrs_tpu/seg/backbones/swin.py; reference ED/backbone/swin.py:162-696),
out_channels (3, 96, 192, 384, 768) for Swin-T.

Channels-last token maps throughout:

  * a 4x4 stride-4 patch-embedding conv ('SAME' padding, as flax's) and
    LayerNorm;
  * four stages of shifted-window blocks (window 7; every second block
    shifted by 3), each ``x += drop_path(attn(norm1 x)); x += drop_path(mlp(
    norm2 x))``.  A block pads its map bottom-right to a window multiple
    first, then rolls the PADDED map (ED/backbone/swin.py:219-252: the shift
    is kept on grids smaller than a window), attends within windows with the
    relative position bias and, when shifted, the -100 mask between the
    rolled regions, rolls back and crops;
  * an out-norm ``norm{s}`` on each stage's output (the mmseg convention),
    then patch merging (x0, x1, x2, x3 = the (0, 0), (1, 0), (0, 1), (1, 1)
    pixels of each 2x2, LayerNorm, a linear without bias to 2C);
  * every LayerNorm at eps 1e-5; drop path linspace(0, rate, sum(depths)).

The attention (logits, bias table, mask, softmax) is plain torch, as the JAX
package computes it outside any kernel; the MLPs run K11 under
``use_kernels``.  Module names follow the reference key layout that
samrs_tpu/seg/port.py:144-232 reads: ``patch_embed.proj`` / ``.norm``,
``layers.{s}.blocks.{b}.{norm1, attn.qkv, attn.proj,
attn.relative_position_bias_table, norm2, mlp.fc1, mlp.fc2}``,
``layers.{s}.downsample.{reduction, norm}``, ``norm{s}``; the relative
position index is a non-persistent buffer.  Drop-path draws from the
generator passed to ``forward``.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from samrs_tpu_torch.nn.layers import (DropPath, run_block, window_partition,
                                       window_unpartition)
from samrs_tpu_torch.seg.backbones.vit_common import Mlp


@functools.lru_cache(maxsize=64)
def shift_attn_mask(Hp: int, Wp: int, ws: int, shift: int, device: str) -> torch.Tensor:
    """(nW, ws*ws, ws*ws) additive mask (0 / -100) between the rolled regions
    of a shifted (Hp, Wp) map, on `device`."""
    img_mask = np.zeros((Hp, Wp), np.int32)
    cnt = 0
    for h in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for w in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[h, w] = cnt
            cnt += 1
    m = img_mask.reshape(Hp // ws, ws, Wp // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    mask = np.where(m[:, :, None] != m[:, None, :], -100.0, 0.0).astype(np.float32)
    return torch.from_numpy(mask).to(device)


def _rel_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) index of each (query, key) offset into the bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


class WindowAttention(nn.Module):
    """Multi-head attention within (nB, ws*ws, C) windows, with the relative
    position bias and an optional (nW, N, N) additive mask."""

    def __init__(self, dim: int, num_heads: int, window_size: int) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(_rel_index(window_size).reshape(-1)),
                             persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        nB, N, C = x.shape
        nH = self.num_heads
        hd = C // nH
        q, k, v = self.qkv(x).reshape(nB, N, 3, nH, hd).permute(2, 0, 3, 1, 4).unbind(0)
        attn = (q * hd ** -0.5) @ k.transpose(-1, -2)
        bias = self.relative_position_bias_table[self.relative_position_index]
        attn = attn + bias.reshape(N, N, nH).permute(2, 0, 1)[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(nB // nW, nW, nH, N, N) + mask[None, :, None]).reshape(
                nB, nH, N, N)
        out = attn.softmax(-1) @ v
        return self.proj(out.transpose(1, 2).reshape(nB, N, C))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7, shift: int = 0,
                 mlp_ratio: float = 4.0, drop_path: float = 0.0) -> None:
        super().__init__()
        self.window_size, self.shift = window_size, shift
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, window_size)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                use_kernels: bool = True) -> torch.Tensor:
        B, H, W, C = x.shape
        ws, shift = self.window_size, self.shift
        y = self.norm1(x)
        # pad bottom-right to a window multiple FIRST, then roll the padded map
        pad_b, pad_r = (-H) % ws, (-W) % ws
        if pad_b or pad_r:
            y = F.pad(y, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), (1, 2))
        wins, _ = window_partition(y, ws)
        mask = shift_attn_mask(Hp, Wp, ws, shift, str(x.device)) if shift > 0 else None
        y = self.attn(wins.reshape(-1, ws * ws, C), mask)
        y = window_unpartition(y.reshape(-1, ws, ws, C), ws, (Hp, Wp), (Hp, Wp))
        if shift > 0:
            y = torch.roll(y, (shift, shift), (1, 2))
        x = x + self.drop_path(y[:, :H, :W], generator)
        return x + self.drop_path(self.mlp(self.norm2(x), use_kernels), generator)


class PatchMerging(nn.Module):
    """2x2 neighbourhoods -> LayerNorm(4C) -> linear to 2C (no bias)."""

    def __init__(self, dim: int) -> None:
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      -1)
        return self.reduction(self.norm(x))


class PatchEmbed(nn.Module):
    """4x4 stride-4 conv ('SAME' padding, as flax's) and LayerNorm."""

    def __init__(self, embed_dim: int, patch: int = 4) -> None:
        super().__init__()
        self.patch = patch
        self.proj = nn.Conv2d(3, embed_dim, patch, patch)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch
        H, W = x.shape[1:3]
        pad_h, pad_w = (-H) % p, (-W) % p
        x = x.permute(0, 3, 1, 2)
        if pad_h or pad_w:
            x = F.pad(x, (pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2))
        return self.norm(self.proj(x).permute(0, 2, 3, 1))


class SwinLayer(nn.Module):
    def __init__(self, blocks, downsample: Optional[nn.Module]) -> None:
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class Swin(nn.Module):
    """``forward`` takes NHWC images and returns [img, c1, c2, c3, c4] with
    NCHW maps (strides 4, 8, 16, 32)."""

    def __init__(self, embed_dim: int = 96, depths: Tuple[int, ...] = (2, 2, 6, 2),
                 num_heads: Tuple[int, ...] = (3, 6, 12, 24), window_size: int = 7,
                 drop_path_rate: float = 0.2, use_checkpoint: bool = False) -> None:
        super().__init__()
        self.embed_dim = embed_dim
        self.depths = tuple(depths)
        self.use_checkpoint = use_checkpoint
        self.patch_embed = PatchEmbed(embed_dim)
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        layers, blk = [], 0
        for s, depth in enumerate(depths):
            dim = embed_dim * 2 ** s
            blocks = [SwinBlock(dim, num_heads[s], window_size,
                                0 if b % 2 == 0 else window_size // 2,
                                drop_path=float(dpr[blk + b])) for b in range(depth)]
            blk += depth
            layers.append(SwinLayer(blocks, PatchMerging(dim) if s < len(depths) - 1 else None))
            self.add_module(f"norm{s}", nn.LayerNorm(dim, eps=1e-5))
        self.layers = nn.ModuleList(layers)

    @property
    def out_channels(self) -> Tuple[int, ...]:
        return (3,) + tuple(self.embed_dim * 2 ** i for i in range(len(self.depths)))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                use_kernels: bool = True) -> List[torch.Tensor]:
        img = x
        ckpt = self.use_checkpoint and self.training  # per-block activation checkpointing
        x = self.patch_embed(x)
        feats = []
        for s, layer in enumerate(self.layers):
            for blk in layer.blocks:
                x = run_block(blk, x, generator, use_kernels, ckpt)
            feats.append(getattr(self, f"norm{s}")(x).permute(0, 3, 1, 2).contiguous())
            if layer.downsample is not None:
                x = layer.downsample(x)
        return [img, *feats]


def swin_t(**kw) -> Swin:
    """Swin-T as the SEP pretraining builds it (ED/models.py:73-81): drop path
    0.3."""
    cfg = dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24), drop_path_rate=0.3)
    cfg.update(kw)
    return Swin(**cfg)
