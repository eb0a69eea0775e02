"""Shared pieces of the plain-ViT and RVSA segmentation backbones (mirrors
samrs_tpu/seg/backbones/vit_common.py).

Tokens are NHWC; the neck returns NCHW maps for the decoders.  Module names
follow the reference layout (ED/backbone/vit_win_rvsa_v3_wsz7.py): ``mlp.fc1``
/ ``mlp.fc2``, and the neck's ``fpn1.0`` (deconv), ``fpn1.1.ln`` (Norm2d),
``fpn1.3``, ``fpn2.0`` at the backbone's top level.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from samrs_tpu_torch.nn.layers import DropPath
from samrs_tpu_torch.sam.image_encoder import add_decomposed_rel_pos


class FullAttentionRelPos(nn.Module):
    """Global attention over the whole token grid, with the decomposed
    rel-pos bias when ``use_rel_pos`` (vit_common.py:22-74); RVSA's full
    blocks define none (``use_rel_pos=False``).  fp32 logits and softmax."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 input_size: Tuple[int, int] = (14, 14), use_rel_pos: bool = True) -> None:
        super().__init__()
        self.num_heads = num_heads
        hd = dim // num_heads
        self.scale = hd ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.use_rel_pos = use_rel_pos
        if use_rel_pos:
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, hd))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, hd))

    def forward(self, x: torch.Tensor, use_kernels: bool = True) -> torch.Tensor:
        B, H, W, C = x.shape
        nH = self.num_heads
        hd = C // nH
        qkv = self.qkv(x).reshape(B, H * W, 3, nH, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, B * nH, H * W, hd).unbind(0)
        attn = (q * self.scale) @ k.transpose(-1, -2)
        if self.use_rel_pos:
            attn = add_decomposed_rel_pos(attn, q, self.rel_pos_h, self.rel_pos_w, (H, W), (H, W))
        out = attn.softmax(-1) @ v
        out = out.reshape(B, nH, H, W, hd).permute(0, 2, 3, 1, 4).reshape(B, H, W, C)
        return self.proj(out)


class Mlp(nn.Module):
    """fc1 -> erf GELU -> fc2 (the reference's timm Mlp)."""

    def __init__(self, dim: int, hidden: int) -> None:
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class ViTBlock(nn.Module):
    """Pre-norm block (LayerNorm eps 1e-6) with a given attention module and
    optional layer-scale (vit_common.py:77-112).  Drop-path draws from the
    generator passed to ``forward``."""

    def __init__(self, dim: int, attn: nn.Module, mlp_ratio: float = 4.0, drop_path: float = 0.0,
                 init_values: Optional[float] = None) -> None:
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = attn
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        if init_values is not None:
            self.gamma_1 = nn.Parameter(torch.full((dim,), float(init_values)))
            self.gamma_2 = nn.Parameter(torch.full((dim,), float(init_values)))
        else:
            self.gamma_1 = self.gamma_2 = None

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                use_kernels: bool = True) -> torch.Tensor:
        y = self.attn(self.norm1(x), use_kernels=use_kernels)
        if self.gamma_1 is not None:
            y = self.gamma_1 * y
        x = x + self.drop_path(y, generator)
        y = self.mlp(self.norm2(x))
        if self.gamma_2 is not None:
            y = self.gamma_2 * y
        return x + self.drop_path(y, generator)


class Norm2d(nn.Module):
    """LayerNorm over the channels of an NCHW map (the reference's Norm2d,
    eps 1e-6, parameters under ``ln``)."""

    def __init__(self, dim: int) -> None:
        super().__init__()
        self.ln = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ln(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ViTFPNNeck(nn.Module):
    """4-branch FPN neck for patch-16 plain ViTs (vit_common.py:115-143):
    x4 up (deconv, Norm2d, erf GELU, deconv), x2 up (deconv), identity, 2x2
    max-pool.  Backbones in the reference layout inherit it, so that its
    ``fpn1``..``fpn4`` sit at their top level."""

    def __init__(self, embed_dim: int) -> None:
        super().__init__()
        d = embed_dim
        self.fpn1 = nn.Sequential(nn.ConvTranspose2d(d, d, 2, 2), Norm2d(d), nn.GELU(),
                                  nn.ConvTranspose2d(d, d, 2, 2))
        self.fpn2 = nn.Sequential(nn.ConvTranspose2d(d, d, 2, 2))
        self.fpn3 = nn.Identity()
        self.fpn4 = nn.MaxPool2d(2, 2)

    def neck(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """NHWC token maps -> contiguous NCHW c1..c4 (a channels-last map
        would carry its layout into every decoder op after it)."""
        ops = (self.fpn1, self.fpn2, self.fpn3, self.fpn4)
        return [op(f.permute(0, 3, 1, 2)).contiguous() for op, f in zip(ops, feats)]
