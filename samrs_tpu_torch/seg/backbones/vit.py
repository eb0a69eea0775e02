"""Plain ViT segmentation backbone (mirrors samrs_tpu/seg/backbones/vit.py;
reference ED/backbone/vit.py:184-388).

A timm-style ViT with full attention in every block and an optional
absolute pos-embed, a final LayerNorm, then the 4-branch FPN neck applied to
the last map (x4 up / x2 up / identity / 2x max-pool); out_channels
(3, D, D, D, D).  Under ``use_kernels`` every block's attention runs K10 and
every MLP K11.  State-dict keys follow the reference: ``patch_embed.proj``,
``pos_embed``, ``blocks.{i}.norm1 / attn.qkv / attn.proj / norm2 / mlp.fc1 /
mlp.fc2``, ``norm``, ``fpn1`` .. ``fpn4``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from samrs_tpu_torch.nn.layers import checkpoint_with_generator, resize_bicubic_jax
from samrs_tpu_torch.nn.layers import jax_bicubic_weights  # noqa: F401 (importable here too)
from samrs_tpu_torch.sam.image_encoder import PatchEmbed
from samrs_tpu_torch.seg.backbones.vit_common import FullAttentionRelPos, ViTBlock, ViTFPNNeck


class PlainAttention(FullAttentionRelPos):
    """Full attention without rel-pos (vit.py:24-62): K10 under ``use_kernels``."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True) -> None:
        super().__init__(dim, num_heads, qkv_bias, use_rel_pos=False)


class ViTSeg(ViTFPNNeck):
    """Plain ViT trunk + final norm + FPN neck.  ``forward`` takes NHWC images
    and returns [img, c1, c2, c3, c4] with NCHW maps (vit.py:66-113)."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.1, use_abs_pos_emb: bool = True,
                 use_checkpoint: bool = False) -> None:
        super().__init__(embed_dim)
        self.img_size, self.patch_size, self.embed_dim = img_size, patch_size, embed_dim
        self.depth = depth
        self.use_checkpoint = use_checkpoint
        gp = img_size // patch_size
        self.patch_embed = PatchEmbed(patch_size, 3, embed_dim)
        self.pos_embed = (nn.Parameter(torch.zeros(1, gp * gp, embed_dim))
                          if use_abs_pos_emb else None)
        dpr = np.linspace(0, drop_path_rate, depth)
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, PlainAttention(embed_dim, num_heads), mlp_ratio, float(dpr[i]))
            for i in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    @property
    def out_channels(self) -> Tuple[int, ...]:
        d = self.embed_dim
        return (3, d, d, d, d)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                use_kernels: bool = True) -> List[torch.Tensor]:
        img = x
        x = self.patch_embed(x)
        B, Hp, Wp, D = x.shape
        if self.pos_embed is not None:
            gp = self.img_size // self.patch_size
            pos = self.pos_embed.reshape(1, gp, gp, D)
            if (gp, gp) != (Hp, Wp):  # apply-time resize, as the JAX module does
                pos = resize_bicubic_jax(pos, (Hp, Wp))
            x = x + pos
        for blk in self.blocks:
            if self.use_checkpoint and self.training:
                x = checkpoint_with_generator(lambda t, g, b=blk: b(t, g, use_kernels), x,
                                              generator)
            else:
                x = blk(x, generator, use_kernels)
        x = self.norm(x)
        return [img, *self.neck([x, x, x, x])]


def vit_b(image_size: int = 224, **kw) -> ViTSeg:
    """vit_b (vit.py:120-124): 768 wide, 12 blocks, 12 heads, abs pos-embed."""
    cfg = dict(embed_dim=768, depth=12, num_heads=12)
    cfg.update(kw)
    return ViTSeg(img_size=image_size, **cfg)
