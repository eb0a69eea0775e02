"""ViT-Adapter-B backbone and its multi-scale deformable attention (mirrors
samrs_tpu/seg/backbones/vit_adapter.py; reference ED/backbone/vit_adapter.py
and ED/backbone/ops/modules/ms_deform_attn.py:28).

``MSDeformAttnModule``: value projection, per-query sampling offsets and
attention weights (softmax over levels x points), and the weighted bilinear
sampling of every level through K8 (``kernels.bilinear_gather``) under
``use_kernels``.  ``SAMRS_MSDA_IMPL`` selects the sampling as in the JAX
module: ``pallas`` (the default) is K8 on every level, ``xla`` the plain
version, ``hybrid[:rows[:big]]`` ``ms_deform_attn_hybrid`` (levels of at
least `rows` rows, 128 by default, on the plain version, or on dense K8 for
``big=ghb``; the others on K8).  Mask2Former's pixel decoder uses it too.

``ViTAdapter`` (``vit_adapter_b``): a plain ViT of layer-scaled blocks
(attention through K10, MLP through K11 under ``use_kernels``), the conv
``SpatialPriorModule`` (c1..c4 at strides 4..32; BatchNorm with flax's
momentum 0.9 and eps 1e-5), and one interaction a group of blocks: an
injector (a three-level MSDeformAttn from the conv tokens into the ViT
tokens, scaled by a zero-initialised gamma) before the group, an extractor
(a one-level MSDeformAttn from the ViT tokens into the conv tokens, then
``ConvFFN``) after it, and two extra extractors after the last group.  Then
``up`` (2x2 / stride-2 transposed conv of c2 into c1), each interaction's ViT
map added to the matching scale (x4 up / x2 up / as is / x2 down, torch's
bilinear, which is ``jax.image.resize(..., antialias=False)``; the final map
to every scale when there are not 4 interactions) and the BatchNorms
``norm1``..``norm4``.  NHWC images in, [img, f1..f4] NCHW out.  Parameters
follow the reference key layout (samrs_tpu/seg/port.py:564-790): ``spm.stem.{0,1,3,4,6,7}``,
``spm.conv{2,3,4}.{0,1}``, ``spm.fc{1..4}``, ``level_embed``,
``interactions.{i}.injector.{gamma, query_norm, feat_norm, attn}``,
``interactions.{i}.extractor.{query_norm, feat_norm, attn, ffn.{fc1,
dwconv.dwconv, fc2}, ffn_norm}``, ``interactions.{last}.extra_extractors.{j}``,
``blocks.{i}.{gamma1, gamma2, norm1, attn.qkv, attn.proj, norm2, mlp.fc1,
mlp.fc2}``, ``patch_embed.proj``, ``pos_embed``, ``up``, ``norm1``..``norm4``.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from samrs_tpu_torch.kernels import bilinear_gather
from samrs_tpu_torch.nn.layers import (checkpoint_with_generator, resize_bicubic_jax,
                                       resize_bilinear)
from samrs_tpu_torch.sam.image_encoder import PatchEmbed
from samrs_tpu_torch.seg.backbones.vit import PlainAttention
from samrs_tpu_torch.seg.backbones.vit_common import ViTBlock
from samrs_tpu_torch.seg.decoders.blocks import BatchNorm


def _grid_init(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """Rotated-unit-grid bias of the sampling offsets (ms_deform_attn.py
    ``_reset_parameters``), flattened (nH * L * P * 2,) fp32."""
    thetas = np.arange(n_heads) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)  # (nH, 2)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1).astype(np.float32)


def _ref_points(spatial_shapes: Sequence[Tuple[int, int]], device=None) -> torch.Tensor:
    """Normalised centre points (x, y) of every location of every level ->
    (1, S, 2) fp32."""
    pts = []
    for h, w in spatial_shapes:
        ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        pts.append(torch.stack([gx, gy], -1).reshape(-1, 2))
    return torch.cat(pts, 0)[None]


class MSDeformAttnModule(nn.Module):
    def __init__(self, d_model: int = 768, n_levels: int = 3, n_heads: int = 8,
                 n_points: int = 4, ratio: float = 1.0) -> None:
        super().__init__()
        self.n_heads, self.n_levels, self.n_points = n_heads, n_levels, n_points
        vdim = int(d_model * ratio)
        self.value_proj = nn.Linear(d_model, vdim)
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.output_proj = nn.Linear(vdim, d_model)

    @torch.no_grad()
    def reset_sampling(self) -> None:
        """The JAX module's initialisers of the sampling nets: zero kernels,
        the rotated grid as the offsets' bias, zero attention-weight bias."""
        self.sampling_offsets.weight.zero_()
        self.sampling_offsets.bias.copy_(torch.from_numpy(
            _grid_init(self.n_heads, self.n_levels, self.n_points)))
        self.attention_weights.weight.zero_()
        self.attention_weights.bias.zero_()

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor, value: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int]], use_kernels: bool = True):
        """query (B, Q, C); reference_points (B, Q, L, 2) in [0, 1]; value
        (B, S, C) -> (B, Q, C)."""
        B, Q, _ = query.shape
        S = value.shape[1]
        nH, L, P = self.n_heads, self.n_levels, self.n_points
        v = self.value_proj(value).reshape(B, S, nH, -1)
        offsets = self.sampling_offsets(query.float()).reshape(B, Q, nH, L, P, 2)
        weights = self.attention_weights(query.float()).reshape(B, Q, nH, L * P)
        weights = weights.softmax(-1).reshape(B, Q, nH, L, P)
        wh = torch.tensor([[w, h] for h, w in spatial_shapes], dtype=torch.float32,
                          device=query.device)
        locations = reference_points[:, :, None, :, None, :] + offsets / wh[:, None, :]
        impl = os.environ.get("SAMRS_MSDA_IMPL", "pallas")
        if use_kernels and impl.startswith("hybrid"):
            parts = impl.split(":")
            rows = int(parts[1]) if len(parts) > 1 and parts[1] else 128
            big = parts[2] if len(parts) > 2 else "xla"
            out = bilinear_gather.ms_deform_attn_hybrid(v.float(), spatial_shapes, locations,
                                                        weights, min_rows_xla=rows, big_impl=big)
        else:
            out = bilinear_gather.ms_deform_attn(v.float(), spatial_shapes, locations, weights,
                                                 plain=not use_kernels or impl == "xla")
        return self.output_proj(out.to(query.dtype))


def _conv_bn_relu(cin: int, cout: int, stride: int) -> List[nn.Module]:
    return [nn.Conv2d(cin, cout, 3, stride, 1, bias=False), BatchNorm(cout), nn.ReLU()]


class SpatialPriorModule(nn.Module):
    """Conv pyramid prior (vit_adapter.py:246-320): a three-conv stem and a
    3x3/s2 max-pool (stride 4), conv2..conv4 (strides 8..32), each level
    projected to the embedding width by a 1x1 conv.  NCHW."""

    def __init__(self, inplanes: int = 64, embed_dim: int = 768) -> None:
        super().__init__()
        w = inplanes
        self.stem = nn.Sequential(*_conv_bn_relu(3, w, 2), *_conv_bn_relu(w, w, 1),
                                  *_conv_bn_relu(w, w, 1), nn.MaxPool2d(3, 2, 1))
        self.conv2 = nn.Sequential(*_conv_bn_relu(w, 2 * w, 2))
        self.conv3 = nn.Sequential(*_conv_bn_relu(2 * w, 4 * w, 2))
        self.conv4 = nn.Sequential(*_conv_bn_relu(4 * w, 4 * w, 2))
        for i, cin in enumerate((w, 2 * w, 4 * w, 4 * w)):
            self.add_module(f"fc{i + 1}", nn.Conv2d(cin, embed_dim, 1))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        c1 = self.stem(x)
        c2 = self.conv2(c1)
        c3 = self.conv3(c2)
        c4 = self.conv4(c3)
        return self.fc1(c1), self.fc2(c2), self.fc3(c3), self.fc4(c4)


class DWConv(nn.Module):
    def __init__(self, dim: int) -> None:
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)


class ConvFFN(nn.Module):
    """fc1 -> ONE 3x3 depthwise conv applied to each level of the token
    stack -> exact GELU -> fc2 (vit_adapter.py:60-100).  Plain torch, as the
    JAX module computes it outside any kernel."""

    def __init__(self, dim: int, hidden: int) -> None:
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]]):
        B = x.shape[0]
        y = self.fc1(x)
        parts = [self.dwconv.dwconv(seg.transpose(1, 2).reshape(B, -1, h, w)).flatten(2)
                 for seg, (h, w) in zip(y.split([h * w for h, w in spatial_shapes], 1),
                                        spatial_shapes)]
        return self.fc2(F.gelu(torch.cat(parts, 2).transpose(1, 2)))


class Extractor(nn.Module):
    """ViT tokens -> conv tokens: a one-level MSDeformAttn, then ConvFFN
    (vit_adapter.py:101-137); LayerNorms eps 1e-6."""

    def __init__(self, dim: int, num_heads: int, n_points: int, deform_ratio: float,
                 cffn_ratio: float) -> None:
        super().__init__()
        self.query_norm = nn.LayerNorm(dim, eps=1e-6)
        self.feat_norm = nn.LayerNorm(dim, eps=1e-6)
        self.attn = MSDeformAttnModule(dim, 1, num_heads, n_points, deform_ratio)
        self.ffn = ConvFFN(dim, int(dim * cffn_ratio))
        self.ffn_norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, c, ref_c, t, shapes_x, shapes_c, use_kernels: bool = True):
        c = c + self.attn(self.query_norm(c), ref_c, self.feat_norm(t), shapes_x, use_kernels)
        return c + self.ffn(self.ffn_norm(c), shapes_c)


class Injector(nn.Module):
    """Conv tokens -> ViT tokens: a three-level MSDeformAttn scaled by
    ``gamma`` (zero at init)."""

    def __init__(self, dim: int, num_heads: int, n_points: int, n_levels: int,
                 deform_ratio: float) -> None:
        super().__init__()
        self.query_norm = nn.LayerNorm(dim, eps=1e-6)
        self.feat_norm = nn.LayerNorm(dim, eps=1e-6)
        self.attn = MSDeformAttnModule(dim, n_levels, num_heads, n_points, deform_ratio)
        self.gamma = nn.Parameter(torch.zeros(dim))

    def forward(self, t, ref_x, c, shapes_c, use_kernels: bool = True):
        return t + self.gamma * self.attn(self.query_norm(t), ref_x, self.feat_norm(c), shapes_c,
                                          use_kernels)


class InteractionBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, n_points: int, deform_ratio: float,
                 cffn_ratio: float, extra_extractor: bool) -> None:
        super().__init__()
        self.injector = Injector(dim, num_heads, n_points, 3, deform_ratio)
        self.extractor = Extractor(dim, num_heads, n_points, deform_ratio, cffn_ratio)
        self.extra_extractors = nn.ModuleList(
            Extractor(dim, num_heads, n_points, deform_ratio, cffn_ratio)
            for _ in range(2)) if extra_extractor else None


class AdapterBlock(ViTBlock):
    """The reference's vendored-TIMM block with layer scale (``gamma1`` /
    ``gamma2``, ones at init): attention through K10 and the MLP through
    K11 under ``use_kernels``."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, drop_path: float) -> None:
        super().__init__(dim, PlainAttention(dim, num_heads), mlp_ratio, drop_path)
        self.gamma1 = nn.Parameter(torch.ones(dim))
        self.gamma2 = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                use_kernels: bool = True) -> torch.Tensor:
        x = x + self.drop_path(self.gamma1 * self.attn(self.norm1(x), use_kernels=use_kernels),
                               generator)
        return x + self.drop_path(self.gamma2 * self.mlp(self.norm2(x), use_kernels), generator)


class ViTAdapter(nn.Module):
    def __init__(self, img_size: int = 224, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 interaction_indexes: Sequence[Tuple[int, int]] = ((0, 2), (3, 5), (6, 8),
                                                                   (9, 11)),
                 deform_num_heads: int = 12, n_points: int = 4, deform_ratio: float = 0.5,
                 cffn_ratio: float = 0.25, drop_path_rate: float = 0.3,
                 use_checkpoint: bool = False) -> None:
        super().__init__()
        D = self.embed_dim = embed_dim
        self.img_size, self.patch_size, self.depth = img_size, patch_size, depth
        self.interaction_indexes = tuple(tuple(ix) for ix in interaction_indexes)
        self.use_checkpoint = use_checkpoint
        gp = img_size // patch_size
        self.patch_embed = PatchEmbed(patch_size, 3, D)
        self.pos_embed = nn.Parameter(torch.zeros(1, gp * gp, D))
        self.level_embed = nn.Parameter(torch.zeros(3, D))
        self.spm = SpatialPriorModule(64, D)
        dpr = np.linspace(0, drop_path_rate, depth)
        self.blocks = nn.ModuleList(AdapterBlock(D, num_heads, mlp_ratio, float(dpr[i]))
                                    for i in range(depth))
        n = len(self.interaction_indexes)
        self.interactions = nn.ModuleList(
            InteractionBlock(D, deform_num_heads, n_points, deform_ratio, cffn_ratio, i == n - 1)
            for i in range(n))
        self.up = nn.ConvTranspose2d(D, D, 2, 2)
        for i in range(1, 5):
            self.add_module(f"norm{i}", BatchNorm(D))

    @property
    def out_channels(self) -> Tuple[int, ...]:
        d = self.embed_dim
        return (3, d, d, d, d)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX module's initialisers that differ from the frameworks'
        seeded init: ``level_embed`` normal(1.0)."""
        self.level_embed.copy_(torch.randn(self.level_embed.shape, generator=generator,
                                           device=generator.device).to(self.level_embed.device))

    def _block(self, blk: AdapterBlock, x: torch.Tensor, generator, use_kernels: bool):
        if not (self.use_checkpoint and self.training):
            return blk(x, generator, use_kernels)
        # per-block activation checkpointing (the reference's with_cp)
        return checkpoint_with_generator(lambda t, g: blk(t, g, use_kernels), x, generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                use_kernels: bool = True) -> List[torch.Tensor]:
        img = x
        B, D = x.shape[0], self.embed_dim
        c1, c2, c3, c4 = self.spm(x.permute(0, 3, 1, 2))
        shapes_c = [tuple(f.shape[-2:]) for f in (c2, c3, c4)]
        c = torch.cat([f.flatten(2).transpose(1, 2) + self.level_embed[i]
                       for i, f in enumerate((c2, c3, c4))], 1)
        t = self.patch_embed(x)
        Hp, Wp = t.shape[1:3]
        gp = self.img_size // self.patch_size
        pos = self.pos_embed.reshape(1, gp, gp, D)
        if (gp, gp) != (Hp, Wp):  # apply-time resize, as the JAX module does
            pos = resize_bicubic_jax(pos, (Hp, Wp))
        t = (t + pos).reshape(B, Hp * Wp, D)
        shapes_x = [(Hp, Wp)]
        ref_x = _ref_points(shapes_x, x.device)[:, :, None, :].expand(B, Hp * Wp, 3, 2)
        ref_c = _ref_points(shapes_c, x.device)[:, :, None, :].expand(B, c.shape[1], 1, 2)
        vit_outs = []
        for inter, (lo, hi) in zip(self.interactions, self.interaction_indexes):
            t = inter.injector(t, ref_x, c, shapes_c, use_kernels)
            t2d = t.reshape(B, Hp, Wp, D)
            for i in range(lo, hi + 1):
                t2d = self._block(self.blocks[i], t2d, generator, use_kernels)
            t = t2d.reshape(B, Hp * Wp, D)
            vit_outs.append(t2d)
            c = inter.extractor(c, ref_c, t, shapes_x, shapes_c, use_kernels)
            for ext in inter.extra_extractors or ():
                c = ext(c, ref_c, t, shapes_x, shapes_c, use_kernels)
        f2, f3, f4 = (part.transpose(1, 2).reshape(B, D, h, w) for part, (h, w) in
                      zip(c.split([h * w for h, w in shapes_c], 1), shapes_c))
        # add_vit_feature: each interaction's ViT map feeds the matching scale (:747-752);
        # with another interaction count the final map feeds every scale
        xs = vit_outs if len(vit_outs) == 4 else vit_outs[-1:] * 4
        x1, x2, x3, x4 = (v.permute(0, 3, 1, 2).float() for v in xs)
        f1 = c1 + self.up(f2) + resize_bilinear(x1, c1.shape[-2:]).to(c1.dtype)
        f2 = f2 + resize_bilinear(x2, f2.shape[-2:]).to(f2.dtype)
        f3 = f3 + x3.to(f3.dtype)
        f4 = f4 + resize_bilinear(x4, f4.shape[-2:]).to(f4.dtype)
        return [img, self.norm1(f1), self.norm2(f2), self.norm3(f3), self.norm4(f4)]


def vit_adapter_b(image_size: int = 224, **kw) -> ViTAdapter:
    """ViT-Adapter-B as the reference builds it (ED/models.py:105-122)."""
    cfg = dict(patch_size=16, embed_dim=768, depth=12, num_heads=12, deform_num_heads=12,
               n_points=4, deform_ratio=0.5, cffn_ratio=0.25, drop_path_rate=0.3)
    cfg.update(kw)
    return ViTAdapter(img_size=image_size, **cfg)
