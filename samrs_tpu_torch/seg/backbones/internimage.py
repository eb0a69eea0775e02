"""InternImage-T: the deformable-conv-v3 hierarchical CNN (mirrors
samrs_tpu/seg/backbones/internimage.py; reference ED/backbone/intern_image.py).

Channels-last throughout, as the reference is natively:

  * stem (intern_image.py:239-277): two 3x3 stride-2 convs, each followed by
    LayerNorm (eps 1e-6), GELU between them -> stride 4;
  * four levels (depths 4/4/18/4, groups 4/8/16/32, channels 64 doubling),
    each block ``x += drop_path(gamma1 * dcn(norm1 x)); x += drop_path(gamma2
    * mlp(norm2 x))`` (:336-527); a per-level LayerNorm before both the
    feature output and the downsample (3x3 stride-2 conv without bias + LN,
    :279-300); out_channels (3, 64, 128, 256, 512) (:639);
  * DCNv3 (ops_dcnv3/modules/dcnv3.py:221-320): input_proj; a depthwise 3x3
    conv + LN + exact GELU feeding the zero-initialised offset and mask
    linears; the mask softmaxed over the K taps of each group; the sampling
    through ``kernels.bilinear_gather.dcnv3`` (dense K8, or K8's row-slab
    form where ``SAMRS_BILINEAR_SLAB`` names a height that divides the map's,
    as the JAX module's ``dcnv3_pallas`` selects it) with
    ``dcn_impl="pallas"``, its plain version with ``"xla"`` or
    ``use_kernels=False``; output_proj.

The MLPs run K11 under ``use_kernels``.  Module names follow the reference's
key layout (the one samrs_tpu/seg/port.py:325-417 reads):
``patch_embed.conv{1,2}`` / ``norm{1,2}.1``,
``levels.{i}.blocks.{b}.{norm1.0, dcn.*, gamma1, norm2.0, mlp.fc1, mlp.fc2,
gamma2}`` with ``dcn.dw_conv.0`` (the conv) and ``dcn.dw_conv.1.1`` (its
LayerNorm), ``levels.{i}.norm.0``, ``levels.{i}.downsample.{conv, norm.1}``;
the index-0 slots of the ``*.1`` norms hold the reference's layout
permutes, which a channels-last map does not need.  Drop-path draws from the
generator passed to ``forward``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from samrs_tpu_torch.kernels import bilinear_gather
from samrs_tpu_torch.nn.layers import DropPath, checkpoint_with_generator
from samrs_tpu_torch.seg.backbones.vit_common import Mlp


def _ln(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-6)


def _permuted_ln(dim: int) -> nn.Sequential:
    """The reference's (permute, LayerNorm) pair; the permute is an identity
    on a channels-last map, the LayerNorm sits at index 1."""
    return nn.Sequential(nn.Identity(), _ln(dim))


def _conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class DCNv3Module(nn.Module):
    """The DCNv3 operator (dcnv3.py:221-320) on a channels-last map."""

    def __init__(self, channels: int, groups: int, kernel_size: int = 3,
                 offset_scale: float = 1.0, impl: str = "pallas") -> None:
        super().__init__()
        if impl not in ("pallas", "xla"):
            raise ValueError(f"dcn_impl must be 'pallas' or 'xla', got {impl!r}")
        C, K = channels, kernel_size * kernel_size
        self.channels, self.groups, self.kernel_size = C, groups, kernel_size
        self.offset_scale, self.impl = offset_scale, impl
        self.input_proj = nn.Linear(C, C)
        self.dw_conv = nn.ModuleList([nn.Conv2d(C, C, kernel_size, padding=kernel_size // 2,
                                                groups=C), _permuted_ln(C)])
        self.offset = nn.Linear(C, groups * K * 2)
        self.mask = nn.Linear(C, groups * K)
        self.output_proj = nn.Linear(C, C)
        self.reset_sampling()

    @torch.no_grad()
    def reset_sampling(self) -> None:
        """Zero offset and mask linears (the JAX module's initialisers): the
        taps start on the 3x3 grid around each pixel with equal weights."""
        for lin in (self.offset, self.mask):
            lin.weight.zero_()
            lin.bias.zero_()

    def forward(self, x: torch.Tensor, use_kernels: bool = True) -> torch.Tensor:
        B, H, W, C = x.shape
        G, ks = self.groups, self.kernel_size
        K = ks * ks
        value = self.input_proj(x)
        f = F.gelu(self.dw_conv[1](_conv_nhwc(self.dw_conv[0], x)))
        offset = self.offset(f)
        mask = self.mask(f).reshape(B, H, W, G, K).softmax(-1).reshape(B, H, W, G * K)
        out = bilinear_gather.dcnv3(value, offset, mask, ks, ks, 1, 1, ks // 2, ks // 2, 1, 1, G,
                                    C // G, self.offset_scale,
                                    plain=self.impl == "xla" or not use_kernels)
        return self.output_proj(out.to(x.dtype))


class InternImageBlock(nn.Module):
    """One InternImage layer (intern_image.py:336-413, post_norm=False)."""

    def __init__(self, channels: int, groups: int, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, layer_scale: Optional[float] = None,
                 dcn_impl: str = "pallas") -> None:
        super().__init__()
        self.norm1 = nn.Sequential(_ln(channels))
        self.dcn = DCNv3Module(channels, groups, impl=dcn_impl)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.Sequential(_ln(channels))
        self.mlp = Mlp(channels, int(channels * mlp_ratio))
        if layer_scale is not None:
            self.gamma1 = nn.Parameter(torch.full((channels,), float(layer_scale)))
            self.gamma2 = nn.Parameter(torch.full((channels,), float(layer_scale)))
        else:
            self.gamma1 = self.gamma2 = None

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                use_kernels: bool = True) -> torch.Tensor:
        y = self.dcn(self.norm1(x), use_kernels)
        if self.gamma1 is not None:
            y = self.gamma1 * y
        x = x + self.drop_path(y, generator)
        y = self.mlp(self.norm2(x), use_kernels)
        if self.gamma2 is not None:
            y = self.gamma2 * y
        return x + self.drop_path(y, generator)


class StemLayer(nn.Module):
    """conv1 -> LN -> GELU -> conv2 -> LN, stride 4 (intern_image.py:239-277)."""

    def __init__(self, channels: int) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(3, channels // 2, 3, stride=2, padding=1)
        self.norm1 = _permuted_ln(channels // 2)
        self.conv2 = nn.Conv2d(channels // 2, channels, 3, stride=2, padding=1)
        self.norm2 = _permuted_ln(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.gelu(self.norm1(_conv_nhwc(self.conv1, x)))
        return self.norm2(_conv_nhwc(self.conv2, x))


class DownsampleLayer(nn.Module):
    """3x3 stride-2 conv without bias + LN (intern_image.py:279-300)."""

    def __init__(self, channels: int) -> None:
        super().__init__()
        self.conv = nn.Conv2d(channels, 2 * channels, 3, stride=2, padding=1, bias=False)
        self.norm = _permuted_ln(2 * channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(_conv_nhwc(self.conv, x))


class InternImageLevel(nn.Module):
    def __init__(self, blocks: Sequence[InternImageBlock], channels: int,
                 downsample: bool) -> None:
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.norm = nn.Sequential(_ln(channels))
        self.downsample = DownsampleLayer(channels) if downsample else None


class InternImage(nn.Module):
    """``forward`` takes NHWC images and returns [img, c1, c2, c3, c4] with
    NCHW maps (strides 4, 8, 16, 32)."""

    def __init__(self, channels: int = 64, depths: Tuple[int, ...] = (4, 4, 18, 4),
                 groups: Tuple[int, ...] = (4, 8, 16, 32), mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.2, layer_scale: Optional[float] = None,
                 dcn_impl: str = "pallas", use_checkpoint: bool = False) -> None:
        super().__init__()
        self.channels = channels
        self.depths = tuple(depths)
        self.groups = tuple(groups)
        self.use_checkpoint = use_checkpoint
        self.patch_embed = StemLayer(channels)
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        levels, blk = [], 0
        for lvl, depth in enumerate(depths):
            ch = channels * 2 ** lvl
            blocks = [InternImageBlock(ch, groups[lvl], mlp_ratio, float(dpr[blk + b]),
                                       layer_scale, dcn_impl) for b in range(depth)]
            blk += depth
            levels.append(InternImageLevel(blocks, ch, lvl < len(depths) - 1))
        self.levels = nn.ModuleList(levels)

    @property
    def out_channels(self) -> Tuple[int, ...]:
        return (3,) + tuple(self.channels * 2 ** i for i in range(len(self.depths)))

    def _block(self, blk: InternImageBlock, x: torch.Tensor, generator, use_kernels: bool):
        if not (self.use_checkpoint and self.training):
            return blk(x, generator, use_kernels)
        # per-block activation checkpointing (the reference's use_checkpoint)
        return checkpoint_with_generator(lambda t, g: blk(t, g, use_kernels), x, generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                use_kernels: bool = True) -> List[torch.Tensor]:
        img = x
        x = self.patch_embed(x)
        feats = []
        for level in self.levels:
            for blk in level.blocks:
                x = self._block(blk, x, generator, use_kernels)
            x = level.norm(x)
            feats.append(x.permute(0, 3, 1, 2).contiguous())
            if level.downsample is not None:
                x = level.downsample(x)
        return [img, *feats]


def internimage_t(**kw) -> InternImage:
    """InternImage-T as the reference builds it (ED/models.py:89-102):
    layer_scale 1.0, drop_path_rate 0.2."""
    cfg = dict(channels=64, depths=(4, 4, 18, 4), groups=(4, 8, 16, 32), drop_path_rate=0.2,
               layer_scale=1.0)
    cfg.update(kw)
    return InternImage(**cfg)
