"""ViTDet-style SAM image encoder (mirrors samrs_tpu/sam/image_encoder.py).

NHWC in, NHWC out.  Parameters are fp32 with the official attribute names
(``patch_embed.proj``, ``blocks.{i}.attn.qkv``, ``neck.{0..3}``, ...).  The
compute dtype of the products follows the device: bf16 on CUDA, fp32 on the
CPU.  The residual stream between blocks and the neck stay fp32 on both: a
bf16 stream rounds every block's update into it, and two computations of
one block that differ below a bf16 ulp (a different summation order) then
part by whole ulps, block after block.  Per block:

  norm1 (fp32 statistics, output in the compute dtype)
  windowed blocks: K1 on the unpadded normed map, the residual added in
                   its proj epilogue
  global blocks:   qkv GEMM -> K2 on the raw (B, N, 3C) qkv -> proj GEMM
                   with the residual added in its epilogue
  K3 (LayerNorm + MLP + residual, fp32 in and out)

The global blocks' GEMMs are csrc/gemm.cu (``gemm.linear``) with the
kernels and ``gemm.linear_plain`` without, so both paths round alike.

``forward(x, use_kernels=False)`` runs the kernels' plain versions instead
(the comparison path on the card); ``Sam.use_kernels`` passes the switch.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from samrs_tpu_torch.kernels import flash_attention, fused_mlp, fused_window_layer, gemm
from samrs_tpu_torch.nn.layers import LayerNorm2d, MLPBlock


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """(2*max-1, hd) table -> (q_size, k_size, hd) gathered by relative
    coordinate, linearly resized first if its length differs
    (image_encoder.py:292-322)."""
    max_rel_dist = int(2 * max(q_size, k_size) - 1)
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos = F.interpolate(rel_pos.float().T[None], size=max_rel_dist, mode="linear")[0].T
    q_coords = torch.arange(q_size, device=rel_pos.device)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=rel_pos.device)[None, :] * max(q_size / k_size, 1.0)
    relative = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[relative.long()]


def add_decomposed_rel_pos(attn: torch.Tensor, q: torch.Tensor, rel_pos_h: torch.Tensor,
                           rel_pos_w: torch.Tensor, q_hw: Tuple[int, int],
                           k_hw: Tuple[int, int]) -> torch.Tensor:
    """Add the decomposed relative-position bias to attention logits
    (image_encoder.py:325-361): attn (B, qh*qw, kh*kw), q (B, qh*qw, hd)."""
    q_h, q_w = q_hw
    k_h, k_w = k_hw
    Rh = get_rel_pos(q_h, k_h, rel_pos_h)
    Rw = get_rel_pos(q_w, k_w, rel_pos_w)
    B, _, dim = q.shape
    r_q = q.reshape(B, q_h, q_w, dim)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, Rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, Rw)
    attn = attn.reshape(B, q_h, q_w, k_h, k_w) + rel_h[..., :, None] + rel_w[..., None, :]
    return attn.reshape(B, q_h * q_w, k_h * k_w)


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.bfloat16 if x.is_cuda else torch.float32


class Attention(nn.Module):
    """Parameters of one block's attention (image_encoder.py:185-240)."""

    def __init__(self, dim: int, num_heads: int, input_size: Tuple[int, int]) -> None:
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.scale = head_dim ** -0.5
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, head_dim))


class Block(nn.Module):
    """Transformer block with window (window_size > 0) or global attention."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, window_size: int,
                 input_size: Tuple[int, int]) -> None:
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        attn_size = (window_size, window_size) if window_size > 0 else input_size
        self.attn = Attention(dim, num_heads, attn_size)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))
        self.window_size = window_size

    def forward(self, x: torch.Tensor, use_kernels: bool, dt: torch.dtype) -> torch.Tensor:
        """x: the fp32 residual stream; `dt` the dtype of the products."""
        B, H, W, C = x.shape
        a = self.attn
        xn = F.layer_norm(x.float(), (C,), self.norm1.weight, self.norm1.bias, 1e-6).to(dt)
        if self.window_size > 0:
            ws = self.window_size
            layer = (fused_window_layer.window_layer_attention if use_kernels
                     else fused_window_layer.window_layer_plain)
            x = layer(xn, a.qkv.weight, a.qkv.bias, a.proj.weight, a.proj.bias,
                      get_rel_pos(ws, ws, a.rel_pos_h), get_rel_pos(ws, ws, a.rel_pos_w),
                      ws, a.scale, a.num_heads, residual=x)
        else:
            attend = (flash_attention.attention_qkv_relpos if use_kernels
                      else flash_attention.attention_qkv_relpos_plain)
            linear = gemm.linear if use_kernels and x.is_cuda else gemm.linear_plain
            qkv = linear(xn.reshape(-1, C), a.qkv.weight, a.qkv.bias).reshape(B, H * W, 3 * C)
            y = attend(qkv, get_rel_pos(H, H, a.rel_pos_h), get_rel_pos(W, W, a.rel_pos_w),
                       (H, W), a.scale, a.num_heads)
            x = linear(y.reshape(-1, C), a.proj.weight, a.proj.bias,
                       residual=x.reshape(-1, C)).reshape(B, H, W, C)
        mlp = fused_mlp.ln_mlp_residual if use_kernels else fused_mlp.ln_mlp_residual_plain
        m = self.mlp
        return mlp(x, self.norm2.weight, self.norm2.bias, m.lin1.weight, m.lin1.bias,
                   m.lin2.weight, m.lin2.bias, 1e-6, dtype=dt)


class PatchEmbed(nn.Module):
    """16x16 / stride-16 patch conv (image_encoder.py:364-395), NHWC out."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int) -> None:
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        y = F.conv2d(x.permute(0, 3, 1, 2), self.proj.weight.to(dt), self.proj.bias.to(dt),
                     stride=self.proj.stride)
        return y.permute(0, 2, 3, 1)


class ImageEncoderViT(nn.Module):
    """(B, S, S, 3) preprocessed pixels -> (B, S/16, S/16, out_chans)."""

    def __init__(self, img_size: int = 1024, patch_size: int = 16, in_chans: int = 3,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, out_chans: int = 256, window_size: int = 14,
                 global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11)) -> None:
        super().__init__()
        grid = img_size // patch_size
        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio,
                  0 if i in global_attn_indexes else window_size, (grid, grid))
            for i in range(depth)
        )
        self.neck = nn.Sequential(
            nn.Conv2d(embed_dim, out_chans, kernel_size=1, bias=False),
            LayerNorm2d(out_chans),
            nn.Conv2d(out_chans, out_chans, kernel_size=3, padding=1, bias=False),
            LayerNorm2d(out_chans),
        )

    def forward(self, x: torch.Tensor, use_kernels: bool = True) -> torch.Tensor:
        dt = _compute_dtype(x)
        x = (self.patch_embed(x.to(dt)) + self.pos_embed.to(dt)).float()
        for blk in self.blocks:
            x = blk(x, use_kernels, dt)
        x = x.permute(0, 3, 1, 2)
        x = self.neck[1](F.conv2d(x, self.neck[0].weight.float()))
        x = self.neck[3](F.conv2d(x, self.neck[2].weight.float(), padding=1))
        return x.permute(0, 2, 3, 1)
