"""ViTDet-style SAM image encoder (mirrors samrs_tpu/sam/image_encoder.py).

NHWC in, NHWC out.  Parameters are fp32 with the official attribute names
(``patch_embed.proj``, ``blocks.{i}.attn.qkv``, ``neck.{0..3}``, ...), the
same for every kernel configuration.  The compute dtype of the products
follows the device: bf16 on CUDA, fp32 on the CPU.  The residual stream
between blocks and the neck stay fp32 on both: a bf16 stream rounds every
block's update into it, and two computations of one block that differ below
a bf16 ulp (a different summation order) then part by whole ulps, block
after block.  Per block (the defaults; ``Block`` dispatches every
``SamConfig`` knob as samrs_tpu/sam/image_encoder.py:180-470 does):

  norm1 (fp32 statistics, output in the compute dtype)
  windowed blocks: K1 on the unpadded normed map, the residual added in
                   its proj epilogue
  global blocks:   qkv GEMM -> K2 on the raw (B, N, 3C) qkv (N >= 2048) or
                   K12 on the split-head layout copy (N < 2048) -> proj GEMM
                   with the residual added in its epilogue
  K3 (LayerNorm + MLP + residual, fp32 in and out)

The dense layers outside K1 and K3 are csrc/gemm.cu (``gemm.linear``) with
the kernels and ``gemm.linear_plain`` without, so both paths round alike.

``forward(x, use_kernels=False)`` runs the kernels' plain versions instead
(the comparison path on the card); ``Sam.use_kernels`` passes the switch.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from samrs_tpu_torch.kernels import (flash_attention, fused_attention, fused_mlp,
                                     fused_window_block, fused_window_layer, gemm,
                                     window_attention)
from samrs_tpu_torch.nn.layers import LayerNorm2d, MLPBlock, window_partition, window_unpartition


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


# window_attn_impl -> K1's variant (the JAX package's names)
_K1_VARIANTS = {"block": None, "block_row": "row", "blockq": "qkv_out", "block_slab": "slab",
                "block_ijb": "ijb", "block_sg": "slab_ijb", "block2": None}


class Block(nn.Module):
    """Transformer block with window (window_size > 0) or global attention,
    in the kernel configuration of the four ``SamConfig`` knobs."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, window_size: int,
                 input_size: Tuple[int, int], window_attn_impl: str = "block_ijb",
                 global_attn_impl: str = "m", mlp_impl: str = "fused",
                 tail_impl: str = "xla") -> None:
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        attn_size = (window_size, window_size) if window_size > 0 else input_size
        self.attn = Attention(dim, num_heads, attn_size)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))
        self.window_size = window_size
        self.window_attn_impl = window_attn_impl
        self.global_attn_impl = global_attn_impl
        self.mlp_impl = mlp_impl
        # the coupling of the knobs, as the JAX Block derives it
        self.partition_free = window_size > 0 and (window_attn_impl == "fused2"
                                                   or window_attn_impl in _K1_VARIANTS)
        self.residual_in_kernel = self.partition_free and window_attn_impl == "block2"
        self.tail_fused = (self.partition_free and not self.residual_in_kernel
                           and mlp_impl == "fused" and tail_impl == "fused"
                           and window_attn_impl not in ("block_row", "blockq"))

    def _attention(self, qkv: torch.Tensor, hw: Tuple[int, int], use_kernels: bool,
                   dt: torch.dtype) -> torch.Tensor:
        """Attention.__call__ after its qkv Dense on a window or a global
        grid: ``qkv (B', N, 3C)`` -> ``(B', N, C)`` in `dt`."""
        a, impl = self.attn, self.window_attn_impl
        H, W = hw
        B, N, C3 = qkv.shape
        C, nH = C3 // 3, a.num_heads
        Rh, Rw = get_rel_pos(H, H, a.rel_pos_h), get_rel_pos(W, W, a.rel_pos_w)
        if impl == "fused" and N <= 1024:
            fused = (fused_attention.attention_qkv_fused if use_kernels
                     else fused_attention.attention_qkv_fused_plain)
            return fused(qkv, Rh, Rw, hw, a.scale, nH)
        if impl != "xla" and N >= 2048:
            attend = (flash_attention.attention_qkv_relpos if use_kernels
                      else flash_attention.attention_qkv_relpos_plain)
            return attend(qkv, Rh, Rw, hw, a.scale, nH, variant=self.global_attn_impl)
        # the layout copy: (B', N, 3, nH, hd) -> (3, B' * nH, N, hd)
        q, k, v = qkv.reshape(B, N, 3, nH, C // nH).permute(2, 0, 3, 1, 4).reshape(
            3, B * nH, N, C // nH).contiguous()
        if N >= 2048:
            attend = (flash_attention.flash_attention_relpos if use_kernels
                      else flash_attention.flash_attention_relpos_plain)
            out = attend(q, k, v, Rh, Rw, hw, a.scale)
        else:
            attend = (window_attention.window_attention_relpos if use_kernels
                      else window_attention.window_attention_relpos_plain)
            out = attend(q, k, v, Rh, Rw, hw, a.scale, force_xla=impl == "xla")
        return out.reshape(B, nH, N, C // nH).transpose(1, 2).reshape(B, N, C).to(dt)

    def _mlp_xla(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        """``mlp_impl="xla"``: norm2 (fp32) -> Dense -> exact GELU -> Dense
        in `dt` -> residual, the torch composition of the JAX MLPBlock."""
        C = x.shape[-1]
        m = self.mlp
        y = F.layer_norm(x, (C,), self.norm2.weight, self.norm2.bias, 1e-6).to(dt)
        y = F.gelu(F.linear(y, m.lin1.weight.to(dt), m.lin1.bias.to(dt)))
        return x + F.linear(y, m.lin2.weight.to(dt), m.lin2.bias.to(dt)).float()

    def forward(self, x: torch.Tensor, use_kernels: bool, dt: torch.dtype) -> torch.Tensor:
        """x: the fp32 residual stream; `dt` the dtype of the products."""
        B, H, W, C = x.shape
        a, ws = self.attn, self.window_size
        xn = F.layer_norm(x.float(), (C,), self.norm1.weight, self.norm1.bias, 1e-6).to(dt)
        linear = gemm.linear if use_kernels and x.is_cuda else gemm.linear_plain
        att_p = None  # the attention map the fused tail reads (padded for K1)
        if self.partition_free and self.window_attn_impl != "fused2":
            Rh, Rw = get_rel_pos(ws, ws, a.rel_pos_h), get_rel_pos(ws, ws, a.rel_pos_w)
            args = (a.qkv.weight, a.qkv.bias, a.proj.weight, a.proj.bias, Rh, Rw, ws, a.scale,
                    a.num_heads)
            layer = (fused_window_layer.window_layer_attention if use_kernels
                     else fused_window_layer.window_layer_plain)
            variant = _K1_VARIANTS[self.window_attn_impl]
            if self.tail_fused:
                att_p = layer(xn, *args, variant=variant, return_padded=True)
            else:  # the residual in the projection's epilogue: block2's form, the port's for all
                x = layer(xn, *args, residual=x, variant=variant)
        else:
            if self.partition_free:  # fused2: K1's attention stage on the raw qkv map
                qkv = linear(xn.reshape(-1, C), a.qkv.weight, a.qkv.bias).reshape(B, H, W, 3 * C)
                Rh, Rw = get_rel_pos(ws, ws, a.rel_pos_h), get_rel_pos(ws, ws, a.rel_pos_w)
                fill = a.qkv.bias if H % ws or W % ws else None
                pf = (fused_window_block.window_attention_partition_free if use_kernels
                      else fused_window_block.window_attention_partition_free_plain)
                y = pf(qkv, Rh, Rw, ws, a.scale, a.num_heads, pad_fill=fill)
            elif ws > 0:  # partitioned windows of the zero-padded normed map
                xw, pad_hw = window_partition(xn, ws)
                qkv = linear(xw.reshape(-1, C), a.qkv.weight, a.qkv.bias)
                y = self._attention(qkv.reshape(xw.shape[0], ws * ws, 3 * C), (ws, ws),
                                    use_kernels, dt)
                y = window_unpartition(y.reshape(-1, ws, ws, C), ws, pad_hw, (H, W))
            else:
                qkv = linear(xn.reshape(-1, C), a.qkv.weight, a.qkv.bias)
                y = self._attention(qkv.reshape(B, H * W, 3 * C), (H, W), use_kernels, dt)
            y = y.reshape(-1, C)
            if self.tail_fused:
                att_p = linear(y, a.proj.weight, a.proj.bias).reshape(B, H, W, C)
            else:
                x = linear(y, a.proj.weight, a.proj.bias,
                           residual=x.reshape(-1, C)).reshape(B, H, W, C)
        m = self.mlp
        weights = (m.lin1.weight, m.lin1.bias, m.lin2.weight, m.lin2.bias, 1e-6)
        if att_p is not None:
            tail = (fused_mlp.fused_tail_ln_mlp_residual if use_kernels
                    else fused_mlp.fused_tail_ln_mlp_residual_plain)
            return tail(att_p, x, self.norm2.weight, self.norm2.bias, *weights, dtype=dt)
        if self.mlp_impl == "xla":
            return self._mlp_xla(x, dt)
        mlp = fused_mlp.ln_mlp_residual if use_kernels else fused_mlp.ln_mlp_residual_plain
        return mlp(x, self.norm2.weight, self.norm2.bias, *weights, dtype=dt)


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
                 global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11),
                 window_attn_impl: str = "block_ijb", global_attn_impl: str = "m",
                 mlp_impl: str = "fused", tail_impl: str = "xla") -> None:
        super().__init__()
        grid = img_size // patch_size
        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio,
                  0 if i in global_attn_indexes else window_size, (grid, grid),
                  window_attn_impl, global_attn_impl, mlp_impl, tail_impl)
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
