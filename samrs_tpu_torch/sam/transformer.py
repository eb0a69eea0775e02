"""SAM two-way (token <-> image) transformer, in the fused composition of
samrs_tpu/sam/transformer.py (``TwoWayTransformer._fused``).

The image side, a (B, 4096, 256) fp32 stream at a prompt bucket B, goes
through K4 (``t2i_kv_proj``: layer 0's token->image K/V, once) and K5
(``i2t_update``: per layer, the whole image->token update plus the next
attention's K/V).  The token side is plain fp32 PyTorch:
self-attention, token->image attention against the K/V the kernels emit,
the MLP, norms 1-3 and the final attention and norm.  Products of the image
side take bf16 operands with fp32 accumulation on CUDA and fp32 on the CPU.
The parameter tree is the official one (LayerNorm eps 1e-5).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from samrs_tpu_torch.kernels import fused_twoway
from samrs_tpu_torch.nn.layers import MLPBlock


class AttentionDownsample(nn.Module):
    """Multi-head attention with an internal channel downsample
    (transformer.py:185-240).  Official name: ``Attention``."""

    def __init__(self, embedding_dim: int, num_heads: int, downsample_rate: int = 1) -> None:
        super().__init__()
        self.internal_dim = embedding_dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embedding_dim, self.internal_dim)
        self.k_proj = nn.Linear(embedding_dim, self.internal_dim)
        self.v_proj = nn.Linear(embedding_dim, self.internal_dim)
        self.out_proj = nn.Linear(self.internal_dim, embedding_dim)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        return x.reshape(b, n, self.num_heads, c // self.num_heads).transpose(1, 2)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        q = self._split(self.q_proj(q))
        k = self._split(self.k_proj(k))
        v = self._split(self.v_proj(v))
        attn = (q @ k.transpose(-1, -2)) / (q.shape[-1] ** 0.5)
        out = attn.softmax(-1) @ v
        b, _, n, _ = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, n, self.internal_dim))

    def attend_image(self, queries: torch.Tensor, k_img: torch.Tensor,
                     v_img: torch.Tensor) -> torch.Tensor:
        """Token -> image attention against projected image K/V (1 or B, N,
        Ci) from K4/K5 (bf16 on the card): q, the logits, the softmax and
        its sums in fp32, since no tensor-core product needs them in bf16."""
        q = self._split(self.q_proj(queries)) / (self.internal_dim // self.num_heads) ** 0.5
        k = self._split(k_img).float()
        v = self._split(v_img).float()
        s = q @ k.transpose(-1, -2)
        out = s.softmax(-1) @ v
        b, _, n, _ = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, n, self.internal_dim))


class TwoWayAttentionBlock(nn.Module):
    """Parameters of one two-way layer (transformer.py:109-182)."""

    def __init__(self, embedding_dim: int, num_heads: int, mlp_dim: int = 2048,
                 attention_downsample_rate: int = 2) -> None:
        super().__init__()
        self.self_attn = AttentionDownsample(embedding_dim, num_heads)
        self.norm1 = nn.LayerNorm(embedding_dim)
        self.cross_attn_token_to_image = AttentionDownsample(
            embedding_dim, num_heads, attention_downsample_rate)
        self.norm2 = nn.LayerNorm(embedding_dim)
        self.mlp = MLPBlock(embedding_dim, mlp_dim, nn.ReLU)
        self.norm3 = nn.LayerNorm(embedding_dim)
        self.norm4 = nn.LayerNorm(embedding_dim)
        self.cross_attn_image_to_token = AttentionDownsample(
            embedding_dim, num_heads, attention_downsample_rate)


class TwoWayTransformer(nn.Module):
    """transformer.py:16-107."""

    def __init__(self, depth: int = 2, embedding_dim: int = 256, num_heads: int = 8,
                 mlp_dim: int = 2048, attention_downsample_rate: int = 2) -> None:
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(embedding_dim, num_heads, mlp_dim, attention_downsample_rate)
            for _ in range(depth)
        )
        self.final_attn_token_to_image = AttentionDownsample(
            embedding_dim, num_heads, attention_downsample_rate)
        self.norm_final_attn = nn.LayerNorm(embedding_dim)

    def forward(self, image_embedding: torch.Tensor, image_pe: torch.Tensor,
                point_embedding: torch.Tensor,
                use_kernels: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """image_embedding (1 or B, H, W, C) fp32, image_pe (H, W, C),
        point_embedding (B, Nt, C) -> (queries (B, Nt, C) fp32, keys (B, HW,
        C) in the image side's product dtype).  A batch-1 image is shared by
        the B prompts until layer 0's image->token update."""
        b, h, w, c = image_embedding.shape
        keys = image_embedding.reshape(b, h * w, c).float().contiguous()
        key_pe = image_pe.reshape(h * w, c).float().contiguous()
        kdt = torch.bfloat16 if keys.is_cuda else torch.float32
        tw = fused_twoway
        kv = tw.t2i_kv_proj if use_kernels else tw.t2i_kv_proj_plain
        i2t = tw.i2t_update if use_kernels else tw.i2t_update_plain
        B, Nt, _ = point_embedding.shape
        slots = -(-Nt // tw.NT) * tw.NT  # K5 takes the tokens in blocks of NT slots
        dev = point_embedding.device
        mask_bias = torch.where(torch.arange(slots, device=dev) < Nt, 0.0, -1e9)

        def pad(x: torch.Tensor) -> torch.Tensor:
            return F.pad(x, (0, 0, 0, slots - Nt)).contiguous()

        first = self.layers[0].cross_attn_token_to_image
        k_img, v_img = kv(keys, key_pe, first.k_proj.weight, first.k_proj.bias,
                          first.v_proj.weight, first.v_proj.bias, dtype=kdt)
        queries = point_embedding
        for i, layer in enumerate(self.layers):
            if i == 0:
                queries = layer.self_attn(queries, queries, queries)
            else:
                q = queries + point_embedding
                queries = queries + layer.self_attn(q, q, queries)
            queries = layer.norm1(queries)
            queries = layer.norm2(queries + layer.cross_attn_token_to_image.attend_image(
                queries + point_embedding, k_img, v_img))
            queries = layer.norm3(queries + layer.mlp(queries))

            last = i == len(self.layers) - 1
            nxt = self.final_attn_token_to_image if last else \
                self.layers[i + 1].cross_attn_token_to_image
            a = layer.cross_attn_image_to_token
            keys, k_img, v_img = i2t(
                keys, key_pe, pad(a.k_proj(queries + point_embedding)), pad(a.v_proj(queries)),
                mask_bias, a.q_proj.weight, a.q_proj.bias, a.out_proj.weight, a.out_proj.bias,
                layer.norm4.weight, layer.norm4.bias, nxt.k_proj.weight, nxt.k_proj.bias,
                nxt.v_proj.weight, nxt.v_proj.bias, a.num_heads, dtype=kdt,
                eps=layer.norm4.eps, out_dtype=kdt if last else torch.float32)
        queries = self.norm_final_attn(queries + self.final_attn_token_to_image.attend_image(
            queries + point_embedding, k_img, v_img))
        return queries, keys
