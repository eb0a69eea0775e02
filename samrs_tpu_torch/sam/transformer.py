"""SAM two-way (token <-> image) transformer (mirrors the module composition
of samrs_tpu/sam/transformer.py).  Shapes are (B, N, C); the decoder runs in
fp32.  LayerNorm eps is 1e-5 here."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

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


class TwoWayAttentionBlock(nn.Module):
    """transformer.py:109-182."""

    def __init__(self, embedding_dim: int, num_heads: int, mlp_dim: int = 2048,
                 attention_downsample_rate: int = 2, skip_first_layer_pe: bool = False) -> None:
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
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries: torch.Tensor, keys: torch.Tensor, query_pe: torch.Tensor,
                key_pe: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)

        q = queries + query_pe
        k = keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))

        queries = self.norm3(queries + self.mlp(queries))

        q = queries + query_pe
        k = keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    """transformer.py:16-107."""

    def __init__(self, depth: int = 2, embedding_dim: int = 256, num_heads: int = 8,
                 mlp_dim: int = 2048, attention_downsample_rate: int = 2) -> None:
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(embedding_dim, num_heads, mlp_dim, attention_downsample_rate,
                                 skip_first_layer_pe=(i == 0))
            for i in range(depth)
        )
        self.final_attn_token_to_image = AttentionDownsample(
            embedding_dim, num_heads, attention_downsample_rate)
        self.norm_final_attn = nn.LayerNorm(embedding_dim)

    def forward(self, image_embedding: torch.Tensor, image_pe: torch.Tensor,
                point_embedding: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """image_embedding (1 or B, H, W, C), image_pe (H, W, C),
        point_embedding (B, N, C) -> (queries (B, N, C), keys (B, HW, C)).
        A batch-1 image broadcasts to the prompt batch as a view."""
        b, h, w, c = image_embedding.shape
        bt = point_embedding.shape[0]
        keys = image_embedding.reshape(b, h * w, c).expand(bt, h * w, c)
        key_pe = image_pe.reshape(1, h * w, c).expand(bt, h * w, c)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q = queries + point_embedding
        k = keys + key_pe
        queries = self.norm_final_attn(queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys
