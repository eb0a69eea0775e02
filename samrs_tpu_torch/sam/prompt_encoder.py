"""SAM prompt encoder (mirrors samrs_tpu/sam/prompt_encoder.py).

Points (B, N, 2) with labels (B, N) in {-1, 0, 1, 2, 3}: -1 is not-a-point,
0/1 negative/positive points, 2/3 the top-left / bottom-right corners of a
box.  Dense embeddings and the positional grid are NHWC.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from samrs_tpu_torch.nn.layers import LayerNorm2d


class PositionEmbeddingRandom(nn.Module):
    """Random-Fourier positional encoding (prompt_encoder.py:176-219)."""

    def __init__(self, num_pos_feats: int = 64) -> None:
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix", torch.zeros(2, num_pos_feats))

    def _pe_encoding(self, coords: torch.Tensor) -> torch.Tensor:
        coords = 2.0 * coords - 1.0
        coords = 2.0 * math.pi * (coords @ self.positional_encoding_gaussian_matrix)
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)

    def forward(self, size: Tuple[int, int]) -> torch.Tensor:
        """(H, W, C) grid of pixel-centre encodings."""
        h, w = size
        dev = self.positional_encoding_gaussian_matrix.device
        ys = (torch.arange(h, device=dev, dtype=torch.float32) + 0.5) / h
        xs = (torch.arange(w, device=dev, dtype=torch.float32) + 0.5) / w
        grid = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)], dim=-1)
        return self._pe_encoding(grid)

    def forward_with_coords(self, coords: torch.Tensor, image_size: Tuple[int, int]) -> torch.Tensor:
        c = coords / torch.tensor([image_size[1], image_size[0]], dtype=torch.float32,
                                  device=coords.device)
        return self._pe_encoding(c)


class PromptEncoder(nn.Module):
    def __init__(self, embed_dim: int = 256, image_embedding_size: Tuple[int, int] = (64, 64),
                 input_image_size: Tuple[int, int] = (1024, 1024), mask_in_chans: int = 16) -> None:
        super().__init__()
        self.embed_dim = embed_dim
        self.image_embedding_size = image_embedding_size
        self.input_image_size = input_image_size
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, embed_dim) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, embed_dim)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mask_in_chans // 4, kernel_size=2, stride=2),
            LayerNorm2d(mask_in_chans // 4),
            nn.GELU(),
            nn.Conv2d(mask_in_chans // 4, mask_in_chans, kernel_size=2, stride=2),
            LayerNorm2d(mask_in_chans),
            nn.GELU(),
            nn.Conv2d(mask_in_chans, embed_dim, kernel_size=1),
        )
        self.no_mask_embed = nn.Embedding(1, embed_dim)

    def get_dense_pe(self) -> torch.Tensor:
        """(H, W, embed_dim) positional grid of the image embedding."""
        return self.pe_layer(self.image_embedding_size)

    def _embed_points(self, points: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        pe = self.pe_layer.forward_with_coords(points + 0.5, self.input_image_size)
        lab = labels[..., None]
        out = torch.where(lab == -1, self.not_a_point_embed.weight, pe)
        for i, emb in enumerate(self.point_embeddings):
            out = torch.where(lab == i, pe + emb.weight, out)
        return out

    def forward(self, points: Optional[torch.Tensor] = None, labels: Optional[torch.Tensor] = None,
                masks: Optional[torch.Tensor] = None,
                batch: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (sparse (B, N, C), dense (B, H, W, C)); masks are
        (B, 4H, 4W, 1) low-res logits."""
        if points is not None:
            sparse = self._embed_points(points, labels)
            bs = points.shape[0]
        else:
            bs = batch
            sparse = torch.zeros(bs, 0, self.embed_dim, device=self.no_mask_embed.weight.device)
        if masks is not None:
            dense = self.mask_downscaling(masks.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        else:
            h, w = self.image_embedding_size
            dense = self.no_mask_embed.weight.reshape(1, 1, 1, -1).expand(bs, h, w, -1)
        return sparse, dense
