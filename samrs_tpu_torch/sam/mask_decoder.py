"""SAM mask decoder (mirrors samrs_tpu/sam/mask_decoder.py with its default
``twoway_impl="fused"``, ``upscale_impl="fused"``).  The two-way
transformer's image side runs through K4/K5 and the upscaling tail with the
hypernetwork dot through K6, for the requested mask tokens only; token-side
work is fp32.  ``use_kernels=False`` runs the kernels' plain versions."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from samrs_tpu_torch.kernels import fused_upscale
from samrs_tpu_torch.nn.layers import MLP, LayerNorm2d
from samrs_tpu_torch.sam.transformer import TwoWayTransformer


class MaskDecoder(nn.Module):
    def __init__(self, transformer_dim: int = 256, transformer_depth: int = 2,
                 transformer_mlp_dim: int = 2048, transformer_num_heads: int = 8,
                 num_multimask_outputs: int = 3, iou_head_depth: int = 3,
                 iou_head_hidden_dim: int = 256) -> None:
        super().__init__()
        d = transformer_dim
        self.num_mask_tokens = num_multimask_outputs + 1
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, d)
        self.transformer = TwoWayTransformer(transformer_depth, d, transformer_num_heads,
                                             transformer_mlp_dim)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(d, d // 4, kernel_size=2, stride=2),
            LayerNorm2d(d // 4),
            nn.GELU(),
            nn.ConvTranspose2d(d // 4, d // 8, kernel_size=2, stride=2),
            nn.GELU(),
        )
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(d, d, d // 8, 3) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = MLP(d, iou_head_hidden_dim, self.num_mask_tokens,
                                       iou_head_depth)

    def forward(self, image_embeddings: torch.Tensor, image_pe: torch.Tensor,
                sparse_prompt_embeddings: torch.Tensor, dense_prompt_embeddings: torch.Tensor,
                multimask_output: bool = False, src_uniform: bool = False,
                use_kernels: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (masks (B, M, 4H, 4W), iou_pred (B, M)).

        src_uniform=True is a caller contract: every prompt shares one image
        and one dense (no-mask) embedding, so the image side stays at batch 1
        and broadcasts lazily."""
        idx = tuple(range(1, self.num_mask_tokens)) if multimask_output else (0,)
        masks, iou_pred = self.predict_masks(image_embeddings, image_pe, sparse_prompt_embeddings,
                                             dense_prompt_embeddings, idx, src_uniform,
                                             use_kernels)
        sl = slice(1, None) if multimask_output else slice(0, 1)
        return masks, iou_pred[:, sl]

    def predict_masks(self, image_embeddings: torch.Tensor, image_pe: torch.Tensor,
                      sparse_prompt_embeddings: torch.Tensor, dense_prompt_embeddings: torch.Tensor,
                      token_idx: Optional[Sequence[int]] = None, src_uniform: bool = False,
                      use_kernels: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (masks (B, len(token_idx), 4H, 4W), iou_pred (B, all tokens))."""
        B = sparse_prompt_embeddings.shape[0]
        output_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight], dim=0)
        tokens = torch.cat([output_tokens[None].expand(B, -1, -1), sparse_prompt_embeddings], dim=1)
        if src_uniform and image_embeddings.shape[0] == 1:
            src = image_embeddings + dense_prompt_embeddings[:1]
        else:
            src = image_embeddings + dense_prompt_embeddings
        h, w, c = src.shape[-3:]
        hs, keys = self.transformer(src, image_pe, tokens, use_kernels)
        iou_token_out = hs[:, 0, :]
        mask_tokens_out = hs[:, 1:1 + self.num_mask_tokens, :]

        idx = range(self.num_mask_tokens) if token_idx is None else token_idx
        hyper_in = torch.stack(
            [self.output_hypernetworks_mlps[i](mask_tokens_out[:, i, :]) for i in idx], dim=1)
        conv1, ln, conv2 = self.output_upscaling[0], self.output_upscaling[1], self.output_upscaling[3]
        upscale = fused_upscale.upscale_hyper if use_kernels else fused_upscale.upscale_hyper_plain
        masks = upscale(keys.reshape(B, h, w, c), conv1.weight, conv1.bias, ln.weight, ln.bias,
                        conv2.weight, conv2.bias, hyper_in, keys.dtype)
        return masks, self.iou_prediction_head(iou_token_out)
