"""The composite SAM model (mirrors samrs_tpu/sam/sam.py).

``Sam.encode_image`` runs the encoder (bf16 on CUDA, fp32 on the CPU) and
returns fp32 NHWC features; ``Sam.predict`` runs the prompt encoder and the
mask decoder against cached features.  ``Sam.use_kernels`` is the one
switch between the hand-written kernels (K1-K7, including the generate
driver's postprocess) and their plain PyTorch versions on the card.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from samrs_tpu_torch.core.config import SamConfig
from samrs_tpu_torch.sam.image_encoder import ImageEncoderViT
from samrs_tpu_torch.sam.mask_decoder import MaskDecoder
from samrs_tpu_torch.sam.prompt_encoder import PromptEncoder


def preprocess(x: torch.Tensor, pixel_mean: Sequence[float], pixel_std: Sequence[float],
               img_size: int) -> torch.Tensor:
    """(B, H, W, 3) pixels -> normalised, zero-padded (B, S, S, 3) fp32
    (sam.py:164-174: normalise, then bottom/right pad)."""
    mean = torch.tensor(pixel_mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(pixel_std, dtype=torch.float32, device=x.device)
    x = (x.float() - mean) / std
    h, w = x.shape[1], x.shape[2]
    return F.pad(x, (0, 0, 0, img_size - w, 0, img_size - h))


def postprocess_masks(masks: torch.Tensor, input_size: Tuple[int, int],
                      original_size: Tuple[int, int], img_size: int = 1024) -> torch.Tensor:
    """(B, M, h, w) low-res logits -> (B, M, *original_size) logits: bilinear
    upsample to img_size, crop to the resized input, bilinear to the original
    size (sam.py:133-162)."""
    masks = F.interpolate(masks, (img_size, img_size), mode="bilinear", align_corners=False)
    masks = masks[..., : input_size[0], : input_size[1]]
    return F.interpolate(masks, tuple(original_size), mode="bilinear", align_corners=False)


class Sam(nn.Module):
    """SAM = image encoder + prompt encoder + mask decoder (sam.py:18)."""

    def __init__(self, cfg: SamConfig, use_kernels: bool = True) -> None:
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.use_kernels = use_kernels
        self.image_encoder = ImageEncoderViT(
            img_size=c.image_size, patch_size=c.patch_size, embed_dim=c.encoder_embed_dim,
            depth=c.encoder_depth, num_heads=c.encoder_num_heads, out_chans=c.prompt_embed_dim,
            window_size=c.window_size, global_attn_indexes=c.encoder_global_attn_indexes,
            window_attn_impl=c.window_attn_impl, global_attn_impl=c.global_attn_impl,
            mlp_impl=c.mlp_impl, tail_impl=c.tail_impl,
        )
        self.prompt_encoder = PromptEncoder(
            embed_dim=c.prompt_embed_dim, image_embedding_size=(c.grid_size, c.grid_size),
            input_image_size=(c.image_size, c.image_size), mask_in_chans=c.mask_in_chans,
        )
        self.mask_decoder = MaskDecoder(
            transformer_dim=c.prompt_embed_dim, transformer_depth=c.decoder_depth,
            transformer_mlp_dim=c.decoder_mlp_dim, transformer_num_heads=c.decoder_num_heads,
            num_multimask_outputs=c.num_multimask_outputs, iou_head_depth=c.iou_head_depth,
            iou_head_hidden_dim=c.iou_head_hidden_dim,
        )

    @torch.no_grad()
    def encode_image(self, x: torch.Tensor) -> torch.Tensor:
        """Preprocessed (B, S, S, 3) -> (B, S/16, S/16, 256) fp32 features."""
        return self.image_encoder(x, self.use_kernels).float()

    @torch.no_grad()
    def predict(self, image_embeddings: torch.Tensor, points: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None, mask_inputs: Optional[torch.Tensor] = None,
                multimask_output: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cached-features decode: prompts -> (low-res mask logits, iou)."""
        sparse, dense = self.prompt_encoder(points=points, labels=labels, masks=mask_inputs)
        return self.mask_decoder(image_embeddings, self.prompt_encoder.get_dense_pe(), sparse,
                                 dense, multimask_output, src_uniform=mask_inputs is None,
                                 use_kernels=self.use_kernels)
