"""SAM model configuration for the PyTorch port.

The fields and variant table mirror ``samrs_tpu.core.config`` (``SamConfig``
shared hyper-parameters and ``SAM_VARIANTS``); the TPU implementation knobs
are not carried.  The port computes the encoder in bf16 on a CUDA device and
in fp32 on the CPU, and its kernel switch is the explicit ``use_kernels``
argument of ``build_sam``.  ``GenerateConfig`` mirrors the label-generation
driver's configuration.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple


@dataclass
class SamConfig:
    """Hyper-parameters of one SAM variant (build_sam.py:55-101 defaults)."""

    variant: str = "vit_b"
    encoder_embed_dim: int = 768
    encoder_depth: int = 12
    encoder_num_heads: int = 12
    encoder_global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11)
    image_size: int = 1024
    patch_size: int = 16
    window_size: int = 14
    prompt_embed_dim: int = 256
    mask_in_chans: int = 16
    decoder_depth: int = 2
    decoder_mlp_dim: int = 2048
    decoder_num_heads: int = 8
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    num_multimask_outputs: int = 3
    mask_threshold: float = 0.0
    pixel_mean: Tuple[float, float, float] = (123.675, 116.28, 103.53)
    pixel_std: Tuple[float, float, float] = (58.395, 57.12, 57.375)

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size


SAM_VARIANTS: Dict[str, Dict[str, Any]] = {
    "vit_h": dict(
        encoder_embed_dim=1280,
        encoder_depth=32,
        encoder_num_heads=16,
        encoder_global_attn_indexes=(7, 15, 23, 31),
    ),
    "vit_l": dict(
        encoder_embed_dim=1024,
        encoder_depth=24,
        encoder_num_heads=16,
        encoder_global_attn_indexes=(5, 11, 17, 23),
    ),
    "vit_b": dict(
        encoder_embed_dim=768,
        encoder_depth=12,
        encoder_num_heads=12,
        encoder_global_attn_indexes=(2, 5, 8, 11),
    ),
}


def sam_config(variant: str, **overrides: Any) -> SamConfig:
    if variant not in SAM_VARIANTS:
        raise KeyError(f"unknown SAM variant {variant!r}; have {list(SAM_VARIANTS)}")
    kw = dict(SAM_VARIANTS[variant])
    kw.update(overrides)
    return SamConfig(variant=variant, **kw)


@dataclass
class GenerateConfig:
    """Label-generation driver settings (samrs_tpu.core.config.GenerateConfig;
    the reference's GD/main_sam_*_semantic.py arguments)."""

    dataset: str = "dior"  # dota | dior | fair1m (a key of both LOADERS and CLASS_SETS)
    sam_variant: str = "vit_h"
    sam_checkpoint: Optional[str] = None
    image_dir: str = ""
    ann_dir: str = ""
    save_dir: str = ""
    box_buckets: Tuple[int, ...] = (16, 64, 256, 1024)  # prompt counts pad to a bucket
    shard_index: int = 0  # this process's shard of the image worklist
    shard_count: int = 1
    device: str = "cuda"
