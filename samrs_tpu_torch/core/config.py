"""SAM model configuration for the PyTorch port.

The fields and variant table mirror ``samrs_tpu.core.config`` (``SamConfig``
shared hyper-parameters and ``SAM_VARIANTS``), with the encoder's four
implementation knobs (``window_attn_impl``, ``global_attn_impl``,
``mlp_impl``, ``tail_impl``: the same names, defaults and value sets, each
selecting a kernel mode of the port).  The other implementation knobs of the
JAX package (``compute_dtype``, ``decode_dtype``, ``use_flash_attention``,
``upscale_impl``, ``twoway_impl``) are not carried: the port computes the
encoder in bf16 on a CUDA device and in fp32 on the CPU, and its kernel
switch is the explicit ``use_kernels`` argument of ``build_sam``.  ``GenerateConfig`` mirrors the label-generation
entry point's configuration; ``PretrainConfig`` (with ``OptimConfig`` and
``DataConfig``) the pretraining entry point's and ``FinetuneConfig`` the
finetuning entry point's, with the same fields, defaults and dotted
``a.b=value`` overrides (``Config.override``), plus ``device``.
"""

from __future__ import annotations

import dataclasses
import typing
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple


def _coerce(value: str, typ: Any) -> Any:
    """A CLI string as the annotated field type (samrs_tpu/core/config.py:28-50)."""
    origin = getattr(typ, "__origin__", None)
    if typ in (str, Any):
        return value
    if typ is bool:
        return value.lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    if origin in (tuple, list):
        elem = getattr(typ, "__args__", (str,))[0]
        out = [_coerce(p, elem) for p in value.split(",") if p]
        return tuple(out) if origin is tuple else out
    if origin is not None and type(None) in getattr(typ, "__args__", ()):  # Optional[...]
        if value.lower() in ("none", "null", ""):
            return None
        inner = [a for a in typ.__args__ if a is not type(None)][0]
        return _coerce(value, inner)
    return value


@dataclass
class Config:
    """Base of the entry points' configs: dotted-path CLI overrides."""

    def override(self, assignments: Sequence[str]) -> "Config":
        """Apply ``a.b.c=value`` overrides, returning a new config."""
        cfg = dataclasses.replace(self)
        for a in assignments:
            if "=" not in a:
                raise ValueError(f"override must be key=value, got {a!r}")
            path, value = a.split("=", 1)
            keys = path.split(".")
            objs = [cfg]
            for k in keys[:-1]:
                objs.append(getattr(objs[-1], k))
            owner, leaf = objs[-1], keys[-1]
            ftypes = typing.get_type_hints(type(owner))
            if leaf not in ftypes:
                raise KeyError(f"unknown config field {path!r}")
            updated = dataclasses.replace(owner, **{leaf: _coerce(value, ftypes[leaf])})
            for parent, key in zip(reversed(objs[:-1]), reversed(keys[:-1])):
                updated = dataclasses.replace(parent, **{key: updated})
            cfg = updated
        return cfg


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
    # Encoder kernel configurations (samrs_tpu/core/config.py:143-221).  The
    # windowed layers: the block family runs K1 on the unpadded map ("block",
    # "block_slab": plain window order; "block_ijb", "block_sg": batch
    # innermost; "block_row": one program per window row; "blockq": the qkv
    # GEMM outside; "block2": the residual inside), "fused2" K1's attention
    # stage on the raw qkv map, "fused" K1 on partitioned windows, "pallas"
    # K12 on split heads, "xla" the torch composition of the JAX oracle.
    window_attn_impl: str = "block_ijb"
    mlp_impl: str = "fused"  # K3 | "xla": Dense -> exact GELU -> Dense
    # "fused": crop + attention residual + LN2 + MLP + residual in one K3
    # tail call; takes effect only with mlp_impl="fused" and a block-family
    # window_attn_impl other than "block_row" / "blockq" / "block2"
    tail_impl: str = "xla"
    global_attn_impl: str = "m"  # K2's mode: "m" / "split" / "exp2" / "aug"

    WINDOW_ATTN_IMPLS = ("block", "fused", "fused2", "pallas", "xla",
                         "blockq", "block_row", "block2", "block_slab",
                         "block_ijb", "block_sg")
    MLP_IMPLS = ("fused", "xla")
    TAIL_IMPLS = ("fused", "xla")
    GLOBAL_ATTN_IMPLS = ("aug", "split", "exp2", "m")

    def __post_init__(self) -> None:
        for name, allowed in (("window_attn_impl", self.WINDOW_ATTN_IMPLS),
                              ("mlp_impl", self.MLP_IMPLS), ("tail_impl", self.TAIL_IMPLS),
                              ("global_attn_impl", self.GLOBAL_ATTN_IMPLS)):
            if getattr(self, name) not in allowed:
                raise ValueError(f"unknown {name} {getattr(self, name)!r}; have {allowed}")

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


@dataclass
class OptimConfig(Config):
    optimizer: str = "adamw"
    lr: float = 6e-5
    weight_decay: float = 0.05
    betas: Tuple[float, float] = (0.9, 0.999)
    layer_decay: float = 0.9  # layer-wise lr decay rate (mmcv_custom constructors)
    grad_clip: float = 5.0  # ED/main_pretrain.py:616
    warmup_iters: int = 1500
    min_lr_ratio: float = 0.0
    schedule: str = "cosine"  # per-iteration (ED/main_pretrain.py:656)


@dataclass
class DataConfig(Config):
    root: str = "/data/samrs"
    datasets: Tuple[str, ...] = ("sota", "sior", "fast")
    image_size: int = 224
    batch_size: int = 96  # global; split by subset size (ED/main_pretrain.py:233-269)
    num_workers: int = 8
    val_images: int = 500  # last-500 val split (ED/datasets.py:55-56)


@dataclass
class PretrainConfig(Config):
    """samrs_tpu.core.config.PretrainConfig, plus ``device``.  The data mesh
    is the ranks torchrun starts, one card each (``core/mesh.py``):
    ``mesh_shape`` (-1) is every rank, an explicit shape must multiply to
    the world size; ``mesh_axes`` is kept for the same overrides."""

    backbone: str = "vit_b_rvsa"
    decoder: str = "upernet"
    init: str = "none"
    pretrained: Optional[str] = None
    total_iters: int = 80_000
    eval_interval: int = 1000
    seed: int = 2023
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    ckpt_dir: str = "checkpoints/pretrain"
    resume: Optional[str] = None
    mesh_shape: Tuple[int, ...] = (-1,)
    mesh_axes: Tuple[str, ...] = ("data",)
    m2f_num_points: Optional[int] = None
    remat: bool = False  # per-block activation checkpointing
    device: str = "cuda"


@dataclass
class FinetuneConfig(Config):
    """samrs_tpu.core.config.FinetuneConfig, plus ``device``."""

    dataset: str = "potsdam"  # potsdam | vaihingen | isaid
    backbone: str = "vit_b_rvsa"
    decoder: str = "upernet"
    epochs: int = 75
    image_size: int = 512  # 512/512/896 per dataset (main_finetune.py:166-229)
    batch_size: int = 8
    seed: int = 2023
    pretrained: Optional[str] = None  # the SEP encoder checkpoint ({tag}_encoder.pt)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    ckpt_dir: str = "checkpoints/finetune"
    device: str = "cuda"
