"""Segmentation frameworks (mirrors samrs_tpu/seg/frameworks.py; reference
ED/models.py:52-318).

``MultiHeadSegModel``: one shared encoder and decoder, one classification
head per pretraining dataset (SOTA 18 / SIOR 20 / FAST 37 classes); the
encoder and decoder run once per dataset batch.  ``MultiHeadMask2FormerModel``:
the E2E variant, the shared encoder and a decoupled Mask2Former decoder with
a class head per dataset (E2E/models.py:219-276).  ``SegModel``: the single
head of finetuning and testing (ED/models.py:319-530).  Images go in NHWC
and the logits come out NHWC, as in the JAX package.  ``use_kernels``
(default True) is the one switch between the kernels (K8, K10, K11; and K9
in the Mask2Former loss, which the trainer routes by it) and their plain
versions on the card; only the smoke's comparison and the tests turn it
off.  Dropout and drop-path draw from the generator passed to ``forward``.
Heads follow the reference (models.py:14-21, :184-197): the UNet-style
decoders (``unet``, ``unetpp``) get a 3x3 conv with no dropout, UperNet
dropout 0.1 and a 1x1 conv.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from samrs_tpu_torch.nn.layers import Dropout, checkpoint_with_generator
from samrs_tpu_torch.seg.backbones.internimage import DCNv3Module
from samrs_tpu_torch.seg.backbones.vit_adapter import MSDeformAttnModule, ViTAdapter
from samrs_tpu_torch.seg.registry import get_backbone, get_decoder


def _head(decoder: str, in_channels: int, num_classes: int) -> "SegHead":
    if decoder in ("unet", "unetpp"):
        return SegHead(in_channels, num_classes, kernel=3, dropout=0.0)
    return SegHead(in_channels, num_classes, kernel=1, dropout=0.1)


class SegHead(nn.Module):
    """Dropout -> kxk conv to the classes, in fp32 (models.py:184-197)."""

    def __init__(self, in_channels: int, num_classes: int, kernel: int = 1,
                 dropout: float = 0.0) -> None:
        super().__init__()
        self.dropout = Dropout(dropout)
        self.conv = nn.Conv2d(in_channels, num_classes, kernel, padding=kernel // 2)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        return self.conv(self.dropout(x.float(), generator))


class MultiHeadSegModel(nn.Module):
    def __init__(self, backbone: str = "vit_b_rvsa", decoder: str = "upernet",
                 num_classes: Tuple[int, ...] = (18, 20, 37), image_size: int = 224,
                 remat: bool = False, use_kernels: bool = True) -> None:
        super().__init__()
        if decoder == "mask2former":
            raise KeyError("decoder 'mask2former' has its own model: MultiHeadMask2FormerModel")
        self.backbone, self.decoder = backbone, decoder
        self.num_classes = tuple(num_classes)
        self.image_size = image_size
        self.use_kernels = use_kernels
        # remat = per-block activation checkpointing (use_checkpoint)
        self.encoder = get_backbone(backbone, image_size=image_size, use_checkpoint=remat)
        self.seg_decoder = get_decoder(decoder, self.encoder.out_channels)
        ch = self.seg_decoder.out_features
        self.heads = nn.ModuleList(_head(decoder, ch, nc) for nc in self.num_classes)

    def forward_one(self, x: torch.Tensor, head_idx: int,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, H, W, 3) normalized images -> (B, H, W, classes) logits."""
        return _encode_decode(self, self.heads[head_idx], x, generator)

    def forward(self, xs: Sequence[Optional[torch.Tensor]],
                generator: Optional[torch.Generator] = None) -> List[Optional[torch.Tensor]]:
        """One batch per dataset (None skips that head) -> per-dataset logits."""
        return [None if x is None else self.forward_one(x, i, generator)
                for i, x in enumerate(xs)]


class MultiHeadMask2FormerModel(nn.Module):
    """Shared encoder + Mask2Former decoder, one class head per dataset.
    ``forward`` returns per dataset the list of (class logits, mask logits)
    of every decoder output, for ``mask2former_loss`` / ``mask2former_predict``."""

    def __init__(self, backbone: str = "vit_b_rvsa", num_classes: Tuple[int, ...] = (18, 20, 37),
                 image_size: int = 224, num_queries: int = 100, num_decoder_layers: int = 9,
                 use_kernels: bool = True) -> None:
        super().__init__()
        from samrs_tpu_torch.seg.decoders.mask2former import Mask2FormerHead

        self.backbone, self.decoder = backbone, "mask2former"
        self.num_classes = tuple(num_classes)
        self.image_size = image_size
        self.use_kernels = use_kernels
        self.encoder = get_backbone(backbone, image_size=image_size)
        self.seg_decoder = get_decoder("mask2former", self.encoder.out_channels,
                                       num_queries=num_queries,
                                       num_decoder_layers=num_decoder_layers)
        self.heads = nn.ModuleList(Mask2FormerHead(self.seg_decoder.embed_dim, nc)
                                   for nc in self.num_classes)

    def forward_one(self, x: torch.Tensor, head_idx: int,
                    generator: Optional[torch.Generator] = None):
        """(B, H, W, 3) normalized images -> [(class logits, mask logits)]."""
        feats = self.encoder(x, generator, self.use_kernels)
        return self.heads[head_idx](self.seg_decoder(feats, self.use_kernels))

    def forward(self, xs: Sequence[Optional[torch.Tensor]],
                generator: Optional[torch.Generator] = None):
        return [None if x is None else self.forward_one(x, i, generator)
                for i, x in enumerate(xs)]


def _encode_decode(model: nn.Module, head: nn.Module, x: torch.Tensor,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """Encoder, decoder and `head` of `model` on NHWC images -> NHWC logits.

    In training the decoder's 4x upsample, the head's dropout and its conv
    are recomputed in the backward instead of kept: their maps have the
    decoder's width at the input's size (154 MB an image at 768 x 224^2 in
    fp32; 6.4 GB for a finetune batch of 8 at 512^2), and a 94-image pretrain
    step does not fit 80 GB with them."""
    feats = model.encoder(x, generator, model.use_kernels)
    d = model.seg_decoder(feats, upsample=False)
    run_head = lambda t, g: head(model.seg_decoder.upsample(t), g)
    if model.training and torch.is_grad_enabled():
        out = checkpoint_with_generator(run_head, d, generator)
    else:
        out = run_head(d, generator)
    return out.permute(0, 2, 3, 1)


class SegModel(nn.Module):
    """Single-head model of finetuning and testing (frameworks.py:156-177):
    encoder, decoder, and the head (dropout 0.1 + 1x1 conv after UperNet, a
    3x3 conv after UNet / UNet++)."""

    def __init__(self, backbone: str = "vit_b_rvsa", decoder: str = "upernet",
                 num_classes: int = 6, image_size: int = 512, use_kernels: bool = True) -> None:
        super().__init__()
        self.backbone, self.decoder = backbone, decoder
        self.num_classes = num_classes
        self.image_size = image_size
        self.use_kernels = use_kernels
        self.encoder = get_backbone(backbone, image_size=image_size)
        self.seg_decoder = get_decoder(decoder, self.encoder.out_channels)
        self.head = _head(decoder, self.seg_decoder.out_features, num_classes)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, H, W, 3) normalized images -> (B, H, W, classes) logits."""
        return _encode_decode(self, self.head, x, generator)


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    w.copy_(torch.randn(w.shape, generator=generator, device=generator.device).to(w.device)
            * fan_in ** -0.5)


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded init in the JAX package's style: dense and conv weights
    lecun-normal, biases zero, norms ones/zeros (torch's default), the Swin
    bias tables and pos_embed normal(0.02); RVSA's sampling nets, DCNv3's
    offset and mask linears, MSDeformAttn's sampling nets and the rel-pos
    tables start as the JAX modules initialise them (so the sampling grid
    starts as the identity, the 3x3 grid or the rotated grid); the
    ViT-Adapter's ``level_embed`` normal(1.0); layer scales keep their
    constant."""
    for name, m in model.named_modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = m.weight[:, 0].numel() if isinstance(m, nn.ConvTranspose2d) \
                else m.weight[0].numel()
            _lecun_normal_(m.weight, fan_in, generator)
            if m.bias is not None:
                m.bias.zero_()
    for name, p in model.named_parameters():
        if ".sampling_" in name or name.endswith(("rel_pos_h", "rel_pos_w")):
            p.zero_()
        elif name.endswith(("relative_position_bias_table", "pos_embed")):
            p.copy_(torch.randn(p.shape, generator=generator, device=generator.device)
                    .to(p.device) * 0.02)
    for m in model.modules():
        if isinstance(m, (DCNv3Module, MSDeformAttnModule)):
            m.reset_sampling()
        elif isinstance(m, ViTAdapter):
            m.reset_parameters(generator)


@torch.no_grad()
def init_mask2former(model: nn.Module, generator: torch.Generator) -> None:
    """The JAX decoder's own initialisers, after ``init_parameters``: the
    MSDeformAttn sampling offsets a zero kernel and the rotated-grid bias,
    the attention weights zero, ``level_embed`` / ``query_feat`` /
    ``query_embed`` normal(1.0); GroupNorm stays ones and zeros."""
    for m in model.modules():
        if isinstance(m, MSDeformAttnModule):
            m.reset_sampling()
    for name, p in model.named_parameters():
        if name.endswith(("level_embed", "query_feat", "query_embed")):
            p.copy_(torch.randn(p.shape, generator=generator, device=generator.device)
                    .to(p.device))


def build_multihead_mask2former_model(backbone: str = "vit_b_rvsa",
                                      num_classes: Tuple[int, ...] = (18, 20, 37),
                                      image_size: int = 224, device="cuda",
                                      generator: Optional[torch.Generator] = None,
                                      **kw) -> MultiHeadMask2FormerModel:
    """The Mask2Former model on `device` (the card unless the caller asks
    for the CPU), initialised from `generator` (default: seed 0 on `device`)."""
    with torch.device(device):
        model = MultiHeadMask2FormerModel(backbone, num_classes, image_size, **kw).to(device)
    gen = generator or torch.Generator(device=device).manual_seed(0)
    init_parameters(model, gen)
    init_mask2former(model, gen)
    return model


def build_multihead_model(backbone: str = "vit_b_rvsa", decoder: str = "upernet",
                          num_classes: Tuple[int, ...] = (18, 20, 37), image_size: int = 224,
                          remat: bool = False, device="cuda",
                          generator: Optional[torch.Generator] = None) -> MultiHeadSegModel:
    """The model on `device` (the card unless the caller asks for the CPU),
    initialised from `generator` (default: seed 0 on `device`)."""
    with torch.device(device):
        model = MultiHeadSegModel(backbone, decoder, num_classes, image_size, remat).to(device)
    init_parameters(model, generator or torch.Generator(device=device).manual_seed(0))
    return model


def build_seg_model(backbone: str = "vit_b_rvsa", decoder: str = "upernet", num_classes: int = 6,
                    image_size: int = 512, device="cuda",
                    generator: Optional[torch.Generator] = None) -> SegModel:
    """The single-head model on `device` (the card unless the caller asks for
    the CPU), initialised from `generator` (default: seed 0 on `device`)."""
    with torch.device(device):
        model = SegModel(backbone, decoder, num_classes, image_size).to(device)
    init_parameters(model, generator or torch.Generator(device=device).manual_seed(0))
    return model
