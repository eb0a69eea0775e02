"""Segmentation frameworks (mirrors samrs_tpu/seg/frameworks.py; reference
ED/models.py:52-318).

``MultiHeadSegModel``: one shared encoder and decoder, one classification
head per pretraining dataset (SOTA 18 / SIOR 20 / FAST 37 classes); the
encoder and decoder run once per dataset batch.  Images go in NHWC and the
logits come out NHWC, as in the JAX package.  ``use_kernels`` (default True)
is the one switch between K8 and its plain version on the card; only the
smoke's comparison and the tests turn it off.  Dropout and drop-path draw
from the generator passed to ``forward``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from samrs_tpu_torch.nn.layers import Dropout, checkpoint_with_generator
from samrs_tpu_torch.seg.registry import get_backbone, get_decoder


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
        if decoder != "upernet":
            raise KeyError(f"decoder {decoder!r} is not ported yet (ROADMAP.md)")
        self.backbone, self.decoder = backbone, decoder
        self.num_classes = tuple(num_classes)
        self.image_size = image_size
        self.use_kernels = use_kernels
        # remat = per-block activation checkpointing (use_checkpoint)
        self.encoder = get_backbone(backbone, image_size=image_size, use_checkpoint=remat)
        self.seg_decoder = get_decoder(decoder, self.encoder.out_channels)
        ch = self.seg_decoder.out_features
        self.heads = nn.ModuleList(SegHead(ch, nc, kernel=1, dropout=0.1)
                                   for nc in self.num_classes)

    def forward_one(self, x: torch.Tensor, head_idx: int,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, H, W, 3) normalized images -> (B, H, W, classes) logits.

        In training the decoder's 4x upsample, the head's dropout and its
        conv are recomputed in the backward instead of kept: their maps have
        the decoder's width at the input's size (154 MB an image at 768 x
        224^2 in fp32), and a 94-image step does not fit 80 GB with them."""
        feats = self.encoder(x, generator, self.use_kernels)
        d = self.seg_decoder(feats, upsample=False)
        head = lambda t, g: self.heads[head_idx](self.seg_decoder.upsample(t), g)
        if self.training and torch.is_grad_enabled():
            out = checkpoint_with_generator(head, d, generator)
        else:
            out = head(d, generator)
        return out.permute(0, 2, 3, 1)

    def forward(self, xs: Sequence[Optional[torch.Tensor]],
                generator: Optional[torch.Generator] = None) -> List[Optional[torch.Tensor]]:
        """One batch per dataset (None skips that head) -> per-dataset logits."""
        return [None if x is None else self.forward_one(x, i, generator)
                for i, x in enumerate(xs)]


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    w.copy_(torch.randn(w.shape, generator=generator, device=generator.device).to(w.device)
            * fan_in ** -0.5)


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded init in the JAX package's style: dense and conv weights
    lecun-normal, biases zero, norms ones/zeros (torch's default), the Swin bias tables
    normal(0.02); RVSA's sampling nets, the rel-pos tables and pos_embed
    stay zero, as the JAX modules initialise them (so the sampling grid starts
    as the identity)."""
    for name, m in model.named_modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = m.weight[:, 0].numel() if isinstance(m, nn.ConvTranspose2d) \
                else m.weight[0].numel()
            _lecun_normal_(m.weight, fan_in, generator)
            if m.bias is not None:
                m.bias.zero_()
    for name, p in model.named_parameters():
        if ".sampling_" in name or name.endswith(("rel_pos_h", "rel_pos_w", "pos_embed")):
            p.zero_()
        elif name.endswith("relative_position_bias_table"):
            p.copy_(torch.randn(p.shape, generator=generator, device=generator.device)
                    .to(p.device) * 0.02)


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
