"""SAM builders and registry (mirrors samrs_tpu/sam/build.py).

``build_sam`` constructs the model on `device` and either initialises it
from an explicit ``torch.Generator`` or loads an official-layout state dict
(``sam_vit_*.pth``) strictly.
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import torch
from torch import nn

from samrs_tpu_torch.core.config import sam_config
from samrs_tpu_torch.core.mesh import DataMesh
from samrs_tpu_torch.nn.layers import LayerNorm2d
from samrs_tpu_torch.sam.sam import Sam


def _randn(p: torch.Tensor, generator: torch.Generator, std: float) -> None:
    p.copy_(torch.randn(p.shape, generator=generator, device=generator.device).to(p.device) * std)


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded init in the JAX package's style: dense and conv weights
    lecun-normal, biases zero, LayerNorm ones/zeros, embeddings and the
    Fourier matrix standard normal; the zero-initialised rel-pos tables and
    pos_embed stay zero (as in the official model)."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            # (out, in[, kh, kw]); ConvTranspose2d stores (in, out, kh, kw)
            fan_in = w[:, 0].numel() if isinstance(m, nn.ConvTranspose2d) else w[0].numel()
            _randn(w, generator, fan_in ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, LayerNorm2d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            _randn(m.weight, generator, 1.0)
    _randn(model.prompt_encoder.pe_layer.positional_encoding_gaussian_matrix, generator, 1.0)
    for name, p in model.named_parameters():
        if name.endswith(("rel_pos_h", "rel_pos_w", "pos_embed")):
            p.zero_()


def build_sam(variant: str = "vit_h", checkpoint: Optional[str] = None,
              device: Any = "cuda", generator: Optional[torch.Generator] = None,
              use_kernels: bool = True, sp_mesh: Optional[DataMesh] = None,
              **overrides: Any) -> Sam:
    """Build SAM `variant` (config fields overridable) on `device`, in eval
    mode.  With `checkpoint` (an official-layout state dict file) the weights
    load strictly; otherwise they are drawn from `generator` (default: seed 0
    on `device`).  The model runs on the card unless `device` says
    otherwise.  `use_kernels` sets ``Sam.use_kernels``: the hand-written
    kernels (True) or their plain PyTorch versions (False).  ``sp_mesh`` (a
    ``DataMesh``: ``core.mesh.init_data_mesh`` under torchrun) splits the
    encoder's global blocks among its ranks; every rank builds the same
    weights and passes the same image."""
    cfg = sam_config(variant, **overrides)
    with torch.device(device):
        model = Sam(cfg, use_kernels=use_kernels, sp_mesh=sp_mesh)
    if checkpoint is not None:
        sd = torch.load(checkpoint, map_location=device, weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        model.load_state_dict(sd, strict=True)
    else:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        init_parameters(model, generator)
    return model.eval()


sam_model_registry = {
    "default": functools.partial(build_sam, "vit_h"),
    "vit_h": functools.partial(build_sam, "vit_h"),
    "vit_l": functools.partial(build_sam, "vit_l"),
    "vit_b": functools.partial(build_sam, "vit_b"),
}
