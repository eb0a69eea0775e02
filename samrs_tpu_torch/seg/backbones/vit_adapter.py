"""Multi-scale deformable attention (mirrors the MSDeformAttn part of
samrs_tpu/seg/backbones/vit_adapter.py:47-137; reference
ED/backbone/ops/modules/ms_deform_attn.py:28).

Value projection, per-query sampling offsets and attention weights (softmax
over levels x points), and the weighted bilinear sampling of every level
through K8 (``kernels.bilinear_gather.ms_deform_attn``) under
``use_kernels``.  Mask2Former's pixel decoder uses it; the ViT-Adapter
backbone that also does waits in ROADMAP.md.  The JAX module's remat policy
and its ``SAMRS_MSDA_IMPL`` switch have no counterpart: the kernel keeps
only its inputs for the backward and has one form.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from samrs_tpu_torch.kernels import bilinear_gather


def _grid_init(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """Rotated-unit-grid bias of the sampling offsets (ms_deform_attn.py
    ``_reset_parameters``), flattened (nH * L * P * 2,) fp32."""
    thetas = np.arange(n_heads) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)  # (nH, 2)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1).astype(np.float32)


def _ref_points(spatial_shapes: Sequence[Tuple[int, int]], device=None) -> torch.Tensor:
    """Normalised centre points (x, y) of every location of every level ->
    (1, S, 2) fp32."""
    pts = []
    for h, w in spatial_shapes:
        ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        pts.append(torch.stack([gx, gy], -1).reshape(-1, 2))
    return torch.cat(pts, 0)[None]


class MSDeformAttnModule(nn.Module):
    def __init__(self, d_model: int = 768, n_levels: int = 3, n_heads: int = 8,
                 n_points: int = 4, ratio: float = 1.0) -> None:
        super().__init__()
        self.n_heads, self.n_levels, self.n_points = n_heads, n_levels, n_points
        vdim = int(d_model * ratio)
        self.value_proj = nn.Linear(d_model, vdim)
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.output_proj = nn.Linear(vdim, d_model)

    @torch.no_grad()
    def reset_sampling(self) -> None:
        """The JAX module's initialisers of the sampling nets: zero kernels,
        the rotated grid as the offsets' bias, zero attention-weight bias."""
        self.sampling_offsets.weight.zero_()
        self.sampling_offsets.bias.copy_(torch.from_numpy(
            _grid_init(self.n_heads, self.n_levels, self.n_points)))
        self.attention_weights.weight.zero_()
        self.attention_weights.bias.zero_()

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor, value: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int]], use_kernels: bool = True):
        """query (B, Q, C); reference_points (B, Q, L, 2) in [0, 1]; value
        (B, S, C) -> (B, Q, C)."""
        B, Q, _ = query.shape
        S = value.shape[1]
        nH, L, P = self.n_heads, self.n_levels, self.n_points
        v = self.value_proj(value).reshape(B, S, nH, -1)
        offsets = self.sampling_offsets(query.float()).reshape(B, Q, nH, L, P, 2)
        weights = self.attention_weights(query.float()).reshape(B, Q, nH, L * P)
        weights = weights.softmax(-1).reshape(B, Q, nH, L, P)
        wh = torch.tensor([[w, h] for h, w in spatial_shapes], dtype=torch.float32,
                          device=query.device)
        locations = reference_points[:, :, None, :, None, :] + offsets / wh[:, None, :]
        out = bilinear_gather.ms_deform_attn(v.float(), spatial_shapes, locations, weights,
                                             plain=not use_kernels)
        return self.output_proj(out.to(query.dtype))
