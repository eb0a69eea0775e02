"""Shared layers of the port (mirrors samrs_tpu/nn/layers.py).

Attribute names follow the official SAM modules (``lin1``/``lin2``,
``layers.{i}``, LayerNorm2d ``weight``/``bias``) so official state dicts load
strictly.  ``ConvTranspose2x`` and the patch-flatten matmul of the JAX
package are TPU lowering workarounds and have no counterpart here: the model
uses ``nn.ConvTranspose2d`` and ``nn.Conv2d``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


class LayerNorm2d(nn.Module):
    """LayerNorm over the channel axis of an NCHW tensor (common.py:31-43),
    statistics in fp32, output in the input's dtype."""

    def __init__(self, num_channels: int, eps: float = 1e-6) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        u = xf.mean(1, keepdim=True)
        s = (xf - u).pow(2).mean(1, keepdim=True)
        xf = (xf - u) * torch.rsqrt(s + self.eps)
        return (self.weight[:, None, None] * xf + self.bias[:, None, None]).to(x.dtype)


class MLPBlock(nn.Module):
    """lin1 -> act -> lin2 (common.py:13-28)."""

    def __init__(self, embedding_dim: int, mlp_dim: int, act: type = nn.GELU) -> None:
        super().__init__()
        self.lin1 = nn.Linear(embedding_dim, mlp_dim)
        self.lin2 = nn.Linear(mlp_dim, embedding_dim)
        self.act = act()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(self.act(self.lin1(x)))


class MLP(nn.Module):
    """num_layers Linear stack with ReLU between (mask_decoder.py:179-201)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int,
                 sigmoid_output: bool = False) -> None:
        super().__init__()
        dims_in = [input_dim] + [hidden_dim] * (num_layers - 1)
        dims_out = [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(i, o) for i, o in zip(dims_in, dims_out))
        self.sigmoid_output = sigmoid_output

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return torch.sigmoid(x) if self.sigmoid_output else x


def window_partition(x: torch.Tensor, window_size: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """NHWC -> (B * nW, ws, ws, C) windows, zero-padding H and W up to a
    multiple of ws (image_encoder.py:243-265).  Returns (windows, (Hp, Wp))."""
    B, H, W, C = x.shape
    pad_h, pad_w = (-H) % window_size, (-W) % window_size
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // window_size, window_size, Wp // window_size, window_size, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window_size, window_size, C), (Hp, Wp)


def window_unpartition(windows: torch.Tensor, window_size: int, pad_hw: Tuple[int, int],
                       hw: Tuple[int, int]) -> torch.Tensor:
    """Inverse of :func:`window_partition`, cropping the padding off
    (image_encoder.py:267-289)."""
    Hp, Wp = pad_hw
    H, W = hw
    B = windows.shape[0] // (Hp // window_size * Wp // window_size)
    x = windows.reshape(B, Hp // window_size, Wp // window_size, window_size, window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W, :]
