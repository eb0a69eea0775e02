"""Shared decoder blocks (mirrors samrs_tpu/seg/decoders/blocks.py; reference
ED/modules.py: Conv2dReLU, SCSEModule).  NCHW.

``BatchNorm`` follows flax's ``nn.BatchNorm`` as the JAX package uses it,
not torch's default: momentum 0.9 on the running average (torch's 0.1 on the
new value), eps 1e-5, and the running variance updated with the BIASED batch
variance (``nn.BatchNorm2d`` would use the unbiased one).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from samrs_tpu_torch.core.mesh import active, all_reduce_sum
from samrs_tpu_torch.nn.layers import recomputing, resize_bilinear

__all__ = ["BatchNorm", "ConvBNReLU", "SCSEModule", "adaptive_avg_pool", "resize_bilinear",
           "upsample_nearest_2x"]


class BatchNorm(nn.Module):
    """Batch statistics in training, running statistics in eval; the running
    statistics are updated once a forward, not again when a checkpointed
    block runs a second time in the backward.  Inside a data-parallel step
    (``mesh.sharded``) the batch statistics are the global batch's."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.momentum = momentum
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        dp = active()
        if dp is not None:
            return self._forward_global(x, dp)
        if x.numel() == x.shape[1]:
            # one value per channel (a batch of 1 after the 1x1 pool), which
            # F.batch_norm refuses: zero variance, so the output is the bias
            xc = x - x.mean((0, 2, 3), keepdim=True)
            y = xc * torch.rsqrt(self.eps + xc * xc) * self.weight[:, None, None] \
                + self.bias[:, None, None]
        else:
            y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        if recomputing():
            return y
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), (0, 2, 3), unbiased=False)
            self.running_mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
            self.running_var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
        return y

    def _forward_global(self, x: torch.Tensor, dp) -> torch.Tensor:
        """Training over a data-parallel global batch (flax's BatchNorm on a
        sharded array): the moments are sums over every rank's rows, in two
        passes (the mean, then the centred squares) as F.batch_norm forms
        them, each summed with a gradient through the reduction.  A global
        batch of one value per channel gives zero variance and the bias, as
        the one-process branch does; one image on each rank is not that."""
        C = x.shape[1]
        dims = (0, 2, 3)
        count = x.new_tensor(float(x.numel() // C))
        sums = all_reduce_sum(torch.cat([x.sum(dims), count[None]]), dp)
        n = sums[C].detach()
        mean = sums[:C] / n
        xc = x - mean[:, None, None]
        var = all_reduce_sum((xc * xc).sum(dims), dp) / n
        y = xc * torch.rsqrt(var + self.eps)[:, None, None] * self.weight[:, None, None] \
            + self.bias[:, None, None]
        if not recomputing():
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
                self.running_var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
        return y


class ConvBNReLU(nn.Module):
    """kxk conv (no bias, 'same' padding) -> BatchNorm -> ReLU (ED/modules.py:10)."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3) -> None:
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, kernel, padding=kernel // 2, bias=False)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def adaptive_avg_pool(x: torch.Tensor, out_hw) -> torch.Tensor:
    """torch AdaptiveAvgPool2d bins (the JAX package's pooling matrices
    compute the same bins)."""
    return F.adaptive_avg_pool2d(x, tuple(out_hw))


class SCSEModule(nn.Module):
    """Spatial + channel squeeze-excitation (ED/modules.py:50): x * sigmoid of
    a bottleneck of the channel means (``cse_fc1`` / ``cse_fc2``) plus x *
    sigmoid of a 1x1 conv to one channel (``sse_conv``)."""

    def __init__(self, channels: int, reduction: int = 16) -> None:
        super().__init__()
        mid = max(channels // reduction, 1)
        self.cse_fc1 = nn.Conv2d(channels, mid, 1)
        self.cse_fc2 = nn.Conv2d(mid, channels, 1)
        self.sse_conv = nn.Conv2d(channels, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.cse_fc2(F.relu(self.cse_fc1(x.mean((2, 3), keepdim=True))))
        return x * torch.sigmoid(s) + x * torch.sigmoid(self.sse_conv(x))


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Each pixel of an NCHW map repeated 2 x 2."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
