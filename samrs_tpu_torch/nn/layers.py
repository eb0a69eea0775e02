"""Shared layers of the port (mirrors samrs_tpu/nn/layers.py).

Attribute names follow the official SAM modules (``lin1``/``lin2``,
``layers.{i}``, LayerNorm2d ``weight``/``bias``) so official state dicts load
strictly.  ``ConvTranspose2x`` and the patch-flatten matmul of the JAX
package are TPU lowering workarounds and have no counterpart here: the models
use ``nn.ConvTranspose2d(k=2, s=2)`` (torch's layout needs no flip; the JAX
flip is flax's) and ``nn.Conv2d``.  Dropout and drop-path take an explicit
``torch.Generator``.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from samrs_tpu_torch.core.mesh import active


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


def _keep_mask(shape, keep: float, x: torch.Tensor, generator) -> torch.Tensor:
    """Bernoulli(keep) bool mask of `shape` drawn from `generator` on x's
    device.  In a data-parallel step (``mesh.active()``) x holds this rank's
    rows of the global batch, the ranks' batches in rank order (JAX's global
    array): the mask of the global shape is drawn and the rank's rows kept,
    so every rank uses the generator as one process on the global batch does."""
    dp = active()
    if dp is None:
        return torch.empty(shape, dtype=torch.bool, device=x.device).bernoulli_(
            keep, generator=generator)
    n = shape[0]
    full = torch.empty((n * dp.world,) + tuple(shape[1:]), dtype=torch.bool, device=x.device)
    return full.bernoulli_(keep, generator=generator)[dp.rank * n:(dp.rank + 1) * n]


class DropPath(nn.Module):
    """Stochastic depth per sample (samrs_tpu/nn/layers.py:207-222): in
    training, each sample's branch is kept with probability 1 - rate and
    scaled by 1 / (1 - rate).  The mask comes from the explicit generator
    passed to ``forward``."""

    def __init__(self, rate: float = 0.0) -> None:
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = _keep_mask((x.shape[0],) + (1,) * (x.dim() - 1), keep, x, generator)
        return x * mask / keep


class Dropout(nn.Module):
    """Element-wise dropout (flax ``nn.Dropout``) drawing its mask from the
    explicit generator passed to ``forward``."""

    def __init__(self, rate: float = 0.0) -> None:
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        return x * _keep_mask(x.shape, keep, x, generator) / keep


def jax_resize_weights(n_in: int, n_out: int, kernel) -> np.ndarray:
    """(n_in, n_out) fp32 weights of ``jax.image.resize`` along one axis with
    the interpolation `kernel` (a numpy function of the distance): half-pixel
    centres, the kernel widened by the scale on a downscale (antialiasing, on
    by default in ``jax.image.resize``), each column normalised to sum 1,
    and columns whose sample lies outside the input zero.  A copy of jax's
    ``compute_weight_mat``."""
    inv = np.float32(1.0) / np.float32(n_out / n_in)
    kernel_scale = max(inv, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = kernel(x)
    total = w.sum(0, keepdims=True)
    ok = np.abs(total) > 1000.0 * np.finfo(np.float32).eps
    w = np.where(ok, w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic kernel with a = -0.5 (jax.image's "bicubic")."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


def jax_bicubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) fp32 weights of ``jax.image.resize(..., "bicubic")`` along
    one axis (``jax_resize_weights`` with Keys' cubic: half-pixel centres,
    antialiased on a downscale); torch's bicubic (a = -0.75, no antialias)
    differs."""
    return jax_resize_weights(n_in, n_out, _keys_cubic)


def resize_bicubic_jax(x: torch.Tensor, out_hw: Tuple[int, int],
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.image.resize(x, (B, h, w, C), "bicubic")`` of an NHWC tensor,
    computed and returned in `dtype` (fp32 weights either way)."""
    H, W = x.shape[1:3]
    wh = torch.from_numpy(jax_bicubic_weights(H, out_hw[0])).to(x.device, dtype)
    ww = torch.from_numpy(jax_bicubic_weights(W, out_hw[1])).to(x.device, dtype)
    return torch.einsum("bhwc,hy,wx->byxc", x.to(dtype), wh, ww)


_MAX_INTERP = 2**31 - 1  # output elements of one F.interpolate call


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of the last two axes of an NCHW tensor, torch
    ``align_corners=False`` without antialiasing (samrs_tpu/nn/interpolate.py:
    90-127): half-pixel source index clamped at 0, upper neighbour clamped at
    the edge, as ``_axis_matrix`` builds it.  fp32 math, output in x's dtype."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    xf = x.float()
    per_image = xf[0].numel() // (xf.shape[-2] * xf.shape[-1]) * out_hw[0] * out_hw[1]
    if x.dim() != 4 or x.shape[0] * per_image <= _MAX_INTERP:
        return F.interpolate(xf, size=tuple(out_hw), mode="bilinear",
                             align_corners=False).to(x.dtype)
    # CUDA's bilinear backward refuses to launch past 2^31 output elements (the FAST
    # head's x4 upsample at 65 x 768 x 224^2 is 2.5e9): resample in batch slices into
    # one output; each image is resampled alone either way, so the values are the same
    out = xf.new_empty(x.shape[0], x.shape[1], *out_hw)
    step = max(1, _MAX_INTERP // per_image)
    for i in range(0, x.shape[0], step):
        out[i:i + step] = F.interpolate(xf[i:i + step], size=tuple(out_hw), mode="bilinear",
                                        align_corners=False)
    return out.to(x.dtype)


_recomputes = 0  # checkpointed functions being run again in the backward


@contextlib.contextmanager
def _recomputing():
    global _recomputes
    _recomputes += 1
    try:
        yield
    finally:
        _recomputes -= 1


def recomputing() -> bool:
    """True while ``checkpoint_with_generator`` runs a function again in the
    backward: a BatchNorm there must not update its running statistics a
    second time."""
    return _recomputes > 0


def checkpoint_with_generator(fn, x: torch.Tensor, generator: Optional[torch.Generator]):
    """``fn(x, generator)`` under activation checkpointing: only `x` is kept
    for the backward, which runs `fn` again.  Its random draws (dropout,
    drop-path) come from a copy of `generator`'s state at the call, so the
    recompute draws the same masks; `generator` ends as `fn` left it.  During
    the recompute ``recomputing()`` is true."""
    state = None if generator is None else generator.get_state()
    used = []

    def run(x):
        g = None
        if state is not None:
            g = torch.Generator(device=generator.device)
            g.set_state(state)
            used.append(g)
        return fn(x, g)

    out = checkpoint(run, x, use_reentrant=False,
                     context_fn=lambda: (contextlib.nullcontext(), _recomputing()))
    if used:
        generator.set_state(used[0].get_state())
    return out


def run_block(blk: nn.Module, x: torch.Tensor, generator: Optional[torch.Generator],
              use_kernels: bool, checkpointed: bool) -> torch.Tensor:
    """``blk(x, generator, use_kernels)``, under ``checkpoint_with_generator``
    when `checkpointed` (a backbone's per-block activation checkpointing, the
    reference's use_checkpoint)."""
    if not checkpointed:
        return blk(x, generator, use_kernels)
    return checkpoint_with_generator(lambda t, g: blk(t, g, use_kernels), x, generator)
