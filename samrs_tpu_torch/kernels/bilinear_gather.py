"""K8: weighted bilinear gather over absolute pixel coordinates, forward and
backward (the sampling core of RVSA's K/V windows, and later of DCNv3 and
MSDeformAttn).

    out[bg, p, :] = sum_k mask[bg, p, k] * bilinear(xg[bg], fy[bg, p, k], fx[bg, p, k])

with zero padding outside the map.  Replaces
samrs_tpu/kernels/bilinear_gather.py::_make_sampler: its forward
``pallas_call`` (``fwd_call``, :386) and its backward (``bwd_call``, :467),
which returns dX, dfx, dfy and dmask.

On a CUDA tensor ``sample_weighted`` is a ``torch.autograd.Function`` whose
forward and backward launch the hand-written kernels of
csrc/bilinear_gather.cu (the direct four-corner gather; dX by fp32 atomics,
so its summation order varies from run to run at fp32 rounding).  Both are
bound by device-memory bytes.  On a CPU tensor it runs
``sample_weighted_plain``, the floor-based gather whose autograd gives the
same one-sided coordinate derivative as the TPU kernel's ``_dhat``: at an
integer coordinate the tap at t in [0, 1) has slope -1, the tap at
t in [-1, 0) slope +1, and the tap at t = 1 none.
"""

from __future__ import annotations

import torch

from samrs_tpu_torch.kernels import _build

fwd_launches = 0  # CUDA launches of the forward kernel
bwd_launches = 0  # CUDA launches of the backward kernel

_DTYPES = (torch.float32, torch.bfloat16)


def _corner_weights(fx, fy, H: int, W: int):
    """Per tap: the flat pixel index (clamped into the map) and the bilinear
    weight (0 off the map) of each of the four corners."""
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    wx, wy = fx - x0, fy - y0
    # clamp before the integer cast; a clamped corner is off the map either way
    x0i = x0.clamp(-2, W).long()
    y0i = y0.clamp(-2, H).long()
    out = []
    for dy, wyc in ((0, 1 - wy), (1, wy)):
        for dx, wxc in ((0, 1 - wx), (1, wx)):
            xi, yi = x0i + dx, y0i + dy
            valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
            out.append((idx, wxc * wyc * valid))
    return out


def sample_weighted_plain(xg, fx, fy, mask, group_channels: int):
    """Plain PyTorch version: the four-corner gather of JAX's
    ``_gather_chunk`` in fp32, differentiable by autograd (``floor`` has a
    zero derivative, so d/dfx is the one-sided slope).  xg (BG, H, W*Gc) fp32
    or bf16; fx, fy, mask (BG, P, K) fp32 -> (BG, P, Gc) fp32."""
    BG, H, WGc = xg.shape
    Gc = group_channels
    W = WGc // Gc
    _, P, K = fx.shape
    img = xg.float().reshape(BG * H * W, Gc)
    base = (torch.arange(BG, device=xg.device) * (H * W))[:, None, None]
    samp = 0.0
    for idx, w in _corner_weights(fx, fy, H, W):
        vals = img[(base + idx).reshape(-1)].reshape(BG, P, K, Gc)
        samp = samp + vals * w[..., None]
    return (samp * mask[..., None]).sum(2)


def _check(xg, fx, fy, mask, Gc: int):
    if xg.dim() != 3 or xg.shape[2] % Gc:
        raise ValueError(f"xg: expected (BG, H, W*{Gc}), got {tuple(xg.shape)}")
    BG = xg.shape[0]
    if fx.dim() != 3 or fx.shape[0] != BG:
        raise ValueError(f"fx: expected (BG={BG}, P, K), got {tuple(fx.shape)}")
    if xg.dtype not in _DTYPES:
        raise ValueError(f"xg: the kernel takes {_DTYPES}, got {xg.dtype}")
    for name, t in (("xg", xg), ("fx", fx), ("fy", fy), ("mask", mask)):
        _build.require_cuda(name, t, xg.dtype if name == "xg" else torch.float32,
                            xg.shape if name == "xg" else fx.shape)


def sample_weighted_fwd_cuda(xg, fx, fy, mask, Gc: int):
    """The forward kernel: (BG, P, Gc) fp32."""
    global fwd_launches
    _check(xg, fx, fy, mask, Gc)
    BG, H, WGc = xg.shape
    _, P, K = fx.shape
    out = torch.empty(BG, P, Gc, device=xg.device, dtype=torch.float32)
    p = _build.ptr
    _build.launch("samrs_bilinear_fwd", p(xg), p(fx), p(fy), p(mask), p(out),
                  BG, H, WGc // Gc, P, K, Gc, int(xg.dtype == torch.bfloat16))
    fwd_launches += 1
    return out


def sample_weighted_bwd_cuda(xg, fx, fy, mask, dout, Gc: int):
    """The backward kernel: (dxg in xg's dtype, dfx, dfy, dmask fp32)."""
    global bwd_launches
    _check(xg, fx, fy, mask, Gc)
    BG, H, WGc = xg.shape
    _, P, K = fx.shape
    _build.require_cuda("dout", dout, torch.float32, (BG, P, Gc))
    dxg = torch.zeros(BG, H, WGc, device=xg.device, dtype=torch.float32)
    dfx, dfy, dmask = (torch.empty_like(fx) for _ in range(3))
    p = _build.ptr
    _build.launch("samrs_bilinear_bwd", p(xg), p(fx), p(fy), p(mask), p(dout), p(dxg), p(dfx),
                  p(dfy), p(dmask), BG, H, WGc // Gc, P, K, Gc, int(xg.dtype == torch.bfloat16))
    bwd_launches += 1
    return dxg.to(xg.dtype), dfx, dfy, dmask


class _SampleWeighted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xg, fx, fy, mask, Gc):
        ctx.save_for_backward(xg, fx, fy, mask)
        ctx.Gc = Gc
        return sample_weighted_fwd_cuda(xg, fx, fy, mask, Gc)

    @staticmethod
    def backward(ctx, dout):
        xg, fx, fy, mask = ctx.saved_tensors
        dxg, dfx, dfy, dmask = sample_weighted_bwd_cuda(xg, fx, fy, mask,
                                                        dout.float().contiguous(), ctx.Gc)
        return dxg, dfx, dfy, dmask, None


def sample_weighted(xg, fx, fy, mask, group_channels: int):
    """K8 (JAX ``sample_weighted``): xg (BG, H, W*Gc) fp32 or bf16; fx, fy,
    mask (BG, P, K) fp32 absolute pixel coordinates and tap weights ->
    (BG, P, Gc) fp32.  The kernels for a CUDA tensor, the plain version for
    a CPU tensor."""
    if not xg.is_cuda:
        return sample_weighted_plain(xg, fx, fy, mask, group_channels)
    return _SampleWeighted.apply(xg.contiguous(), fx.float().contiguous(),
                                 fy.float().contiguous(), mask.float().contiguous(),
                                 int(group_channels))


def grid_sample(img, grid, align_corners: bool = False, plain: bool = False):
    """torch-compatible bilinear grid sample with zero padding, NHWC (JAX
    ``grid_sample_pallas``): img (B, H, W, C), grid (B, Ho, Wo, 2) normalized
    to [-1, 1] -> (B, Ho, Wo, C) fp32.  One tap with a ones mask through
    ``sample_weighted``; ``plain=True`` runs the plain version on any device
    (the comparison path on the card)."""
    B, H, W, C = img.shape
    _, Ho, Wo, _ = grid.shape
    P = Ho * Wo
    gx = grid[..., 0].reshape(B, P, 1).float()
    gy = grid[..., 1].reshape(B, P, 1).float()
    if align_corners:
        fx = (gx + 1.0) * 0.5 * (W - 1)
        fy = (gy + 1.0) * 0.5 * (H - 1)
    else:
        fx = ((gx + 1.0) * W - 1.0) * 0.5
        fy = ((gy + 1.0) * H - 1.0) * 0.5
    xg = img.reshape(B, H, W * C)
    ones = torch.ones(B, P, 1, device=img.device, dtype=torch.float32)
    sampler = sample_weighted_plain if plain else sample_weighted
    return sampler(xg, fx, fy, ones, C).reshape(B, Ho, Wo, C)
