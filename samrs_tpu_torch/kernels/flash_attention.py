"""K2: global attention of the encoder with the decomposed rel-pos bias,
heads read in place from the raw ``(B, N, 3C)`` qkv tensor; and K10, plain
softmax attention in fp32 for the seg ViTs' full-attention blocks (at the
end of this module).

Replaces samrs_tpu/kernels/flash_attention.py::flash_attention_qkv_relpos
(variant "m", Pallas call ``_qkv_flash_m_pallas``).  On a CUDA tensor the
wrapper computes the per-query rel-pos rows ``rel_h = q.Rh[x_q]^T`` and
``rel_w = q.Rw[y_q]^T`` in fp32 (outside the kernel, as the JAX package does
outside its pallas_call) and launches the hand-written flash kernel of
csrc/flash_attention.cu.  Bound on the H100: tensor-core flops plus the
softmax on the CUDA cores; the N x N logits never reach device memory.  On a
CPU tensor it runs the plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from samrs_tpu_torch.kernels import _build

launches = 0  # CUDA launches of this kernel (one per wrapper call)

_HEAD_DIMS = (64, 80)  # instantiated in csrc/flash_attention.cu
_TILE = 64  # query and key tile of the kernel; a key tile must lie in one grid row


def _rel_rows(q: torch.Tensor, Rh: torch.Tensor, Rw: torch.Tensor, hw: Tuple[int, int]):
    """q (B, nH, N, hd) -> fp32 rel_h (B, nH, N, H), rel_w (B, nH, N, W)."""
    H, W = hw
    B, nH, N, hd = q.shape
    rq = q.float().reshape(B, nH, H, W, hd)
    rel_h = torch.einsum("bnxyd,xkd->bnxyk", rq, Rh.float()).reshape(B, nH, N, H)
    rel_w = torch.einsum("bnxyd,ykd->bnxyk", rq, Rw.float()).reshape(B, nH, N, W)
    return rel_h, rel_w


def online_softmax_v(s: torch.Tensor, v: torch.Tensor, dtype: torch.dtype,
                     tile: int = _TILE) -> torch.Tensor:
    """``softmax(s) @ v`` in fp32, rounded as the kernels' online softmax
    rounds it (csrc/warp_attention.cuh): keys in tiles of `tile`, each
    tile's probabilities exp(s - running max) rounded to `dtype` (the P of
    the P.V product), row sum of the rounded values, rescaled to the final
    max.  For fp32 this is the exact softmax.  s (..., n), v (..., n, d)."""
    n = s.shape[-1]
    st = F.pad(s, (0, (-n) % tile), value=float("-inf")).unflatten(-1, (-1, tile))
    m = st.amax(-1).cummax(-1).values                     # running max after each tile
    p = torch.exp(st - m[..., None]).to(dtype).float()
    rescale = torch.exp(m - m[..., -1:])
    denom = (p.sum(-1) * rescale).sum(-1, keepdim=True)
    p = (p * rescale[..., None]).flatten(-2)[..., :n]
    return (p @ v.float()) / denom


def attention_qkv_relpos_plain(qkv, Rh, Rw, hw: Tuple[int, int], scale: float, num_heads: int):
    """Plain PyTorch version, following the JAX oracle
    ``attention_qkv_relpos_xla``: fp32 logits and softmax, output in qkv's
    dtype; the probabilities are rounded as the kernel rounds them
    (``online_softmax_v``).  qkv (B, N, 3C) -> (B, N, C)."""
    H, W = hw
    B, N, C3 = qkv.shape
    C = C3 // 3
    hd = C // num_heads
    q, k, v = qkv.reshape(B, N, 3, num_heads, hd).permute(2, 0, 3, 1, 4).unbind(0)
    rel_h, rel_w = _rel_rows(q, Rh, Rw, hw)
    s = (q.float() * scale) @ k.float().transpose(-1, -2)     # (B, nH, N, N)
    s = s.reshape(B, num_heads, N, H, W) + rel_h[..., :, None] + rel_w[..., None, :]
    out = online_softmax_v(s.reshape(B, num_heads, N, N), v, qkv.dtype)
    return out.permute(0, 2, 1, 3).reshape(B, N, C).to(qkv.dtype)


def attention_qkv_relpos_cuda(qkv, Rh, Rw, hw: Tuple[int, int], scale: float, num_heads: int):
    """The hand-written flash kernel on a bf16 CUDA ``qkv (B, N, 3C)``."""
    global launches
    _build.require_cuda("qkv", qkv, torch.bfloat16)
    if qkv.dim() != 3:
        raise ValueError(f"qkv: expected (B, N, 3C), got {tuple(qkv.shape)}")
    H, W = hw
    B, N, C3 = qkv.shape
    C = C3 // 3
    hd = C // num_heads
    if 3 * C != C3 or hd * num_heads != C or hd not in _HEAD_DIMS:
        raise ValueError(f"flash kernel supports head_dim in {_HEAD_DIMS}, got 3C={C3}, heads={num_heads}")
    if N != H * W or W % _TILE:
        raise ValueError(f"flash kernel needs N = H*W with W % {_TILE} == 0, got N={N}, hw={hw}")
    if tuple(Rh.shape) != (H, H, hd) or tuple(Rw.shape) != (W, W, hd):
        raise ValueError(f"Rh/Rw: expected ({H}, {H}, {hd}) / ({W}, {W}, {hd})")
    q = qkv[..., :C].reshape(B, N, num_heads, hd).transpose(1, 2)
    rel_h, rel_w = _rel_rows(q, Rh, Rw, hw)
    rel_h, rel_w = rel_h.contiguous(), rel_w.contiguous()
    out = torch.empty(B, N, C, device=qkv.device, dtype=torch.bfloat16)
    _build.launch("samrs_flash_attention_relpos", _build.ptr(qkv), _build.ptr(rel_h),
                  _build.ptr(rel_w), _build.ptr(out), B, N, C, num_heads, hd, H, W, float(scale))
    launches += 1
    return out


def attention_qkv_relpos(qkv, Rh, Rw, hw: Tuple[int, int], scale: float, num_heads: int):
    """K2 on ``qkv (B, N, 3C)`` -> ``(B, N, C)``: the kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if not qkv.is_cuda:
        return attention_qkv_relpos_plain(qkv, Rh, Rw, hw, scale, num_heads)
    return attention_qkv_relpos_cuda(qkv, Rh, Rw, hw, scale, num_heads)


# ---------------------------------------------------------------------------
# K10: plain softmax attention, fp32 (the seg ViTs' full-attention blocks).
#
# Replaces samrs_tpu/kernels/flash_attention.py::flash_attention_plain
# (Pallas call ``_plain_fwd_pallas``, :618).  On a CUDA tensor the forward
# launches the hand-written online-softmax kernel of csrc/plain_attention.cu
# (fp32 on the CUDA cores, bound by fp32 operations: 4 N^2 d per head); the
# backward recomputes with ``full_attention_plain`` under autograd, as the JAX
# package's ``_plain_bwd`` recomputes with its XLA oracle, and launches no
# kernel.  On a CPU tensor it runs the plain version.
# ---------------------------------------------------------------------------

full_launches = 0  # CUDA launches of K10 (one per forward)

_FULL_HEAD_DIMS = (64, 80)  # instantiated in csrc/plain_attention.cu


def full_attention_plain(q, k, v, scale: float):
    """Plain PyTorch version, JAX's ``attention_plain_xla``:
    ``softmax((q * scale) @ k^T) @ v`` in fp32.  q, k, v (BH, N, d) -> (BH, N, d)."""
    s = (q.float() * scale) @ k.float().transpose(-1, -2)
    return s.softmax(-1) @ v.float()


def full_attention_cuda(q, k, v, scale: float):
    """The K10 kernel on contiguous fp32 CUDA ``q, k, v (BH, N, d)``."""
    global full_launches
    if q.dim() != 3:
        raise ValueError(f"q: expected (BH, N, d), got {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require_cuda(name, t, torch.float32, q.shape)
    BH, N, d = q.shape
    if d not in _FULL_HEAD_DIMS:
        raise ValueError(f"K10 supports head_dim in {_FULL_HEAD_DIMS}, got {d}")
    out = torch.empty_like(q)
    _build.launch("samrs_plain_attention", _build.ptr(q), _build.ptr(k), _build.ptr(v),
                  _build.ptr(out), BH, N, d, float(scale))
    full_launches += 1
    return out


class _FullAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return full_attention_cuda(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = full_attention_plain(*leaves, ctx.scale)
        return (*torch.autograd.grad(out, leaves, g), None)


def full_attention(q, k, v, scale: float):
    """K10 (JAX ``flash_attention_plain``): q, k, v (BH, N, d) -> (BH, N, d)
    fp32.  The kernel for a CUDA tensor (backward: the plain version's VJP,
    recomputed), the plain version for a CPU tensor."""
    if not q.is_cuda:
        return full_attention_plain(q, k, v, scale)
    return _FullAttention.apply(q.float().contiguous(), k.float().contiguous(),
                                v.float().contiguous(), float(scale))
