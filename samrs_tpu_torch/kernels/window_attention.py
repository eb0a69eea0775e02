"""K12: attention with the decomposed rel-pos bias on split heads, the layout
of the reference SAM: ``q, k, v (B', N, d)`` with ``B' = images x windows x
heads``, fp32 rel rows ``rel_h (B', N, kh)`` / ``rel_w (B', N, kw)``, and
``softmax(q.k^T * scale + rel_h[:, :, k // kw] + rel_w[:, :, k % kw]) v``
in fp32.

Replaces samrs_tpu/kernels/window_attention.py::window_attention_relpos
(Pallas call ``_window_attention_pallas``, :83: the windowed layers of
``window_attn_impl="pallas"`` and the global layers of a grid under 2048
tokens) and, through ``flash_attention.flash_attention_relpos``,
flash_attention.py's ``_flash_attention_fwd_pallas`` (:105).  On a CUDA
tensor the wrapper launches the hand-written kernel of
csrc/split_attention.cu, whole windows (N <= 256) or 64-query tiles over
64-key tiles (any N); bound on the H100 by bytes at the windows and by
tensor-core flops at the 4096-token globals.  On a CPU tensor it runs the
plain version.  ``window_attention_xla`` is the torch composition of the
JAX oracle, which ``window_attn_impl="xla"`` selects for its windowed layers.
"""

from __future__ import annotations

from typing import Tuple

import torch

from samrs_tpu_torch.kernels import _build, flash_attention

launches = 0  # CUDA launches of K12 (one per wrapper call)

_HEAD_DIMS = (64, 80)  # instantiated in csrc/split_attention.cu
_WHOLE_MAX = 256  # the whole-window launch's largest N


def rel_rows(q: torch.Tensor, Rh: torch.Tensor, Rw: torch.Tensor, hw: Tuple[int, int]):
    """q (B', N, d) -> fp32 rel_h (B', N, kh), rel_w (B', N, kw): the
    per-query products with the gathered (kh, kh, d) / (kw, kw, d) tables."""
    kh, kw = hw
    B, N, d = q.shape
    rq = q.float().reshape(B, kh, kw, d)
    rel_h = torch.einsum("bhwc,hkc->bhwk", rq, Rh.float()).reshape(B, N, kh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", rq, Rw.float()).reshape(B, N, kw)
    return rel_h, rel_w


def _logits(q, k, rel_h, rel_w, scale: float) -> torch.Tensor:
    B, N, _ = q.shape
    kh, kw = rel_h.shape[-1], rel_w.shape[-1]
    s = (q.float() * scale) @ k.float().transpose(-1, -2)
    s = s.reshape(B, N, kh, kw) + rel_h.float()[..., :, None] + rel_w.float()[..., None, :]
    return s.reshape(B, N, N)


def window_attention_xla(q, k, v, rel_h, rel_w, scale: float) -> torch.Tensor:
    """The JAX oracle ``window_attention_xla`` as torch ops: fp32 logits and
    softmax, the probabilities in v's dtype for the product -> fp32."""
    p = _logits(q, k, rel_h, rel_w, scale).softmax(-1)
    return p.to(v.dtype).float() @ v.float()


def split_attention_plain(q, k, v, rel_h, rel_w, scale: float) -> torch.Tensor:
    """K12's plain version: fp32 logits, the probabilities rounded as the
    kernel's online softmax rounds them (``online_softmax_v``) -> fp32."""
    return flash_attention.online_softmax_v(_logits(q, k, rel_h, rel_w, scale), v, v.dtype)


def split_attention_cuda(q, k, v, rel_h, rel_w, scale: float) -> torch.Tensor:
    """The K12 kernel on bf16 CUDA ``q, k, v (B', N, d)`` and fp32 rel rows
    -> fp32 ``(B', N, d)``."""
    global launches
    _build.require_cuda("q", q, torch.bfloat16)
    if q.dim() != 3:
        raise ValueError(f"q: expected (B', N, d), got {tuple(q.shape)}")
    B, N, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require_cuda(name, t, torch.bfloat16, (B, N, d))
    kh, kw = rel_h.shape[-1], rel_w.shape[-1]
    _build.require_cuda("rel_h", rel_h, torch.float32, (B, N, kh))
    _build.require_cuda("rel_w", rel_w, torch.float32, (B, N, kw))
    if d not in _HEAD_DIMS:
        raise ValueError(f"K12 supports head_dim in {_HEAD_DIMS}, got {d}")
    if kh * kw != N:
        raise ValueError(f"rel-pos grid {kh}x{kw} != {N} tokens")
    out = torch.empty(B, N, d, device=q.device, dtype=torch.float32)
    _build.launch("samrs_split_attention", _build.ptr(q), _build.ptr(k), _build.ptr(v),
                  _build.ptr(rel_h), _build.ptr(rel_w), _build.ptr(out), B, N, d, kh, kw,
                  float(scale), int(N <= _WHOLE_MAX))
    launches += 1
    return out


def split_attention(q, k, v, rel_h, rel_w, scale: float) -> torch.Tensor:
    """K12: the kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if not q.is_cuda:
        return split_attention_plain(q, k, v, rel_h, rel_w, scale)
    return split_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                rel_h.contiguous(), rel_w.contiguous(), scale)


def window_attention_relpos(q, k, v, Rh, Rw, hw: Tuple[int, int], scale: float,
                            force_xla: bool = False) -> torch.Tensor:
    """JAX ``window_attention_relpos``: attention over (kh, kw) token grids,
    q, k, v (B', N, d) with N = kh * kw, the gathered tables Rh (kh, kh, d)
    / Rw (kw, kw, d) -> (B', N, d) fp32.  K12 (or its plain version on the
    CPU); with `force_xla` the torch composition of the JAX oracle."""
    rel_h, rel_w = rel_rows(q, Rh, Rw, hw)
    if force_xla:
        return window_attention_xla(q, k, v, rel_h, rel_w, scale)
    return split_attention(q, k, v, rel_h, rel_w, scale)


def window_attention_relpos_plain(q, k, v, Rh, Rw, hw: Tuple[int, int], scale: float,
                                  force_xla: bool = False) -> torch.Tensor:
    """``window_attention_relpos`` with K12's plain version on any device."""
    rel_h, rel_w = rel_rows(q, Rh, Rw, hw)
    attend = window_attention_xla if force_xla else split_attention_plain
    return attend(q, k, v, rel_h, rel_w, scale)
