"""Attention from the raw qkv rows with the heads as column slices
(``window_attn_impl="fused"``): ``qkv (B, N, 3C)`` over an (H, W) grid ->
``(B, N, C)``, for partitioned windows (B = images x windows, N = ws * ws)
and for global grids of at most 1024 tokens.

Replaces samrs_tpu/kernels/fused_attention.py::attention_qkv_fused (Pallas
call ``_fused_pallas``, :114).  On a CUDA tensor a 14 x 14 window takes K1's
attention kernel in its partitioned-window layout (csrc/window_attention.cu:
one window per image, no map pad, batch-innermost order), and a global grid
takes K2 (csrc/flash_attention.cu), which computes this function from the
raw qkv rows; both add fp32 rel rows.  On a CPU tensor it runs the plain
version.
"""

from __future__ import annotations

from typing import Tuple

from samrs_tpu_torch.kernels import flash_attention, fused_window_layer

launches = 0  # CUDA launches of the partitioned-window mode (one per wrapper call)


def attention_qkv_fused_plain(qkv_raw, Rh, Rw, hw: Tuple[int, int], scale: float,
                              num_heads: int):
    """Plain version (JAX oracle ``attention_qkv_xla``): ``qkv (B, N, 3C)``
    -> ``(B, N, C)`` in qkv's dtype, rounded as the kernels round."""
    return flash_attention.attention_qkv_relpos_plain(qkv_raw, Rh, Rw, hw, scale, num_heads)


def attention_qkv_fused(qkv_raw, Rh, Rw, hw: Tuple[int, int], scale: float, num_heads: int):
    """JAX ``attention_qkv_fused``: the kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    global launches
    if not qkv_raw.is_cuda:
        return attention_qkv_fused_plain(qkv_raw, Rh, Rw, hw, scale, num_heads)
    H, W = hw
    B, N, C3 = qkv_raw.shape
    if hw != (fused_window_layer.WINDOW, fused_window_layer.WINDOW):
        return flash_attention.attention_qkv_relpos_cuda(qkv_raw, Rh, Rw, hw, scale, num_heads)
    out = fused_window_layer.window_attention_cuda(
        qkv_raw.reshape(B, H, W, C3), None, Rh, Rw, H, scale, num_heads, order="ijb",
        layout="windows")
    launches += 1
    return out.reshape(B, N, C3 // 3)
